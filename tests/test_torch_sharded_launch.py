"""The port's launchers with a mesh and with shards, on the CPU:
`repro_torch.launch.serve --data 2 --model 2` and
`repro_torch.launch.serve_tenants --shards 3 --fail-at 5`, the latter
against the reference launcher under the same seed. Its sharded phase
draws only from the numpy generator, so its `[shard ]` lines equal the
reference's apart from the wall time, and the main trace's `[trace]`
counts equal too (the models' weights differ: the port draws them from
torch generators).
"""
import pytest

torch = pytest.importorskip("torch")

import re

from repro.launch import serve_tenants as jserve_tenants
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import serve_tenants
from repro_torch.obs import parse_prometheus

TENANT_ARGS = ["--tenants", "8", "--capacity", "1024", "--steps", "40",
               "--shards", "3", "--fail-at", "5"]


def _lines(text, tag):
    return [line for line in text.splitlines() if line.startswith(tag)]


def _no_wall(line):
    return re.sub(r"requests in [0-9.]+s", "requests in <wall>", line)


def test_serve_launcher_with_a_mesh_on_the_cpu(capsys):
    rc = launch_serve.main(["--device", "cpu", "--requests", "4",
                            "--num-docs", "64", "--max-new", "4",
                            "--data", "2", "--model", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "mesh={'data': 2, 'model': 2}" in out
    assert "top-1 hit 4/4" in out


def test_serve_tenants_sharded_phase_matches_reference(capsys, tmp_path):
    metrics, trace = tmp_path / "m.prom", tmp_path / "t.json"
    assert serve_tenants.main(TENANT_ARGS + [
        "--device", "cpu", "--metrics-out", str(metrics),
        "--trace-out", str(trace)]) == 0
    got = capsys.readouterr().out
    assert jserve_tenants.main(TENANT_ARGS) == 0
    want = capsys.readouterr().out
    shard = _lines(got, "[shard ]")
    assert len(shard) == 3
    assert [_no_wall(x) for x in shard] == [
        _no_wall(x) for x in _lines(want, "[shard ]")]
    assert "parity vs single shard: True" in got
    assert "exactly-once: True" in got
    assert _lines(got, "[trace]") == _lines(want, "[trace]")
    assert "cross-tenant leaks 0" in got
    assert _lines(got, "[decode]") == _lines(want, "[decode]")
    assert parse_prometheus(metrics.read_text())
    assert trace.stat().st_size > 0


def test_serve_tenants_refuses_fail_at_without_shards():
    with pytest.raises(SystemExit) as e:
        serve_tenants.main(["--device", "cpu", "--fail-at", "3",
                            "--shards", "1"])
    assert e.value.code == 2
