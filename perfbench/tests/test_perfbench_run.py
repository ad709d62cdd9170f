"""Whole runs at tiny sizes on the CPU, through the plain backend.

The rehearsal drives every cell end to end (set-up, window, check) and
reads the result line's keys; the fault cases break the timed path under
the harness and see `correct` turn false; the control reads above 0;
the import graph of a run holds no JAX and nothing of the JAX package.
Run from the repo root: ``python -m pytest perfbench/tests -q``; the
`gpu` case runs on the card.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import control, corpus, harness  # noqa: E402
from repro_torch.tenancy.tenants import MultiTenantIndex  # noqa: E402

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2 ** 31 + 11
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny(cell: str) -> dict:
    """The cell at a size the CPU runs in seconds: 8 users of 128 docs,
    or a 5000-row shared corpus, made in 1000-row chunks."""
    spec = harness.load_spec(cell)
    cfg, mix = spec["config"], spec["traffic"]
    if cfg["users"] > 1:
        cfg.update(users=8, docs_per_user=128)
    else:
        cfg.update(docs_per_user=5000)
    if "rate_per_s" in mix:
        mix["rate_per_s"] = 200
    if "clients" in mix:
        mix.update(clients=8, queries_per_client=8)
    spec["workload"]["check_sample"] = 64
    return spec


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(corpus, "CHUNK_ROWS", 1000)


def run(cell: str, traced: bool = False, seconds: float = 0.6) -> dict:
    return harness.run_cell(tiny(cell), SEED, seconds, traced, device="cpu",
                            backend="torch", log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal(cell):
    out = run(cell)
    assert list(out) == KEYS + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    want = {m["name"] for m in harness.load_spec(cell)["end_to_end"]}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["checks"]) == {"unanswered", "wrong_candidates",
                                  "wrong_ids", "wrong_scores"}
    assert all(c == {"value": 0, "limit": 0} for c in out["checks"].values())
    json.dumps(out)


def test_rehearsal_of_the_compacted_cell_kept_for_later(tmp_path):
    """`users_compacted_closed` has its files but no manifest entry yet
    (its host-paced runs spread too widely for a bound): under a manifest
    that adds it, it runs the Windowed path after `compact()` and is
    correct."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = "users_compacted_closed"
    bench["workloads"].append({"name": cell, "config": "wearable_users_d512",
                               "traffic": "users_closed_256", "chips": 1,
                               "why": "Windowed after compact()"})
    bench["end_to_end"].append({"name": "queries_per_s.host_paced",
                                "unit": "queries/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": [cell]})
    manifest = tmp_path / "BENCHMARK.json"
    manifest.write_text(json.dumps(bench))
    spec = harness.load_spec(cell, manifest)
    spec["config"].update(users=8, docs_per_user=128)
    spec["traffic"].update(clients=8, queries_per_client=8)
    spec["workload"]["check_sample"] = 64
    out = harness.run_cell(spec, SEED, 0.6, False, device="cpu",
                           backend="torch", log=lambda m: None)
    assert out["correct"] is True and out["attempted"] > 0
    assert set(out["metrics"]) == {"queries_per_s.host_paced", "setup_s"}


@pytest.mark.parametrize("cell", ["users_fragmented_open", "pubmed_closed"])
def test_traced_rehearsal(cell):
    out = run(cell, traced=True, seconds=1.0)
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    names = {m["name"] for m in harness.load_spec(cell)["per_layer"]}
    # The CPU has no device trace: only host-side readings appear.
    assert set(out["metrics"]) <= names
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def _patched(monkeypatch, fault):
    real = MultiTenantIndex.retrieve
    last = {}

    def retrieve(self, query_codes, tenant_ids):
        res = real(self, query_codes, tenant_ids)
        if query_codes.ndim != 2:
            return res
        return fault(res, last)
    monkeypatch.setattr(MultiTenantIndex, "retrieve", retrieve)


def _stale(res, last):
    """The step returns its state unchanged: the previous batch's."""
    prev = last.get(res.indices.shape)
    last[res.indices.shape] = res
    return prev if prev is not None else res


def _half(res, last):
    """Half the batch left out: its lanes take the other half's rows."""
    b = res.indices.shape[0]
    if b < 2:
        return res
    h = b // 2

    def fill(t):
        t = t.clone()
        t[h:2 * h] = t[:h]
        return t
    return dataclasses.replace(res, indices=fill(res.indices),
                               scores=fill(res.scores),
                               candidate_indices=fill(res.candidate_indices))


def _altered(res, last):
    """One answer altered where it is produced: lane 0's best score."""
    scores = res.scores.clone()
    scores[0, 0] += 1
    return dataclasses.replace(res, scores=scores)


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["state_unchanged", "half_batch", "answer"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _patched(monkeypatch, fault)
    out = run("users_fragmented_open")
    assert out["correct"] is False
    assert sum(c["value"] for c in out["checks"].values()) > 0


@pytest.mark.parametrize("cell", ["users_fragmented_open", "pubmed_closed"])
def test_control_fails_and_program_passes(cell):
    r = control.readings(tiny(cell), 5, 0.5, device="cpu", backend="torch")
    assert not any(r["program"].values())
    assert r["control"]["wrong_scores"] == r["checked"] > 0


def _traced_runs(root: Path, extra_metric: str | None = None):
    """A subprocess that makes traced tiny runs of two cells from the
    benchmark at `root`, with one more per-layer metric if given, and
    prints each result line and then the top-level names of its modules."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT / 'src')!r}]\n"
        "from perfbench import corpus, harness, control, sweep\n"
        "corpus.CHUNK_ROWS = 1000\n"
        "from perfbench.tests.test_perfbench_run import tiny\n"
        "for cell in ['users_fragmented_open', 'pubmed_closed']:\n"
        "    spec = tiny(cell)\n"
        f"    if {extra_metric!r}:\n"
        f"        spec['per_layer'].append({{'name': {extra_metric!r},\n"
        "                                  'unit': '%'})\n"
        "    out = harness.run_cell(spec, 3, 0.3, True, device='cpu',\n"
        "                           backend='torch', log=lambda m: None)\n"
        "    print(harness.result_line(out))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=root)


def test_import_graph_holds_no_jax():
    out = _traced_runs(ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert all("correct" in json.loads(line) for line in lines[-3:-1])
    top = set(json.loads(lines[-1]))
    assert "repro_torch" in top and "perfbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_a_metric_that_loads_the_jax_package_stops_the_result(tmp_path):
    """A per-layer metric file is loaded after the window; one that
    imports the JAX package leaves no result line."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    (tmp_path / "perfbench" / "metrics" / "leaky.py").write_text(
        "import repro  # noqa: F401\n\n\ndef read(ctx):\n    return 1.0\n")
    out = _traced_runs(tmp_path, "leaky.open")
    assert out.returncode != 0
    assert "modules that must not load: repro" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "users_fragmented_open", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_control_on_the_card():
    """The control at a size a test run holds, on the card: 256 users of
    2048 docs and a 2^21-row shared corpus, three seeds each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in ("users_fragmented_open", "pubmed_closed"):
        spec = harness.load_spec(cell)
        if spec["config"]["users"] > 1:
            spec["config"]["users"] = 256
        else:
            spec["config"]["docs_per_user"] = 1 << 21
        for seed in (1, 2, 3):
            r = control.readings(spec, seed, 2.0)
            assert r["failed"] == 0 and not any(r["program"].values())
            assert r["control"]["wrong_scores"] > 0
