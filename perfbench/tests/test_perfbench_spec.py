"""The manifest and the files it names: shape, names, budget.

Run from the repo root: ``python -m pytest perfbench/tests -q``.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_text_ok(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    assert len(json.dumps(BENCH)) <= 64 * 1024
    # A full check at 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    # 2 x 90 s a cell to compile, 1200 s spare, within 43200 s.
    assert ((2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text_ok(c["source"]) and _text_ok(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text_ok(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(("cell", w["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= ({"bound"} if m in BENCH["end_to_end"]
                    else {"layer", "moves"})
        assert set(m) <= allowed
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(("metric", m["name"]))
    for _, n in names:
        assert NAME.match(n), n
    assert len(names) == len(set(names))
    assert len({n for k, n in names if k == "metric"}) == len(
        BENCH["end_to_end"]) + len(BENCH["per_layer"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:
        got = [m["name"] for m in e2e.values()
               if cell in m.get("workloads", cells)]
        assert "setup_s" in got and len(got) >= 2


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    layers_seen = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and _text_ok(m["layer"])
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
        layers_seen.setdefault(m["layer"], []).append(m["name"])
        assert (HERE / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
    for cell in cells:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_name_known_parts(cell):
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    config = {c["name"]: c for c in BENCH["configs"]}[entry["config"]]
    assert config["file"].startswith("perfbench/configs/")
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"]
    assert cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"]
    for key in ("users", "docs_per_user", "dim", "k", "candidates",
                "metric", "query_noise", "assumed"):
        assert key in cfg
    traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    assert (HERE / "traffic" / f"{traffic['kind']}.py").is_file()
    wl = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    assert set(wl) == {"builder", "build", "runtime", "check_sample"}
    assert (HERE / "builders" / f"{wl['builder']}.py").is_file()


def test_files_under_paths_are_named_from_name_characters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
