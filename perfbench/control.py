"""Readings of the output check: the program's and the control's.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 5

For each seed, in one process: the cell set up and served for a short
window at its own load, then the check's sample of requests held against
the reference twice: once as the program answered them, once as the
control answers them, the reference itself computed with INT4 codes in
place of the INT8 ones the configuration states (stage 2 and the norms on
the MSB nibbles). Prints one JSON line per seed: each compared count for
the program and for the control. A sound program reads 0 on every count;
the control must read above 0 on at least one.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def readings(spec: dict, seed: int, seconds: float, *, device=None,
             backend: str = "cuda", log=None) -> dict:
    from perfbench import harness
    log = log or (lambda m: None)
    cell = harness.set_up(spec, seed, seconds, device=device,
                          backend=backend, log=log)
    w = harness.serve(cell, seconds, False)
    return {"seed": seed, "requests": len(w.due),
            "checked": len(w.chosen), "failed": w.failed,
            "program": harness.check(cell.built, w.chosen, spec["config"]),
            "control": harness.check(cell.built, w.chosen, spec["config"],
                                     control_bits=4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    from perfbench import harness
    spec = harness.load_spec(args.workload)
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(spec, seed, args.seconds, log=log)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
