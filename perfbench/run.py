"""Run one cell of the port's benchmark on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`), `device`, with `--trace 1` `breakdown`, and last `checks`:
each number the output check compared, beside its limit. The same
numbers are the last lines of standard error. Exits non-zero, printing no
result, where CUDA has fewer cards than the cell asks for, or where JAX or
the JAX package has loaded by the time the result would print.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# The script's own folder would shadow standard modules by its files'
# names; the checkout's root and its `src` take its place.
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    from perfbench import harness
    spec = harness.load_spec(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < spec["chips"]):
        log(f"{args.workload} needs {spec['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " found")
        return 2
    torch.set_num_threads(2)
    out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           log=log)
    print(harness.result_line(out), flush=True)
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
