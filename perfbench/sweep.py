"""Find an open-loop cell's knee: the highest rate with no growing backlog.

    python3 perfbench/sweep.py --workload users_fragmented_open \
        --rates 800,1000,1200 --seconds 8 --seed 7

One set-up (the arena built once, for the highest rate's requests), then
one window per rate, lowest first: the highest rate's requests, as many
as the rate asks for, at fresh uniform times. Prints one line per rate:
offered and completed per second, p50 and p95 latency from the due time,
and the mean latency of the window's first and last thirds of requests,
which part when a backlog grows.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    import numpy as np
    from perfbench import harness
    rates = sorted(float(r) for r in args.rates.split(","))
    spec = harness.load_spec(args.workload)
    spec["traffic"]["rate_per_s"] = rates[-1]
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    cell = harness.set_up(spec, args.seed, args.seconds, log=log)
    index = cell.built.index
    rng = np.random.default_rng(args.seed)
    full = cell.plan
    for rate in rates:
        n = int(round(rate * args.seconds))
        cell.plan = dataclasses.replace(
            full, times=np.sort(rng.random(n)) * args.seconds,
            users=full.users[:n])
        cell.built.index = index
        w = harness.serve(cell, args.seconds, False)
        end = w.t0 + args.seconds
        lat = [(d - u) * 1e3 for d, u in zip(w.done, w.due)]
        third = max(1, len(lat) // 3)
        print(json.dumps({
            "rate_per_s": rate,
            "completed_per_s": sum(d <= end for d in w.done) / args.seconds,
            "failed": w.failed,
            "p50_ms": harness.percentile(lat, 50),
            "p95_ms": harness.percentile(lat, 95),
            "first_third_mean_ms": statistics.fmean(lat[:third]),
            "last_third_mean_ms": statistics.fmean(lat[-third:])}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
