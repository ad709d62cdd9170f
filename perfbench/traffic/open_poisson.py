"""Open loop: independent users' requests at a fixed Poisson rate.

A window of T seconds at rate R holds n = round(R T) arrivals at n sorted
uniform times in [0, T): a Poisson process given its count, so every seed
offers the same work. Users are drawn Zipf(s) over the config's users:
the count of each popularity rank is fixed (R T p_r, rounded by largest
remainders), and the seed picks which user holds each rank, the order of
the requests and each request's document. A request is timed from when
it was due, so a stall delays every later one.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from perfbench.corpus import sub_seed

DRAIN_S = 60.0


def zipf_counts(n: int, ranks: int, s: float) -> np.ndarray:
    """n draws spread over `ranks` ranks as Zipf(s), by largest
    remainders: the same counts for every seed."""
    p = 1.0 / np.arange(1, ranks + 1, dtype=np.float64) ** s
    want = n * p / p.sum()
    counts = np.floor(want).astype(np.int64)
    extra = np.argsort(-(want - counts), kind="stable")[:n - counts.sum()]
    counts[extra] += 1
    return counts


@dataclasses.dataclass
class Plan:
    times: np.ndarray   # (n,) seconds from the window's start
    users: np.ndarray   # (n,) tenant of each request


def schedule(mix: dict, seconds: float, cfg: dict, seed: int):
    """(plan, (users, docs)): one query per request, in request order."""
    rng = np.random.default_rng(sub_seed(seed, 3))
    users = cfg["users"]
    n = int(round(mix["rate_per_s"] * seconds))
    times = np.sort(rng.random(n)) * seconds
    ranks = np.repeat(np.arange(users), zipf_counts(n, users, mix["zipf_s"]))
    who = rng.permutation(users)[rng.permutation(ranks)]
    docs = rng.integers(0, cfg["docs_per_user"], size=n)
    return Plan(times, who), (who, docs)


def drive(win, plan: Plan, seconds: float) -> None:
    """Submit each request when due; poll in between."""
    t0 = win.start()
    due = t0 + plan.times
    n, i = len(due), 0
    while True:
        now = time.monotonic()
        while i < n and due[i] <= now:
            win.submit(int(plan.users[i]), i, float(due[i]))
            i += 1
        win.poll()
        win.take()
        if i == n and not win.outstanding:
            return
        if now > t0 + seconds + DRAIN_S:
            return
