"""Closed loop: clients that each wait for their answer, then ask again.

`clients` clients each serve one user, picked by `client_users`:
"distinct" (every client another user, drawn without replacement) or
"uniform" (drawn with replacement; a shared corpus has one user). Each
client holds its own `queries_per_client` queries, each a seeded document
of its user, and sends them in turn, from the first again once through:
the program keeps no result cache, so a repeated query costs what a new
one does. A request is timed from its submit. Clients stop submitting
when the window closes; what is in flight then is waited for.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from perfbench.corpus import sub_seed

DRAIN_S = 60.0


@dataclasses.dataclass
class Plan:
    client_users: np.ndarray   # (clients,) the user each client serves
    per_client: int            # queries each client holds


def schedule(mix: dict, seconds: float, cfg: dict, seed: int):
    """(plan, (users, docs)): client c's j-th query is row c * P + j."""
    rng = np.random.default_rng(sub_seed(seed, 3))
    clients, per = mix["clients"], mix["queries_per_client"]
    users = cfg["users"]
    if mix["client_users"] == "distinct":
        who = rng.choice(users, size=clients, replace=False)
    elif mix["client_users"] == "uniform":
        who = rng.integers(0, users, size=clients)
    else:
        raise ValueError(f"client_users {mix['client_users']!r}")
    docs = rng.integers(0, cfg["docs_per_user"], size=clients * per)
    return Plan(who, per), (np.repeat(who, per), docs)


def drive(win, plan: Plan, seconds: float) -> None:
    t0 = win.start()
    end = t0 + seconds
    sent = np.zeros(len(plan.client_users), np.int64)

    def send(c: int) -> None:
        row = c * plan.per_client + int(sent[c]) % plan.per_client
        sent[c] += 1
        win.submit(int(plan.client_users[c]), row, time.monotonic(), c)

    for c in range(len(plan.client_users)):
        send(c)
    while win.outstanding:
        win.poll()
        ready = win.take()
        while ready:
            req = ready.pop()
            if req.done < end:
                send(req.client)
            ready += win.take()
        if time.monotonic() > end + DRAIN_S:
            return
