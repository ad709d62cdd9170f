"""The yardstick's arithmetic and the reference against brute force.

Run from the repo root: ``python -m pytest perfbench/tests -q``.
"""
from __future__ import annotations

import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, yardstick  # noqa: E402
from perfbench.reference import retrieval  # noqa: E402
from perfbench.traffic import closed_clients, open_poisson  # noqa: E402


def _brute(q, x, slots, k, c, metric, bits=8):
    """Every query by Python integers: stage-1 key, sorted candidates,
    exact rerank."""
    ids, scores, cands = [], [], []
    xm, qm = x >> 4, q >> 4
    xs, qs = (x, q) if bits == 8 else (xm, qm)
    norms = [int((row.astype(np.int64) ** 2).sum()) for row in xs]
    for qi in range(len(q)):
        s1 = [int(np.dot(qm[qi].astype(np.int64), r.astype(np.int64)))
              for r in xm]
        if metric == "cosine":
            key = (torch.tensor(s1, dtype=torch.float32)
                   * torch.rsqrt(torch.tensor(norms, dtype=torch.float32)
                                 .clamp(min=1.0)))
            key = [float(v) if n > 0 else 0.0 for v, n in zip(key, norms)]
        else:
            key = s1
        order = sorted(range(len(x)), key=lambda j: (-key[j], slots[j]))[:c]
        e = [int(np.dot(qs[qi].astype(np.int64), xs[j].astype(np.int64)))
             for j in order]
        n = [norms[j] for j in order]
        if metric == "cosine":
            val = [Fraction(v * abs(v), m) if m else Fraction(0)
                   for v, m in zip(e, n)]
            rank = sorted(range(len(order)), key=lambda i: (-val[i], i))
        else:
            rank = sorted(range(len(order)), key=lambda i: (-e[i], i))
        rank = rank[:k]
        ids.append([slots[order[i]] for i in rank])
        scores.append([e[i] for i in rank])
        cands.append([slots[j] for j in order])
    return np.array(ids), np.array(scores), np.array(cands)


@pytest.mark.parametrize("metric", ["cosine", "mips"])
@pytest.mark.parametrize("bits", [8, 4])
def test_reference_equals_brute_force(metric, bits):
    rng = np.random.default_rng(5)
    # Few distinct values, so stage-1 keys tie often.
    x = rng.integers(-40, 40, size=(70, 16)).astype(np.int8)
    x[10] = x[3]
    q = rng.integers(-128, 128, size=(6, 16)).astype(np.int8)
    slots = rng.permutation(1000)[:70]
    want = _brute(q, x, slots, 5, 12, metric, bits)
    blocks = [(torch.from_numpy(x[a:a + 25]),
               torch.from_numpy(slots[a:a + 25].astype(np.int64)))
              for a in range(0, 70, 25)]
    got = retrieval.retrieve(torch.from_numpy(q), blocks, k=5, candidates=12,
                             metric=metric, bits=bits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_reference_pads_a_short_tenant():
    x = np.arange(-12, 12, dtype=np.int8).reshape(3, 8)
    q = np.full((1, 8), 64, np.int8)
    ids, scores, cands = retrieval.retrieve(
        torch.from_numpy(q), [(torch.from_numpy(x), torch.arange(3))],
        k=5, candidates=4, metric="mips")
    assert list(cands[0]) == [2, 1, 0, -1]
    assert list(ids[0][3:]) == [-1, -1] and list(scores[0][3:]) == [0, 0]


def test_needed_bytes_hand_worked():
    # 3 distinct tenants of 2048 rows at D 512, 4 lanes, k 5, C 50:
    # 3*2048*256 + 4*50*516 + 4*512 + 4*60*4 = 1,572,864 + 103,200 +
    # 2,048 + 960.
    assert yardstick.batch_bytes(3 * 2048, 4, 512, 5, 50) == 1_679_072
    # MACs: 4 lanes x 2048 rows x 512 + 4 x 50 x 512.
    assert yardstick.batch_macs(4 * 2048, 4, 512, 50) == 4_296_704
    t = yardstick.batch_least_seconds([1, 2, 2, 3], lambda u: 2048, 512, 5,
                                      50)
    assert t == pytest.approx(1_679_072 / 3.35e12)
    # The shared corpus: one tenant of 23.9M rows at D 768, 32 lanes:
    # 9.1776 GB of MSB rows, bytes-bound at 2.74 ms.
    t = yardstick.batch_least_seconds([0] * 32, lambda u: 23_900_000, 768,
                                      32, 320)
    want = (23_900_000 * 384 + 32 * 320 * 772 + 32 * 768
            + 32 * 384 * 4) / 3.35e12
    assert t == pytest.approx(want)
    assert 2.7e-3 < t < 2.8e-3


def test_open_loop_offers_the_same_work_on_every_seed():
    cfg = {"users": 64, "docs_per_user": 16}
    mix = {"rate_per_s": 250, "zipf_s": 0.99}
    plans = [open_poisson.schedule(mix, 4.0, cfg, s)[0]
             for s in (1, 2, 2 ** 40 + 3)]
    counts = [sorted(np.bincount(p.users, minlength=64)) for p in plans]
    assert all(len(p.times) == 1000 for p in plans)
    assert counts[0] == counts[1] == counts[2]
    assert not np.array_equal(plans[0].users, plans[1].users)
    assert all(np.all(np.diff(p.times) >= 0) and p.times[-1] < 4.0
               for p in plans)
    a = open_poisson.schedule(mix, 4.0, cfg, 2)[0]
    np.testing.assert_array_equal(a.users, plans[1].users)


def test_closed_clients_distinct_users():
    cfg = {"users": 300, "docs_per_user": 16}
    mix = {"clients": 256, "client_users": "distinct",
           "queries_per_client": 4}
    plan, (users, docs) = closed_clients.schedule(mix, 1.0, cfg, 9)
    assert len(set(plan.client_users.tolist())) == 256
    assert users.shape == docs.shape == (1024,)
    assert np.all(users.reshape(256, 4) == plan.client_users[:, None])


def _sample(n: int, count: int, seed: int) -> list[int]:
    win = harness.Window(None, None, None, None, n, seed)
    for i in range(count):
        win._choose(i)
    return sorted(win.kept)


def test_the_check_sample_is_seeded_and_uniform_over_the_window():
    assert _sample(8, 5, 3) == [0, 1, 2, 3, 4]
    a = _sample(64, 10_000, 2 ** 40 + 5)
    assert len(a) == 64 and a == _sample(64, 10_000, 2 ** 40 + 5)
    assert a != _sample(64, 10_000, 6) and 0 <= a[0] and a[-1] < 10_000
    # Every request of a stream of 10 is chosen, two at a time, about
    # one time in five, the first as often as the last.
    hits = np.zeros(10)
    for seed in range(4000):
        hits[_sample(2, 10, seed)] += 1
    assert np.all(np.abs(hits / 4000 - 0.2) < 0.03)
