"""Multi-user wearable agent: per-user corpora, one shared arena (the port
of examples/multi_user_agent.py).

Three users each carry a personal medical-record corpus. Records stream
in ONLINE (no offline index build, no rebuild on update), a mixed batch
of all three users' questions runs as one segment-masked retrieval
launch, and each user's answer is grounded ONLY in their own records —
user A can never retrieve user B's data even though both live in the
same nibble-planar arena. Every property the log states is checked, and
a failed check raises.

    PYTHONPATH=src python -m repro_torch.examples.multi_user_agent [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import RetrievalConfig, quantize_int8
from repro_torch.examples import agent_models
from repro_torch.serve import (MultiTenantRAGPipeline, RuntimeConfig,
                               ServingRuntime)

USERS = ["alice", "bob", "carol"]


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def run(ecfg, eparams, gen_api, gen_params, device: torch.device) -> dict:
    """The demo over the given models. Returns the pipeline and the mixed
    batch's answer: {"pipe", "tokens", "ids", "ledger"}."""
    rng = np.random.default_rng(0)
    vocab = gen_api.cfg.vocab_size
    pipe = MultiTenantRAGPipeline.create(
        ecfg, eparams, gen_api, gen_params, capacity=256, doc_len=12,
        retrieval_cfg=RetrievalConfig(k=2, metric="cosine"), device=device)

    # --- online ingestion: each user's personal records stream in --------
    records = {}
    for uid, name in enumerate(USERS):
        toks = rng.integers(0, vocab, (24, 12)).astype(np.int32)
        slots = pipe.ingest(uid, toks)
        records[uid] = (slots, toks)
        print(f"[{name:5}] ingested {len(slots)} records -> slots "
              f"[{slots[0]}..{slots[-1]}] (no rebuild)")

    # --- one mixed batch: every user asks about their OWN record #7 ------
    tids = np.arange(len(USERS), dtype=np.int32)
    queries = np.stack([records[u][1][7] for u in tids])
    out, ids, ledger = pipe.answer(tids, queries, max_new=8)
    owner = pipe.index.arena.owner.cpu().numpy()
    for uid, name in enumerate(USERS):
        got = ids[uid][ids[uid] >= 0]
        owners = set(int(owner[s]) for s in got)
        print(f"[{name:5}] retrieved slots {[int(s) for s in got]} "
              f"(owners {owners or '-'}; expected slot "
              f"{records[uid][0][7]}) -> {out.shape[1]} answer tokens")
        _check(owners <= {uid}, "cross-user leak!")
        _check(int(got[0]) == int(records[uid][0][7]),
               f"{name}'s record #7 is not the top hit")
    print(f"[energy] {ledger.total_uj:.2f} uJ/query "
          f"(DRAM {100 * ledger.proportions()['DRAM']:.1f}%)")

    # --- a record arrives AFTER the index exists: visible immediately ----
    new_rec = rng.integers(0, vocab, (1, 12)).astype(np.int32)
    (new_slot,) = pipe.ingest(0, new_rec)
    res, _ = pipe.retrieve(np.asarray([0], np.int32), new_rec)
    _check(int(res.indices[0, 0]) == int(new_slot),
           "a new record is not retrievable at once")
    print(f"[alice] new record -> slot {new_slot}, retrievable immediately "
          f"(rebuilds: {pipe.index.arena.stats.rebuilds})")

    # --- delete = tombstone; compaction reclaims and preserves results ---
    pipe.delete(0, [int(new_slot)])
    res, _ = pipe.retrieve(np.asarray([0], np.int32), new_rec)
    _check(int(new_slot) not in res.indices.cpu().numpy(),
           "a deleted record was retrieved")
    pipe.compact()
    res, _ = pipe.retrieve(np.asarray([0], np.int32), records[0][1][7][None])
    top = int(res.indices[0, 0])
    _check(np.array_equal(pipe.doc_tokens[top], records[0][1][7]),
           "compaction changed a result")
    print("[alice] deleted record tombstoned; after compaction "
          f"({pipe.index.num_live} live rows) results still correct")

    # --- the serving runtime: deadline-batched admission with futures ----
    # A full batch launches immediately, a partial one when its oldest
    # deadline arrives.
    rt = ServingRuntime(pipe.index,
                        RuntimeConfig(max_batch=len(USERS), max_wait=0.010))
    handles = []
    for uid in range(len(USERS)):
        q_emb = pipe._embed(records[uid][1][3][None])
        q_codes, _ = quantize_int8(q_emb, per_vector=True)
        handles.append(rt.submit(uid, q_codes[0].cpu().numpy(), now=0.0))
    # The full batch DISPATCHED at once; with async_depth=2 (the default)
    # it may still be in flight: result() blocks until it has landed.
    _check(rt.launches == 1, "a full batch did not launch at once")
    for uid, h in enumerate(handles):
        got = h.result().indices.cpu().numpy()
        _check(int(got[0]) == int(pipe.index.table.slots(uid)[3]),
               f"{USERS[uid]}'s runtime answer is not record #3")
    _check(all(h.done() for h in handles), "a handle is unresolved")
    print(f"[serve ] {len(handles)} users answered in {rt.launches} "
          f"deadline-batched launch(es); a lone request launches after "
          f"{1e3 * rt.cfg.max_wait:.0f} ms instead of waiting forever")
    lone = rt.submit(0, q_codes[0].cpu().numpy(), now=0.0)
    _check(rt.poll(now=0.005) == [], "a young partial batch launched")
    _check(rt.poll(now=0.010) == [lone],
           "the deadline did not force the launch")
    return {"pipe": pipe, "tokens": out.cpu().numpy(), "ids": ids,
            "ledger": ledger}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run(*agent_models(dev), device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
