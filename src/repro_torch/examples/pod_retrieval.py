"""Pod-scale sharded retrieval (the port of examples/pod_retrieval.py): the
corpus lives row-sharded over the slots of a (data 4, model 2) mesh; one
query batch runs the two-level top-k TOURNAMENT (local stage-1 -> O(k *
slots) proposal gather -> owner-only stage-2 -> replicated rerank).

    PYTHONPATH=src python -m repro_torch.examples.pod_retrieval [--device cpu]

The reference forces 8 XLA host devices; here the 8 slots are dealt over
the visible CUDA devices (or the named device), so on one card they are
8 row blocks on that card, each scanned by its own launch of the
tensor-core plane kernel and rescored by id.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (BitPlanarDB, RetrievalConfig, RetrievalEngine,
                              build_database, quantize_int8)
from repro_torch.core.index import ShardedIndex
from repro_torch.data import retrieval_corpus
from repro_torch.distributed import Mesh
from repro_torch.launch.mesh import make_test_mesh


def run(mesh: Mesh) -> dict:
    """Runs the example over `mesh`'s slots and prints its log. Returns the
    single-host engine's and the tournament's results ({"local",
    "tournament"})."""
    dev = mesh.slots()[0]
    print(f"mesh: {mesh.shape} = {mesh.size} shard slots over "
          f"{len(set(mesh.slots()))} device(s)")

    docs, queries, gold = retrieval_corpus(num_docs=20000, dim=512,
                                           num_queries=8, noise=0.12, seed=1)
    t0 = time.time()
    index = ShardedIndex.build(torch.from_numpy(docs), mesh)
    print(f"sharded {index.n_global} docs over {mesh.size} shards "
          f"in {time.time()-t0:.1f}s "
          f"({index.db[0].num_docs} rows/shard)")

    cfg = RetrievalConfig(k=3, metric="cosine")
    qc, _ = quantize_int8(torch.from_numpy(queries).to(dev), per_vector=True)

    # single-host reference: the batch-native RetrievalEngine (one launch,
    # doc plane streamed once for the whole batch) — the same engine core
    # each shard runs locally inside the tournament below
    engine = RetrievalEngine(cfg, dev)
    local_db = BitPlanarDB.from_quantized(build_database(docs, device=dev))
    local = engine.retrieve(qc, local_db)
    plan = engine.plan_for(local_db, batch=qc.shape[0])
    print("single-host batched engine: P@1 "
          f"{int(np.sum(local.indices[:, 0].cpu().numpy() == gold))}/8, "
          f"stage-1 {plan.stage1_bytes:,} B once per batch "
          f"(per-query loop: {plan.stage1_bytes_vmapped:,} B)")

    retrieve = index.retrieve_fn(cfg)
    res = retrieve(qc)                       # batched tournament
    ids = res.indices.cpu().numpy()
    hits = int(np.sum(ids[:, 0] == gold))
    print(f"tournament P@1: {hits}/8 "
          "(cross-shard traffic per query: "
          f"{50 * mesh.size * 8} B of proposals — independent of "
          "corpus size)")
    for i in range(3):
        print(f"  q{i}: top-3 {ids[i].tolist()} (gold {gold[i]})")
    return {"local": local, "tournament": res}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: every CUDA device)")
    args = ap.parse_args(argv)
    run(make_test_mesh(data=4, model=2, device=args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
