"""Quickstart: the paper's hierarchical retrieval, batch-native (the port of
examples/quickstart.py).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card the batched two-stage launch runs the tensor-core plane scan
and the exact rescore by id; the cluster-pruned cascade scans the
centroids on the plane kernel, gathers the probed blocks by TMA and
rescores by id. The single-query INT8 and INT4 baselines are plain
PyTorch, as in the reference.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import (BitPlanarDB, RetrievalConfig, RetrievalEngine,
                              build_database, clustering, energy,
                              exact_retrieve, int4_retrieve, quantize_int8)
from repro_torch.core.retrieval import cluster_pruned_retrieve
from repro_torch.data import retrieval_corpus


def run(device: torch.device) -> dict:
    """Runs the example on `device` and prints its log. Returns the batched
    launch's and the cascade's results ({"batched", "pruned"})."""
    # --- offline: INT8-quantize + nibble-planar pack the corpus ---
    docs, queries, gold = retrieval_corpus(num_docs=5000, dim=512,
                                           num_queries=16, noise=0.15,
                                           cluster_size=16,
                                           cluster_spread=0.15, seed=0)
    qdb = build_database(docs, device=device)         # INT8 codes + norms
    db = BitPlanarDB.from_quantized(qdb)              # MSB/LSB nibble planes
    print(f"corpus: {db.num_docs} docs x {db.dim} dims "
          f"({energy.db_bytes(db.num_docs)/2**20:.1f} MB INT8)")

    # --- online: ONE batched two-stage launch for the whole query batch ---
    cfg = RetrievalConfig(k=5, metric="cosine")
    engine = RetrievalEngine(cfg, device)
    q_codes, _ = quantize_int8(torch.from_numpy(queries).to(device),
                               per_vector=True)
    batched = engine.retrieve(q_codes, db)            # (B, k) indices
    plan = engine.plan_for(db, batch=q_codes.shape[0])
    print(f"batched launch: stage-1 streams {plan.stage1_bytes:,} bytes "
          "once per batch (a per-query loop would stream "
          f"{plan.stage1_bytes_vmapped:,})")

    top1 = batched.indices[:, 0].cpu().numpy()
    n = queries.shape[0]
    hits = {"hierarchical": int(np.sum(top1 == gold)), "int8": 0, "int4": 0}

    # single-query baselines (each lane of the batch == one of these calls)
    for i in range(n):
        q = q_codes[i]
        hits["int8"] += int(int(exact_retrieve(q, qdb, cfg).indices[0])
                            == gold[i])
        hits["int4"] += int(int(int4_retrieve(q, db, cfg).indices[0])
                            == gold[i])
    print(f"P@1  hierarchical={hits['hierarchical']/n:.2f}  "
          f"int8={hits['int8']/n:.2f}  int4={hits['int4']/n:.2f}")

    # --- beyond the paper: the cluster-pruned cascade ---
    cents, labels = clustering.kmeans_int8(qdb.values.cpu().numpy(), 64,
                                           iters=4, seed=0)
    order = clustering.cluster_grouped_order(labels)
    cdb = BitPlanarDB.from_quantized(build_database(docs[order],
                                                    device=device))
    labels = labels[order]
    codebook = clustering.ClusterCodebook.from_codes(cents, device=device)
    table = clustering.block_table(labels, 64, block_rows=64)
    pruned = cluster_pruned_retrieve(q_codes, cdb, codebook, table, labels,
                                     cfg, nprobe=8, block_rows=64,
                                     device=device)
    inv = np.empty_like(order)            # old row id -> grouped row id
    inv[order] = np.arange(len(order))
    hit = int(np.sum(pruned.indices[:, 0].cpu().numpy() == inv[gold]))
    print(f"cascade (K=64, nprobe=8): P@1={hit/n:.2f}, stage-1 scans "
          f"{8 * table.shape[1] * 64}/{db.num_docs} rows per query")

    # --- the paper's energy ledger for this corpus ---
    for name, fn in (("hierarchical", energy.cost_hierarchical),
                     ("pure INT8", energy.cost_int8),
                     ("pure INT4", energy.cost_int4)):
        cb = fn(db.num_docs)
        print(f"{name:>13}: {cb.total_uj:8.2f} uJ/query  "
              f"(DRAM {100*cb.proportions()['DRAM']:.1f}%)")
    return {"batched": batched, "pruned": pruned}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    run(resolve_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
