"""Synthetic data (port of `repro.data.synthetic`): the same seed gives the
same numpy arrays, bit for bit.

  * LM token streams with LEARNABLE structure (a mixture of affine
    next-token rules), so a falling train loss means something.
  * Retrieval corpora with PLANTED relevance: documents are random unit
    vectors; each query is a noisy copy of its gold document.

Batches are host numpy; `shard_batch` puts one on a device or a slot
mesh's first slot, or, given shardings (`batch_shardings` over a
`RankMesh`), keeps this rank's block of it on this rank's device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch._device import resolve_device, upload
from repro_torch.distributed.sharding import Mesh, NamedSharding, block_slices


@dataclasses.dataclass
class LMTaskConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    num_rules: int = 7
    noise: float = 0.05
    seed: int = 0


def lm_batches(cfg: LMTaskConfig) -> Iterator[dict]:
    """Deterministic stream of {tokens, labels} (B, S) int32 numpy batches;
    labels are the tokens shifted by one."""
    rng = np.random.default_rng(cfg.seed)
    v = cfg.vocab_size
    a = rng.integers(1, v, size=cfg.num_rules)
    c = rng.integers(0, v, size=cfg.num_rules)
    while True:
        rule = rng.integers(0, cfg.num_rules, size=(cfg.batch_size, 1))
        toks = np.empty((cfg.batch_size, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=cfg.batch_size)
        for t in range(1, cfg.seq_len + 1):
            nxt = (toks[:, t - 1] * a[rule[:, 0]] + c[rule[:, 0]]) % v
            flip = rng.random(cfg.batch_size) < cfg.noise
            nxt = np.where(flip, rng.integers(0, v, cfg.batch_size), nxt)
            toks[:, t] = nxt
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


def shard_batch(batch: dict, target) -> dict:
    """A host numpy batch as tensors on `target`: a device (the CUDA device
    when None), a `Mesh`, whose first slot takes it, or a NamedSharding
    (or a dict of them, one per key), of which this rank keeps its block
    (`batch_spec`: rows split over the batch axes) on its device."""
    if isinstance(target, (dict, NamedSharding)):
        def put(k, v):
            s = target[k] if isinstance(target, dict) else target
            v = np.asarray(v)
            return upload(v[block_slices(v.shape, s)], s.mesh.device)
        return {k: put(k, v) for k, v in batch.items()}
    dev = (target.slots()[0] if isinstance(target, Mesh)
           else resolve_device(target))
    return {k: upload(v, dev) for k, v in batch.items()}


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def retrieval_corpus(num_docs: int, dim: int = 512, num_queries: int = 64,
                     noise: float = 0.1, seed: int = 0,
                     cluster_size: int = 1, cluster_spread: float = 0.2):
    """Planted-relevance corpus: returns (docs (N, D), queries (Q, D),
    gold (Q,) int), unit-norm float32.

    `noise` is the relative magnitude of the query perturbation.
    cluster_size > 1 packs documents into clusters of near-duplicates
    (spread `cluster_spread` > noise), the regime where quantization
    precision decides top-1."""
    rng = np.random.default_rng(seed)
    if cluster_size > 1:
        n_centers = (num_docs + cluster_size - 1) // cluster_size
        centers = _unit(rng.normal(size=(n_centers, dim)))
        reps = np.repeat(centers, cluster_size, axis=0)[:num_docs]
        docs = _unit(reps + cluster_spread
                     * _unit(rng.normal(size=(num_docs, dim))))
    else:
        docs = _unit(rng.normal(size=(num_docs, dim)))
    docs = docs.astype(np.float32)
    gold = rng.integers(0, num_docs, size=num_queries)
    perturb = _unit(rng.normal(size=(num_queries, dim)))
    queries = _unit(docs[gold] + noise * perturb).astype(np.float32)
    return docs, queries, gold
