"""Synthetic retrieval corpora with planted relevance (numpy only).

Port of `repro.data.synthetic.retrieval_corpus`: the same seed gives the
same arrays, bit for bit. Documents are random unit vectors; each query is
a noisy copy of its gold document.
"""
from __future__ import annotations

import numpy as np


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
