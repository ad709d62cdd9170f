"""Many users' corpora in one arena, ingested in interleaved rounds.

Every user owns `docs_per_user` seeded documents. Round r ingests each
user's r-th share of them, user by user, so after two rounds every user
holds two slot runs: the arena of a live server between compactions, on
which `MultiTenantIndex` takes the Masked full-arena scan. With
`compact`, `MultiTenantIndex.compact()` runs after the last round and
every user is one run: the Windowed policy.

`slots` states where each document lands, from the arena's contract and
not from the program: inserts take the next free slots in order, and
compaction regroups live rows by ascending tenant id, each tenant's rows
in their insertion order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.corpus import Corpus, make_queries


def slots(cfg: dict, build: dict, user: int) -> np.ndarray:
    """The arena slot of each of `user`'s documents, in document order."""
    users, docs, rounds = cfg["users"], cfg["docs_per_user"], build["rounds"]
    j = np.arange(docs, dtype=np.int64)
    if build["compact"]:
        return user * docs + j
    share = docs // rounds
    return (j // share) * users * share + user * share + j % share


@dataclasses.dataclass
class Built:
    cfg: dict
    build: dict
    corpus: Corpus
    index: object
    queries: np.ndarray

    def rows_of(self, user: int) -> int:
        return self.cfg["docs_per_user"]

    def reference_blocks(self, users):
        """(user, [(codes, slots)]) for each user, every user's documents
        made again from the seed in one pass over the chunks that hold
        them."""
        docs = self.cfg["docs_per_user"]
        users = list(users)
        rows = (np.asarray(users, np.int64)[:, None] * docs
                + np.arange(docs)).reshape(-1)
        codes = self.corpus.rows_codes(rows).view(len(users), docs, -1)
        dev = codes.device
        for i, u in enumerate(users):
            s = torch.from_numpy(slots(self.cfg, self.build, u)).to(dev)
            yield u, [(codes[i], s)]


def build(cfg: dict, params: dict, targets, seed: int, device, index_cls,
          rcfg, log) -> Built:
    users, docs, dim = cfg["users"], cfg["docs_per_user"], cfg["dim"]
    rounds = params["rounds"]
    if docs % rounds:
        raise ValueError(f"{docs} documents do not split into {rounds} rounds")
    corpus = Corpus(users * docs, dim, seed, device)
    codes = torch.empty((users * docs, dim), dtype=torch.int8, device=device)
    for i in range(corpus.num_chunks):
        lo, hi = corpus.chunk_range(i)
        codes[lo:hi] = corpus.chunk_codes(i)
    t_users, t_docs = targets
    rows = torch.from_numpy(t_users * docs + t_docs).to(device)
    queries = make_queries(codes[rows], cfg["query_noise"], seed)
    index = index_cls(users * docs, dim, cfg=rcfg, device=device)
    per_user = codes.view(users, docs, dim)
    share = docs // rounds
    for r in range(rounds):
        for u in range(users):
            index.ingest_codes(u, per_user[u, r * share:(r + 1) * share])
        log(f"ingest round {r + 1} of {rounds}: {users} users x {share} docs")
    del codes, per_user
    if params["compact"]:
        index.compact()
        log("compacted")
    return Built(cfg, params, corpus, index, queries)
