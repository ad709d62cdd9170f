"""One shared corpus served as a single tenant of a `MultiTenantIndex`.

The corpus (`docs_per_user` rows of the one user, tenant 0) is made and
ingested chunk by chunk, so set-up never holds more than one chunk of
codes beside the arena. Its one slot run rounds to a power-of-two window
no smaller than the arena, so the index takes the Masked full-arena scan.
Row g lands in slot g: inserts take the next free slots in order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.corpus import Corpus, make_queries


@dataclasses.dataclass
class Built:
    cfg: dict
    corpus: Corpus
    index: object
    queries: np.ndarray

    def rows_of(self, user: int) -> int:
        return self.cfg["docs_per_user"]

    def reference_blocks(self, users):
        """The one tenant's rows, made again chunk by chunk as they are
        read."""
        if list(users) != [0]:
            raise ValueError(f"the shared corpus has tenant 0 only: {users}")
        dev = self.corpus.device

        def blocks():
            for i in range(self.corpus.num_chunks):
                lo, hi = self.corpus.chunk_range(i)
                yield (self.corpus.chunk_codes(i),
                       torch.arange(lo, hi, dtype=torch.int64, device=dev))
        yield 0, blocks()


def build(cfg: dict, params: dict, targets, seed: int, device, index_cls,
          rcfg, log) -> Built:
    if cfg["users"] != 1:
        raise ValueError("a shared corpus has one tenant")
    rows, dim = cfg["docs_per_user"], cfg["dim"]
    corpus = Corpus(rows, dim, seed, device)
    index = index_cls(rows, dim, cfg=rcfg, device=device)
    t_docs = torch.from_numpy(np.asarray(targets[1], np.int64)).to(device)
    picked = torch.empty((t_docs.numel(), dim), dtype=torch.int8,
                         device=device)
    for i in range(corpus.num_chunks):
        lo, hi = corpus.chunk_range(i)
        codes = corpus.chunk_codes(i)
        index.ingest_codes(0, codes)
        sel = ((t_docs >= lo) & (t_docs < hi)).nonzero().view(-1)
        picked[sel] = codes[t_docs[sel] - lo]
    log(f"ingested {rows} rows in {corpus.num_chunks} chunks")
    queries = make_queries(picked, cfg["query_noise"], seed)
    return Built(cfg, corpus, index, queries)
