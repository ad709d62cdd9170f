"""Seeded INT8 corpora and queries, made on the device.

A corpus is `rows` unit vectors of width `dim`, numbered globally. They
are made in chunks of `chunk_rows` rows; chunk i draws from its own
`torch.Generator` seeded by (seed, i), so any chunk can be made again
alone, in the same bits, by the reference after the window. Codes use the
fixed scale of unit-norm embeddings, 4 / (127 sqrt(D)), so rows quantized
apart stay comparable (the arena's convention for streamed ingests).

A query is one corpus row plus relative noise, made unit again and
quantized per vector to the full INT8 range (the repo's golden protocol:
noise 0.1).
"""
from __future__ import annotations

import math

import numpy as np
import torch

CHUNK_ROWS = 1 << 19


def sub_seed(seed: int, *tags: int) -> int:
    """A 64-bit seed for one stream, from the run's seed and its tags;
    any whole number (negative or past 64 bits too) is a valid seed."""
    words = [seed % (1 << 64), *tags]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)
    return int(state[0])


def generator(device: torch.device, seed: int, *tags: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *tags))
    return gen


class Corpus:
    """`rows` seeded INT8 unit-vector codes of width `dim` on `device`."""

    def __init__(self, rows: int, dim: int, seed: int, device: torch.device,
                 chunk_rows: int | None = None):
        self.rows, self.dim, self.seed = rows, dim, seed
        self.device = torch.device(device)
        self.chunk_rows = chunk_rows or CHUNK_ROWS
        self.inv_scale = 127.0 * math.sqrt(dim) / 4.0

    @property
    def num_chunks(self) -> int:
        return -(-self.rows // self.chunk_rows)

    def chunk_range(self, i: int) -> tuple[int, int]:
        lo = i * self.chunk_rows
        return lo, min(self.rows, lo + self.chunk_rows)

    def chunk_codes(self, i: int) -> torch.Tensor:
        """(rows of chunk i, dim) int8 codes on the device."""
        lo, hi = self.chunk_range(i)
        gen = generator(self.device, self.seed, 1, i)
        x = torch.randn((hi - lo, self.dim), generator=gen,
                        device=self.device)
        x.mul_(self.inv_scale / x.norm(dim=1, keepdim=True))
        return x.round_().clamp_(-128, 127).to(torch.int8)

    def rows_codes(self, rows: np.ndarray) -> torch.Tensor:
        """Codes of the given global rows, in their order, made again
        chunk by chunk (only the chunks that hold one of them)."""
        rows = np.asarray(rows, np.int64)
        out = torch.empty((rows.size, self.dim), dtype=torch.int8,
                          device=self.device)
        chunk = rows // self.chunk_rows
        for i in np.unique(chunk):
            sel = np.flatnonzero(chunk == i)
            lo, _ = self.chunk_range(int(i))
            local = torch.from_numpy(rows[sel] - lo).to(self.device)
            out[torch.from_numpy(sel).to(self.device)] = (
                self.chunk_codes(int(i))[local])
        return out


def make_queries(doc_codes: torch.Tensor, noise: float, seed: int
                 ) -> np.ndarray:
    """(Q, D) int8 host queries: each a noisy copy of its row of
    `doc_codes` (on the device), unit again, quantized per vector."""
    if doc_codes.shape[0] == 0:
        return np.zeros((0, doc_codes.shape[1]), np.int8)
    gen = generator(doc_codes.device, seed, 2)
    x = doc_codes.to(torch.float32)
    x /= x.norm(dim=1, keepdim=True).clamp_min(1.0)
    e = torch.randn(x.shape, generator=gen, device=x.device)
    x += noise * e / e.norm(dim=1, keepdim=True)
    x /= x.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    codes = (x * 127.0).round_().clamp_(-128, 127).to(torch.int8)
    return codes.cpu().numpy()
