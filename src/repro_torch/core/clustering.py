"""INT8 k-means codebooks for the cascade's centroid-prune stage.

Port of `repro.core.clustering`. A small codebook of K centroids is kept
on the device in the documents' own representation (INT8 codes, a packed
MSB nibble plane, integer squared norms), so centroid scoring is the
stage-1 plane kernel over K rows. A query scores the K centroids, keeps
its top-`nprobe` clusters, and the INT4 scan then reads only the row
blocks of those clusters.

  * `kmeans_int8` / `assign_codes` — offline clustering of INT8 code
    matrices. Distances are exact integers (argmin ||x-c||^2 via argmax
    2<x,c> - ||c||^2, computed in float64, exact for these sums), the
    argmax breaks ties toward the lower index, and the update rounds float
    means back to INT8 with numpy exactly as the reference does.
  * `ClusterIndex` — the online maintainer: running per-cluster sums and
    counts, `add` assigns new rows, `remove` retires deleted rows, and
    `refresh` re-derives the centroids from the sums without re-reading
    the corpus.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import bitplanar


@dataclasses.dataclass(frozen=True)
class ClusterParams:
    """Host-side knobs for a cluster-pruned deployment.

    num_clusters: codebook size K. nprobe: clusters scanned per query (the
    stage-1 fraction is ~nprobe / K). block_rows: plane-block granularity
    of the gather (larger blocks over-read more at cluster boundaries).
    """

    num_clusters: int
    nprobe: int = 8
    block_rows: int = 64
    kmeans_iters: int = 8
    seed: int = 0


def _as_codes(x) -> torch.Tensor:
    """int8 codes as a tensor: a tensor stays on its device, numpy input
    lands on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int8)
    return torch.from_numpy(np.array(x, np.int8, copy=True))


@dataclasses.dataclass(frozen=True)
class ClusterCodebook:
    """K centroids in the documents' INT8/nibble-planar representation.

    codes: (K, D) int8 centroid codes (same fixed scale as the corpus).
    msb_plane: (K, D//2) uint8 packed MSB nibbles (what stage 0 scans).
    norms_sq: (K,) int32 squared norms of the INT8 codes (cosine sidecar).
    """

    codes: torch.Tensor
    msb_plane: torch.Tensor
    norms_sq: torch.Tensor

    @property
    def num_clusters(self) -> int:
        return self.codes.shape[0]

    @property
    def dim(self) -> int:
        return self.codes.shape[1]

    @classmethod
    def from_codes(cls, codes, *, device=None) -> "ClusterCodebook":
        """(K, D) int8 codes (numpy or a tensor) -> the codebook on
        `device` (the CUDA device unless ``device="cpu"``)."""
        codes = _as_codes(codes).to(resolve_device(device))
        msb, _ = bitplanar.pack_nibble_planes(codes)
        norms = (codes.to(torch.int32) ** 2).sum(dim=-1, dtype=torch.int32)
        return cls(codes=codes, msb_plane=msb, norms_sq=norms)


def assign_codes(codes, centroid_codes) -> np.ndarray:
    """Nearest-centroid assignment of INT8 codes, exact integer math.

    argmin_c ||x - c||^2 == argmax_c 2<x,c> - ||c||^2. The products are
    taken in float64 on the tensors' device (numpy inputs: the CPU), exact
    for every sum of int8 products below 2**53, so no float32 or TF32
    rounding can move a label. `torch.argmax` returns the first maximum,
    the lower index, as `jnp.argmax` does. Returns (N,) int32 labels."""
    x = _as_codes(codes)
    c64 = _as_codes(centroid_codes).to(x.device, torch.float64)
    dots = x.to(torch.float64) @ c64.T                       # (N, K)
    cnorm = (c64 ** 2).sum(dim=-1)
    return torch.argmax(2 * dots - cnorm[None, :], dim=1).to(
        torch.int32).cpu().numpy()


def kmeans_int8(codes, num_clusters: int, *, iters: int = 8,
                seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Batch k-means over an INT8 code matrix (a numpy host loop).

    Assignment is exact (`assign_codes`); the update takes float64 means
    and rounds back to INT8, so the centroids stay in the corpus
    representation. Empty clusters keep their previous centroid.
    Deterministic for a given seed. Returns (centroid_codes (K, D) int8,
    labels (N,) int32), both numpy."""
    codes_np = np.asarray(codes, np.int8)
    n = codes_np.shape[0]
    k = min(num_clusters, n)
    if k < 1:
        raise ValueError("kmeans needs at least one row and one cluster")
    rng = np.random.default_rng(seed)
    cents = codes_np[rng.permutation(n)[:k]].astype(np.int8)
    labels = np.zeros(n, np.int32)
    for _ in range(iters):
        labels = assign_codes(codes_np, cents)
        new = cents.astype(np.float64).copy()
        for c in range(k):
            members = codes_np[labels == c]
            if len(members):
                new[c] = members.astype(np.float64).mean(axis=0)
        cents = np.clip(np.rint(new), -128, 127).astype(np.int8)
    labels = assign_codes(codes_np, cents)
    return cents, labels


def cluster_grouped_order(labels) -> np.ndarray:
    """Row permutation grouping rows by cluster label (stable within a
    cluster), so each cluster packs into a few contiguous blocks."""
    return np.argsort(np.asarray(labels), kind="stable")


def block_table(labels, num_clusters: int, block_rows: int, *,
                rows=None, min_blocks: int = 1,
                pad_pow2: bool = True) -> np.ndarray:
    """(K, MB) int32 table: the ids of the `block_rows`-row blocks holding
    each cluster's rows, -1 padded.

    Correct for any row layout (a fragmented cluster lists more blocks).
    MB is the max over clusters, rounded up to a power of two when
    `pad_pow2`. Rows with label < 0 (free or tombstoned) are skipped.
    `rows` restricts the table to a subset of row ids (one tenant's
    slots)."""
    labels = np.asarray(labels)
    if rows is None:
        rows = np.nonzero((labels >= 0) & (labels < num_clusters))[0]
        labs = labels[rows]
    else:
        rows = np.asarray(rows, np.int64)
        labs = labels[rows]
        keep = (labs >= 0) & (labs < num_clusters)
        rows, labs = rows[keep], labs[keep]
    # unique (label, block) pairs, sorted by label then block: one int64
    # key per pair, so the sort is a plain 1-D one (the reference's
    # `np.unique(..., axis=1)` sorts the same pairs as records, ~20x slower)
    blocks = rows // block_rows
    width = int(blocks.max()) + 1 if blocks.size else 1
    key = np.unique(labs.astype(np.int64) * width + blocks)
    labs, blocks = key // width, key % width
    counts = np.bincount(labs, minlength=num_clusters)
    mb = max(min_blocks, int(counts.max()) if counts.size else 0)
    if pad_pow2:
        mb = 1 << (mb - 1).bit_length()
    table = np.full((num_clusters, mb), -1, np.int32)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    table[labs, np.arange(labs.size) - starts[labs]] = blocks
    return table


class ClusterIndex:
    """Online-maintained cluster assignments for a streaming corpus.

    The codebook is trained on the first ingested batch (`kmeans_int8`)
    and then maintained incrementally: `add` assigns new rows and folds
    them into per-cluster running sums, `remove` retires deleted rows, and
    `refresh` re-derives the INT8 centroids from the sums. `generation`
    bumps whenever the centroids change; the device codebook is cached per
    generation on `device` (the CUDA device unless ``device="cpu"``).
    """

    def __init__(self, num_clusters: int, dim: int, *, seed: int = 0,
                 iters: int = 8, device=None):
        if num_clusters < 1:
            raise ValueError("num_clusters must be >= 1")
        self.num_clusters = num_clusters
        self.dim = dim
        self.seed = seed
        self.iters = iters
        self.device = device
        self.generation = 0
        self._centroids: np.ndarray | None = None          # (K, D) int8
        self._sums = np.zeros((num_clusters, dim), np.float64)
        self._counts = np.zeros(num_clusters, np.int64)
        self._codebook_cache: tuple[int, ClusterCodebook] | None = None

    @property
    def trained(self) -> bool:
        return self._centroids is not None

    def codebook(self) -> ClusterCodebook:
        """The device ClusterCodebook, cached per generation."""
        if not self.trained:
            raise RuntimeError("ClusterIndex has no codebook yet (no rows "
                               "ingested); call add() first")
        if (self._codebook_cache is None
                or self._codebook_cache[0] != self.generation):
            self._codebook_cache = (
                self.generation,
                ClusterCodebook.from_codes(self._centroids,
                                           device=self.device))
        return self._codebook_cache[1]

    def add(self, codes) -> np.ndarray:
        """Assign (B, D) int8 rows to clusters; returns (B,) int32 labels.

        The first call trains the codebook on the batch itself (K is
        clamped to the batch size if smaller); later calls assign against
        the current centroids and update the running sums."""
        codes_np = np.asarray(codes, np.int8)
        if codes_np.ndim != 2 or codes_np.shape[1] != self.dim:
            raise ValueError(f"codes must be (B, {self.dim}) int8")
        if not self.trained:
            cents, labels = kmeans_int8(codes_np, self.num_clusters,
                                        iters=self.iters, seed=self.seed)
            if cents.shape[0] < self.num_clusters:       # tiny first batch
                pad = np.zeros((self.num_clusters - cents.shape[0],
                                self.dim), np.int8)
                cents = np.concatenate([cents, pad])
            self._centroids = cents
            self.generation += 1
        else:
            labels = assign_codes(codes_np, self._centroids)
        self._fold(codes_np, labels, 1)
        return labels

    def remove(self, codes, labels) -> None:
        """Retire deleted rows (given their codes and labels) from the
        sums."""
        self._fold(np.asarray(codes, np.int8), np.asarray(labels, np.int32),
                   -1)

    def _fold(self, codes_np: np.ndarray, labels: np.ndarray,
              sign: int) -> None:
        """sums[labels[i]] += sign * codes[i] and counts[labels[i]] += sign,
        as the reference's `np.add.at` / `np.subtract.at` but grouped: every
        partial sum is an integer far below 2**53, so the float64 sums do
        not depend on the order of the additions."""
        if not labels.size:
            return
        order = np.argsort(labels, kind="stable")
        labs, start = np.unique(labels[order], return_index=True)
        self._sums[labs] += sign * np.add.reduceat(
            codes_np[order].astype(np.float64), start, axis=0)
        self._counts += sign * np.bincount(labels,
                                           minlength=self.num_clusters)

    def refresh(self) -> None:
        """Re-derive centroids from the running sums (no corpus re-read).
        Empty clusters keep their previous centroid. Bumps `generation`
        only if a centroid moved."""
        if not self.trained:
            return
        occ = self._counts > 0
        new = self._centroids.astype(np.float64).copy()
        new[occ] = self._sums[occ] / self._counts[occ, None]
        new = np.clip(np.rint(new), -128, 127).astype(np.int8)
        if not np.array_equal(new, self._centroids):
            self._centroids = new
            self.generation += 1
