"""Fixed-capacity nibble-planar arenas with online insert/delete.

Port of `repro.tenancy.arena`. An `Arena` is a pre-allocated slab on one
device — the (msb_plane, lsb_plane, sign_plane, norms_sq) tensors a
`BitPlanarDB` streams, plus the slot -> tenant `owner` map — and
host-side slot bookkeeping:

  * insert: quantize-with-fixed-scale rows land in the next free slots,
    written in place into the preallocated tensors — O(rows inserted),
    never O(N).
  * delete: tombstone, not reshuffle. The slot's norm is zeroed (cosine
    key 0 — a dead row can never win stage 1), its planes are zeroed
    (MIPS score 0), and its owner is reset to FREE so segment masks
    exclude it. Live slot ids stay stable for in-flight readers.
  * compact: repacks live rows to the slab's front (grouped per tenant
    by the caller's order, so each tenant becomes one contiguous
    segment), reclaims tombstones, and returns the old->new slot mapping.

Mutations write in place. The reference's eager ``.at[idx].set`` builds a
new array per mutation, so a `BitPlanarDB` it handed out earlier is a
snapshot; here `db()` aliases the live tensors, so a view taken before a
mutation sees it. Work already queued on the same CUDA stream still
reads the pre-mutation rows, because the writes queue behind it.

The fixed quantization scale is the price of streaming: rows quantized at
different times must stay mutually comparable, so the scale is chosen once
(calibrated for unit-norm embedder outputs) instead of per corpus.
`Arena.stats.rebuilds` counts full re-quantize passes; the online path
keeps it at zero by construction.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import bitplanar, quantization, similarity

FREE = -1  # owner value of free and tombstoned slots

# The fill `jnp.take` gives a uint8 row it cannot read (the reference's
# `read_codes`); both planes at 0xFF reconstruct to codes of -1.
_TAKE_FILL_U8 = 0xFF


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    """A tensor (kept as it is) or array-like (copied) on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, copy=True))
    return x.to(device)


class ArenaFull(RuntimeError):
    """Raised when an insert does not fit; compact() or grow a new arena."""


@dataclasses.dataclass
class ArenaStats:
    inserts: int = 0          # rows written online
    deletes: int = 0          # rows tombstoned
    compactions: int = 0      # repack passes
    rebuilds: int = 0         # full re-quantize passes (streaming path: 0)


class Arena:
    """One shared slab serving many tenants' rows side by side, on
    `device` (the CUDA device unless ``device="cpu"``)."""

    def __init__(self, capacity: int, dim: int, *, scale: float | None = None,
                 device=None):
        if dim % 2:
            raise ValueError("dim must be even for nibble-planar packing")
        dev = resolve_device(device)
        self.device = dev
        self.capacity = capacity
        self.dim = dim
        self._scale = np.float32(scale if scale is not None
                                 else quantization.unit_norm_scale(dim))
        self.scale = torch.tensor(self._scale, device=dev)
        self.msb_plane = torch.zeros((capacity, dim // 2), dtype=torch.uint8,
                                     device=dev)
        self.lsb_plane = torch.zeros_like(self.msb_plane)
        # 1-bit sign plane (stage-0 prescreen operand), kept in lockstep
        # with the nibble planes; dims that don't pack 8-per-byte get none.
        self.sign_plane = (torch.zeros((capacity, dim // 8),
                                       dtype=torch.uint8, device=dev)
                           if dim % 8 == 0 else None)
        self.norms_sq = torch.zeros((capacity,), dtype=torch.int32,
                                    device=dev)
        self.owner = torch.full((capacity,), FREE, dtype=torch.int32,
                                device=dev)
        # slot -> cluster label (host-side; -1 = unassigned/free), written
        # by the index layer and kept in lockstep across delete/compact.
        self.cluster_labels = np.full((capacity,), -1, np.int32)
        self._next = 0                  # bump allocator over virgin slots
        self._tombstones = 0            # dead slots awaiting compaction
        self.generation = 0             # bumped on every mutation
        self.stats = ArenaStats()
        self._db = bitplanar.BitPlanarDB(
            msb_plane=self.msb_plane, lsb_plane=self.lsb_plane,
            norms_sq=self.norms_sq, scale=self.scale,
            sign_plane=self.sign_plane)

    def _rows(self):
        """The per-slot tensors and the value a free slot holds."""
        rows = [(self.msb_plane, 0), (self.lsb_plane, 0),
                (self.norms_sq, 0), (self.owner, FREE)]
        if self.sign_plane is not None:
            rows.append((self.sign_plane, 0))
        return rows

    # -- capacity accounting -------------------------------------------------

    @property
    def num_live(self) -> int:
        return self._next - self._tombstones

    @property
    def num_free(self) -> int:
        """Slots insertable RIGHT NOW (tombstones only count after compact)."""
        return self.capacity - self._next

    def db(self) -> bitplanar.BitPlanarDB:
        """The slab viewed as the retrieval primitives' BitPlanarDB.

        One object for the arena's life: its tensors ARE the arena's, so
        it always shows the current rows (the reference's is a snapshot
        per generation; see the module docstring)."""
        return self._db

    # -- online mutation -----------------------------------------------------

    def quantize(self, embeddings) -> torch.Tensor:
        """Float embeddings (a tensor or numpy) -> INT8 codes on the
        arena's device under its fixed scale."""
        x = _as_tensor(embeddings, self.device)
        return quantization.quantize_int8_fixed(x, self._scale)

    def insert(self, codes, owner_id: int) -> np.ndarray:
        """Pack (B, D) int8 codes into free slots for `owner_id`.

        Returns the assigned slot ids (B,) int64. Bump allocation makes the
        slots one run, written in place: O(B) device work — the rest of
        the slab is untouched (no rebuild). Cluster labels are a separate
        second phase (`set_labels`), so a failed insert can never leave
        labeling half-applied."""
        codes = _as_tensor(codes, self.device)
        if codes.dtype != torch.int8:
            raise ValueError(f"codes must be int8 (got {codes.dtype}); "
                             "float embeddings go through ingest()/"
                             "quantize() first")
        b, d = codes.shape
        if d != self.dim:
            raise ValueError(f"dim mismatch: arena {self.dim}, rows {d}")
        if owner_id < 0:
            raise ValueError("tenant ids must be >= 0 (negatives are sentinels)")
        if b > self.num_free:
            raise ArenaFull(
                f"need {b} slots, have {self.num_free} "
                f"({self._tombstones} reclaimable via compact())")
        lo, hi = self._next, self._next + b
        slots = np.arange(lo, hi)
        self._next = hi
        msb, lsb = bitplanar.pack_nibble_planes(codes)
        self.msb_plane[lo:hi] = msb
        self.lsb_plane[lo:hi] = lsb
        if self.sign_plane is not None:
            self.sign_plane[lo:hi] = bitplanar.pack_sign_plane(codes)
        self.norms_sq[lo:hi] = similarity.int_dot(codes, codes)
        self.owner[lo:hi] = owner_id
        self.generation += 1
        self.stats.inserts += b
        return slots

    def set_labels(self, slots, labels) -> None:
        """Label already-inserted slots with cluster ids (host-side only).

        The index layer assigns labels AFTER a successful insert (so a
        failed insert can never leave cluster bookkeeping half-updated);
        this is the API for that second phase."""
        slots = np.atleast_1d(np.asarray(slots, np.int64))
        labels = np.asarray(labels, np.int32).reshape(-1)
        if slots.shape[0] != labels.shape[0]:
            raise ValueError(f"need one label per slot ({slots.shape[0]}), "
                             f"got {labels.shape[0]}")
        if slots.size and (slots.min() < 0 or slots.max() >= self._next):
            raise IndexError("slot out of allocated range")
        self.cluster_labels[slots] = labels

    def read_codes(self, slots) -> torch.Tensor:
        """Reconstruct the full INT8 codes of `slots` from the planes.

        Off the hot path (cluster bookkeeping on delete, diagnostics):
        O(rows read), exact inverse of the insert-time packing. Indexing
        follows the reference's `jnp.take`: a negative slot counts from
        the end, and a slot outside [-capacity, capacity) reads as a row
        of -1 codes (both planes filled with 0xFF)."""
        idx = np.atleast_1d(np.asarray(slots, np.int64))
        idx = np.where(idx < 0, idx + self.capacity, idx)
        ok = (idx >= 0) & (idx < self.capacity)
        rows = torch.from_numpy(np.where(ok, idx, 0)).to(self.device)
        msb, lsb = self.msb_plane[rows], self.lsb_plane[rows]
        if not ok.all():
            bad = torch.from_numpy(~ok).to(self.device)
            msb[bad] = _TAKE_FILL_U8
            lsb[bad] = _TAKE_FILL_U8
        return bitplanar.reconstruct_int8(msb, lsb)

    def delete(self, slots) -> None:
        """Tombstone slots: norm 0, planes 0, owner FREE.

        Ids are not recycled until compact(), so results already handed to
        callers keep pointing at (now dead, never-winning) slots.
        Duplicate and already-dead ids are counted once (liveness is read
        from the owner tensor, so num_live stays truthful)."""
        slots = np.unique(np.atleast_1d(np.asarray(slots, np.int64)))
        if slots.size == 0:
            return
        if slots[0] < 0 or slots[-1] >= self._next:
            raise IndexError("slot out of allocated range")
        idx = torch.from_numpy(slots).to(self.device)
        newly_dead = int((self.owner[idx] >= 0).sum())
        # A zero sign byte is the packed form of all-positive dims —
        # consistent with the zeroed nibble planes (code 0 -> bit 0).
        for arr, fill in self._rows():
            arr.index_fill_(0, idx, fill)
        self.cluster_labels[slots] = -1
        self.generation += 1
        self._tombstones += newly_dead
        self.stats.deletes += newly_dead

    def compact(self, order: np.ndarray | None = None) -> np.ndarray:
        """Repack live rows to the slab front; reclaim tombstones.

        order: optional live-slot ordering (e.g. grouped by tenant so each
        tenant ends up one contiguous segment); defaults to ascending slot.
        Returns mapping (capacity,) int64: old slot -> new slot, -1 if dead.
        Moves already-quantized rows — no re-quantization (not a rebuild).
        Each tensor's live rows are gathered into a new tensor before the
        slab is written: a tenant-grouped order is not monotone, so an
        in-place repack would read rows it had already overwritten.
        """
        own = self.owner.cpu().numpy()
        if order is None:
            live = np.nonzero(own >= 0)[0]
        else:
            live = np.asarray(order, np.int64)
            if live.size and not np.all(own[live] >= 0):
                raise ValueError("compaction order includes dead slots")
        num_live = live.size
        idx = torch.from_numpy(live).to(self.device)
        for arr, fill in self._rows():
            moved = arr.index_select(0, idx)
            arr[num_live:] = fill
            arr[:num_live] = moved
        new_labels = np.full_like(self.cluster_labels, -1)
        new_labels[:num_live] = self.cluster_labels[live]
        self.cluster_labels = new_labels
        mapping = np.full(self.capacity, -1, np.int64)
        mapping[live] = np.arange(num_live)
        self._next = num_live
        self._tombstones = 0
        self.generation += 1
        self.stats.compactions += 1
        return mapping
