"""Session-aware serving runtime: deadline batcher + hot-cluster cache.

Port of `repro.serve.runtime`. The wearable workload is a stream of small,
temporally correlated request bursts: many users' agents each send a query
every few seconds, and a session's consecutive queries probe the same few
clusters. Two parts serve it on top of the cluster-pruned cascade:

  * `ServingRuntime` — a dynamic batcher. `submit` returns a future-style
    `RequestHandle`; a batch launches when it is full or when its oldest
    request's deadline arrives; partial batches pad to power-of-two
    buckets with `NO_TENANT` lanes; batch formation is round-robin across
    tenants ordered by deadline ("deadline_rr") or strict arrival order
    ("fifo"). Launches are asynchronous: a dispatch leaves the batch's
    result tensors in flight on a completion queue (up to `async_depth`
    launches; a CUDA event recorded after the dispatch tells when they
    landed) and the host goes back to admission. Handles resolve lazily;
    the cached path's host bookkeeping (the (B, nprobe) selection read
    back for the hit/miss ledger, the LRU, admissions and the session
    prior) runs at retire time, in launch order.

  * `HotClusterCache` — a byte-budgeted LRU of hot (tenant, cluster) views
    in a device-resident slab: an extension of the arena's stage-1 plane
    (``[arena plane | slab rows]``, one tensor rebuilt per arena
    generation, so a snapshot of the arena's rows) plus a host-side slot
    map. A cached launch hands the engine a `SlabPolicy` whose per-launch
    int32 table points each (lane, cluster) at its arena plane blocks (a
    miss) or its slab slots (a hit). Slots are densely packed, each with
    (first row id, live rows) origin scalars. Admissions are in-place
    device row copies (`index_copy_`) on the one stream every launch runs
    on, so a fill that reuses a slot an in-flight launch reads is ordered
    after that launch. Any arena mutation bumps the generation and drops
    every slot. With `precision_tiers`, an entry is held at full precision
    (its nibble rows in slab slots) or at the sign tier (no slots; only its
    1-bit sign bytes are charged to the budget): first contact admits at
    the sign tier, a re-probe promotes to full, and slot or byte pressure
    demotes the least recently used full entry before any residency is
    dropped.

`account_decode` charges a decode run's KV-cascade ledger
(`engine.kv_plan`) to the same registry and energy model as retrieval.

Results are bit-identical to the uncached cascade: the cache changes where
stage-1 bytes come from, never what is scored.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import math
import time
from collections.abc import Callable

import numpy as np
import torch

from repro_torch._device import upload
from repro_torch.core import bitplanar, energy, engine
from repro_torch.core.retrieval import NO_TENANT, RetrievalResult
from repro_torch.obs.metrics import MetricsRegistry, NULL_REGISTRY
from repro_torch.obs.tracing import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Host-side serving knobs.

    max_batch: lanes per launch (a full batch launches at once).
    max_wait: seconds a request may wait before its default deadline
        forces a (possibly partial) launch; 0 = launch only when full or
        flushed.
    fairness: "deadline_rr" (tenants round-robin, ordered by their head
        request's deadline) or "fifo" (strict arrival order).
    cache_bytes: hot-cluster cache budget in bytes of stage-1 plane views
        (0 disables the cache).
    prior_clusters: recently probed clusters remembered per tenant (the
        session prior that warms the cache between turns).
    preload: pin every batch tenant's whole cluster set into the slab when
        the batch's packed views fit the budget together; such launches
        run from the cache's compact table.
    auto_flush: launch full batches from submit().
    async_depth: dispatched launches that may stay in flight before the
        host blocks on the oldest; 0 resolves every launch before
        `_launch` returns.
    precision_tiers: per-cluster precision in the hot-cluster cache: hot
        clusters stay full tier (nibble rows in the slab, stage-1 hits
        served from it); under slot or byte pressure the least recently
        used full entry is demoted to the sign tier (its slots freed, its
        1-bit sign bytes still charged, so stage 0 still reads them from
        the cache while stage 1 streams the plane), and misses are
        admitted at the sign tier and promoted to full on a re-probe.
        False: every entry full tier, eviction drops entries.
    """

    max_batch: int = 16
    max_wait: float = 0.005
    fairness: str = "deadline_rr"
    cache_bytes: int = 0
    prior_clusters: int = 8
    preload: bool = False
    auto_flush: bool = True
    async_depth: int = 2
    precision_tiers: bool = False

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_wait < 0:
            raise ValueError("max_wait must be >= 0")
        if self.async_depth < 0:
            raise ValueError("async_depth must be >= 0 (0 = synchronous)")
        if self.fairness not in ("deadline_rr", "fifo"):
            raise ValueError(f"unknown fairness policy {self.fairness!r}")
        if self.cache_bytes < 0 or self.prior_clusters < 0:
            raise ValueError("cache_bytes/prior_clusters must be >= 0")
        if self.preload and self.cache_bytes == 0:
            raise ValueError("preload=True pins clusters into the "
                             "hot-cluster cache slab: it needs a "
                             "cache_bytes budget > 0")
        if self.precision_tiers and self.cache_bytes == 0:
            raise ValueError("precision_tiers=True tiers the hot-cluster "
                             "cache's entries: it needs a cache_bytes "
                             "budget > 0")


class RequestHandle:
    """Future-style handle for one submitted query.

    ``state``: "pending" (queued) -> "admitted" (picked into a batch being
    dispatched) -> "in_flight" (dispatched, result on the completion
    queue) -> "resolved" (retired; `result()` returns at once).

    `done()` never blocks: it reports resolved, or asks the launch's CUDA
    event and retires the completion queue through it when it landed.
    `result(wait=False)` returns None until then; `result()` blocks only
    as far as needed (an in-flight request retires its own launch, a
    queued one flushes the runtime). Results are CPU tensors."""

    __slots__ = ("request_id", "tenant_id", "deadline", "launch_index",
                 "_runtime", "_result", "_inflight")

    def __init__(self, runtime: "ServingRuntime", request_id: int,
                 tenant_id: int, deadline: float):
        self.request_id = request_id
        self.tenant_id = tenant_id
        self.deadline = deadline
        self.launch_index: int | None = None   # which launch admitted it
        self._runtime = runtime
        self._result: RetrievalResult | None = None
        self._inflight: "_InFlight | None" = None

    @property
    def state(self) -> str:
        if self._result is not None:
            return "resolved"
        if self._inflight is not None:
            return "in_flight"
        if self.launch_index is not None:
            return "admitted"
        return "pending"

    def done(self) -> bool:
        """Non-blocking: True iff `result()` would return at once. A
        landed in-flight request is retired here, with every earlier
        launch (the card runs them in dispatch order)."""
        if self._result is not None:
            return True
        infl = self._inflight
        if infl is None or not infl.is_ready():
            return False
        self._runtime._retire_through(infl)
        return True

    def result(self, *, wait: bool = True) -> RetrievalResult | None:
        if self._result is None:
            if not wait:
                return self._result if self.done() else None
            if self._inflight is not None:
                self._runtime._retire_through(self._inflight)
            else:
                self._runtime.flush()
        assert self._result is not None
        return self._result

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"RequestHandle(id={self.request_id}, "
                f"tenant={self.tenant_id}, {self.state})")


@dataclasses.dataclass
class _Pending:
    handle: RequestHandle
    query: np.ndarray             # (D,) int8
    seq: int                      # arrival order
    submit_ts: float = 0.0        # submit clock (queue-wait histogram)


@dataclasses.dataclass
class _InFlight:
    """One dispatched, unresolved launch on the completion queue.

    `res` holds the launch's result tensors; `done` the CUDA event
    recorded right after the dispatch (None on the CPU, where a launch has
    finished when it returns); `book` the cached path's deferred host
    bookkeeping, run at retire time. `admit_now` is the launch's admission
    clock (queue-wait histogram and trace ends), `dispatch_t` the
    monotonic dispatch instant the resolve-lag histogram measures from."""

    group: list[_Pending]
    res: RetrievalResult
    launch_index: int
    admit_now: float
    dispatch_t: float
    book: Callable[[], None] | None = None
    done: torch.cuda.Event | None = None

    def is_ready(self) -> bool:
        """Non-blocking: whether the launch's work on the card finished."""
        return self.done is None or self.done.query()


# Per-cluster precision tiers; a combined block is in exactly one:
TIER_PLANE = 0   # an arena plane block, not managed by the cache
TIER_SIGN = 1    # resident at 1 bit: only the cluster's sign bytes are
#                  charged; stage 0 reads them from the cache, stage 1
#                  streams the nibble plane from device memory
TIER_FULL = 2    # resident at full precision: slab slots hold the nibble
#                  rows; stages 0 and 1 both read the cache


@dataclasses.dataclass
class _SlabEntry:
    slab_blocks: np.ndarray       # (nblk,) int32 slab slot ids
    n_rows: int                   # live rows packed into those slots
    nbytes: int                   # budget charge: nblk*block_rows*bytes/row
    #                               (full tier) or the sign bytes (sign)
    tier: int = TIER_FULL         # TIER_SIGN or TIER_FULL
    plane_blocks: np.ndarray | None = None  # the cluster's plane block ids


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _apply_fills(plane, inv_norms, block_gid0, block_count, row_src_dst,
                 blk, sign_plane=None) -> None:
    """In-place admission fills on the combined plane and its sidecars.

    row_src_dst: (2, Fr) int64 (source plane row, destination combined
    row) copies, row granular so packed slots can start mid-block; blk:
    (3, Fb) int64 (combined block id, first global row id, live rows) of
    the filled slots. Destinations are unique (the cache keys its pending
    fills by destination), so the writes are deterministic. `sign_plane`,
    when the cache holds one, takes the same row copies (a copied row's
    sign bytes are its source's)."""
    src, dst = row_src_dst[0], row_src_dst[1]
    plane.index_copy_(0, dst, plane[src])
    inv_norms.index_copy_(0, dst, inv_norms[src])
    if sign_plane is not None:
        sign_plane.index_copy_(0, dst, sign_plane[src])
    ids = blk[0]
    block_gid0.index_copy_(0, ids, blk[1].to(torch.int32))
    block_count.index_copy_(0, ids, blk[2].to(torch.int32))


def _inv_norm_sidecar(norms_sq: torch.Tensor) -> torch.Tensor:
    """The cosine key's per-row f32 factor, once per arena generation:
    ``rsqrt(max(norm, 1))`` for live rows, 0 for empty ones. The same
    `torch.rsqrt` on the same values as `similarity.cosine_key_f32`, so
    gathering it and multiplying gives the cold path's key bits."""
    n = torch.clamp(norms_sq.to(torch.float32), min=1.0)
    return torch.where(norms_sq > 0, torch.rsqrt(n), torch.zeros_like(n))


class HotClusterCache:
    """Byte-budgeted LRU of hot cluster views in a device-resident slab.

    The slab extends the arena's stage-1 plane: one combined tensor
    ``[arena plane | slab rows]`` (plus f32 inverse-norm and per-block
    origin sidecars), carved into `block_rows`-row slots. Entries are
    keyed (tenant, cluster) and hold the slots their rows were copied
    into; the host never sees the bytes. A contiguous cluster run packs
    into ``ceil(rows / block_rows)`` slots (a fragmented one mirrors its
    whole plane blocks), which is what lets `compact_table` give a fully
    resident launch a narrower table than the plane's.

    Entries are valid for the arena generation they were copied under:
    `sync_generation` drops the slot map (and the combined tensor) when
    the arena mutated. Within a generation, eviction is least recently
    used, slot granular, under `budget_bytes`. Empty clusters are held as
    zero-slot entries, so their repeat probes are hits. With
    `precision_tiers`, entries are full or sign tier (see `put`).
    """

    def __init__(self, budget_bytes: int, *, registry=None,
                 precision_tiers: bool = False):
        if budget_bytes < 0:
            raise ValueError("budget_bytes must be >= 0")
        self.precision_tiers = precision_tiers
        # Counters live in a metrics registry (the runtime's when
        # observability is on, a private one otherwise); snapshot() and
        # reset_stats() give windowed reads.
        self.registry = registry if registry is not None else (
            MetricsRegistry())
        self._hits = self.registry.counter("cache_hits")
        self._misses = self.registry.counter("cache_misses")
        self._evictions = self.registry.counter("cache_evictions")
        self._stale_evictions = self.registry.counter(
            "cache_stale_evictions")
        self._rejected = self.registry.counter("cache_rejected")
        self._fill_bytes = self.registry.counter("cache_fill_bytes")
        self._fill_dispatches = self.registry.counter(
            "cache_fill_dispatches")
        self._demotions = self.registry.counter("cache_demotions")
        self._promotions = self.registry.counter("cache_promotions")
        self.budget_bytes = budget_bytes
        self.block_rows: int | None = None
        self.bytes_per_row: int | None = None
        self.num_slab_blocks = 0
        self._entries: collections.OrderedDict[tuple[int, int],
                                               _SlabEntry] = (
            collections.OrderedDict())
        self._free: list[int] = []
        self._generation = -1
        # Bumps on every slot-map change; launches key their device tables
        # on it, so a fully warm launch re-uses its table with no upload.
        self.version = 0
        self._slab_plane: torch.Tensor | None = None  # (N + S*br, D//2) u8
        self._inv_norms: torch.Tensor | None = None   # (N + S*br,) f32
        self._sign: torch.Tensor | None = None        # (N + S*br, D//8) u8
        self._packed: torch.Tensor | None = None      # (N,) int32
        self._gid0: torch.Tensor | None = None        # (NB + S,) int32
        self._cnt: torch.Tensor | None = None         # (NB + S,) int32
        # (slot-map version, (NB + S,) int8 tiers on the device)
        self._tier_cache: tuple[int, torch.Tensor] | None = None
        self._plane_rows = 0
        self._table_cache: dict = {}  # key -> (version, ...) device tables
        # Per tenant: its resident clusters, and a (width, host row,
        # combined row) kept in step by put/evict, so a launch's table is
        # a few row copies, never a loop over every entry.
        self._by_tenant: dict[int, set[int]] = {}
        self._nonempty: dict[int, int] = {}   # resident nonempty entries
        self._tenant_rows: dict[int, tuple[int, np.ndarray, np.ndarray]] = {}
        # Pending fills, keyed by destination, so a slot reissued before
        # the next flush carries its newest owner's rows.
        self._fill_rows: dict[int, int] = {}          # dst slab row -> src
        self._fill_blocks: dict[int, tuple[int, int]] = {}  # slot -> scalars
        self.bytes_used = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    @property
    def stale_evictions(self) -> int:
        return self._stale_evictions.value

    @property
    def rejected(self) -> int:
        """Views larger than the whole slab (refused admission)."""
        return self._rejected.value

    @property
    def demotions(self) -> int:
        """Full-tier entries squeezed down to the sign tier."""
        return self._demotions.value

    @property
    def promotions(self) -> int:
        """Sign-tier entries admitted again at full precision on a
        re-probe."""
        return self._promotions.value

    def snapshot(self) -> dict:
        """Counter values since the last `reset_stats` (with tiers, the
        tier counters and the entries per tier too)."""
        out = {"hits": self.hits, "misses": self.misses,
               "evictions": self.evictions,
               "stale_evictions": self.stale_evictions,
               "rejected": self.rejected,
               "fill_bytes": self._fill_bytes.value,
               "fill_dispatches": self._fill_dispatches.value}
        if self.precision_tiers:
            out["demotions"] = self.demotions
            out["promotions"] = self.promotions
            out["sign_entries"] = sum(
                1 for e in self._entries.values() if e.tier == TIER_SIGN)
            out["full_entries"] = sum(
                1 for e in self._entries.values() if e.tier == TIER_FULL)
        return out

    def reset_stats(self) -> None:
        """Zero the event counters; contents and byte accounting stay."""
        for c in (self._hits, self._misses, self._evictions,
                  self._stale_evictions, self._rejected, self._fill_bytes,
                  self._fill_dispatches, self._demotions, self._promotions):
            c.reset()

    @property
    def generation(self) -> int:
        """The arena generation the slab mirrors."""
        return self._generation

    @property
    def slab_plane(self) -> torch.Tensor | None:
        return self._slab_plane

    @property
    def inv_norms(self) -> torch.Tensor | None:
        return self._inv_norms

    @property
    def packed_labels(self) -> torch.Tensor | None:
        return self._packed

    @property
    def block_gid0(self) -> torch.Tensor | None:
        return self._gid0

    @property
    def block_count(self) -> torch.Tensor | None:
        return self._cnt

    @property
    def sign_plane(self) -> torch.Tensor | None:
        """The combined 1-bit sign plane ``[arena signs | slab signs]``,
        derived from the combined msb plane on first use and then kept in
        step by the fills; None when the dim does not pack 8 per byte or
        before `ensure_slab`."""
        if self._slab_plane is None or (self._slab_plane.shape[1] * 2) % 8:
            return None
        if self._sign is None:
            self._sign = bitplanar.sign_plane_from_msb(self._slab_plane)
        return self._sign

    @property
    def block_tier(self) -> torch.Tensor | None:
        """The (NB + S,) int8 tier of every combined block on the device:
        TIER_FULL on the slots of full-tier entries, TIER_SIGN on the plane
        blocks of sign-tier residents, TIER_PLANE elsewhere (free slots
        too). Ledger and check metadata: the cascade routes through the
        launch table, never through this. Cached per slot-map version;
        None before `ensure_slab`."""
        if self._slab_plane is None or self.block_rows is None:
            return None
        if self._tier_cache is None or self._tier_cache[0] != self.version:
            base = self._plane_rows // self.block_rows
            tier = np.zeros(base + self.num_slab_blocks, np.int8)
            for e in self._entries.values():
                if e.tier == TIER_FULL and e.slab_blocks.size:
                    tier[e.slab_blocks + base] = TIER_FULL
                elif e.tier == TIER_SIGN and e.plane_blocks is not None:
                    tier[e.plane_blocks] = TIER_SIGN
            self._tier_cache = (self.version,
                                upload(tier, self._slab_plane.device))
        return self._tier_cache[1]

    def _drop_device(self) -> None:
        self._slab_plane = self._inv_norms = self._sign = None
        self._packed = self._gid0 = self._cnt = None

    def _reset_slots(self) -> None:
        self._entries.clear()
        # allocation pops from the tail: reversed so slots hand out 0, 1, ...
        self._free = list(range(self.num_slab_blocks))[::-1]
        self._table_cache.clear()
        self._by_tenant.clear()
        self._nonempty.clear()
        self._tenant_rows.clear()
        self._fill_rows.clear()
        self._fill_blocks.clear()
        self.bytes_used = 0
        self.version += 1
        self._tier_cache = None

    def configure(self, block_rows: int, bytes_per_row: int) -> None:
        """Pin the slot geometry (idempotent; a change re-carves the slab
        and invalidates every entry)."""
        if (block_rows, bytes_per_row) == (self.block_rows,
                                           self.bytes_per_row):
            return
        if self.precision_tiers and bytes_per_row % 4:
            # A row's sign bytes are bytes_per_row / 4 (1 bit against 4 per
            # dim): the tiers' budget arithmetic needs it integral.
            raise ValueError("precision_tiers needs dim % 8 == 0 "
                             f"(bytes_per_row {bytes_per_row} % 4 != 0)")
        self._stale_evictions.inc(len(self._entries))
        self.block_rows = block_rows
        self.bytes_per_row = bytes_per_row
        self.num_slab_blocks = self.budget_bytes // (block_rows
                                                     * bytes_per_row)
        self._drop_device()
        self._reset_slots()

    def sync_generation(self, generation: int) -> None:
        """Invalidate everything copied under an older arena state."""
        if generation != self._generation:
            self._stale_evictions.inc(len(self._entries))
            self._drop_device()
            self._reset_slots()
            self._generation = generation

    def ensure_slab(self, msb_plane: torch.Tensor, norms_sq: torch.Tensor,
                    owner: torch.Tensor, labels: torch.Tensor,
                    num_clusters: int) -> None:
        """(Re)build the combined plane and its sidecars for this
        generation: one device concatenation per arena mutation (a copy,
        so a snapshot of the arena's rows), the f32 inverse norms and the
        packed (owner, label) membership rows."""
        if self._slab_plane is not None:
            return
        if self.block_rows is None:
            raise RuntimeError("configure() the slot geometry first")
        n, d2 = msb_plane.shape
        if n % self.block_rows:
            raise ValueError(f"plane rows {n} not a multiple of "
                             f"block_rows {self.block_rows}")
        self._plane_rows = n
        dev = msb_plane.device
        slab_rows = self.num_slab_blocks * self.block_rows
        self._slab_plane = torch.cat(
            [msb_plane, torch.zeros((slab_rows, d2), dtype=torch.uint8,
                                    device=dev)])
        self._inv_norms = torch.cat(
            [_inv_norm_sidecar(norms_sq),
             torch.zeros((slab_rows,), dtype=torch.float32, device=dev)])
        self._packed = engine.packed_membership(owner, labels, num_clusters)
        # Per-block origin scalars: plane blocks are their own origin;
        # slab blocks start empty (count 0: an unfilled slot never
        # surfaces a row) and are written by the fills.
        nb = n // self.block_rows
        zeros = torch.zeros((self.num_slab_blocks,), dtype=torch.int32,
                            device=dev)
        self._gid0 = torch.cat(
            [torch.arange(nb, dtype=torch.int32, device=dev)
             * self.block_rows, zeros])
        self._cnt = torch.cat(
            [torch.full((nb,), self.block_rows, dtype=torch.int32,
                        device=dev), zeros])

    # -- slot map -----------------------------------------------------------

    def get(self, tenant: int, cluster: int) -> _SlabEntry | None:
        entry = self._entries.get((tenant, cluster))
        if entry is None:
            self._misses.inc()
            return None
        self._entries.move_to_end((tenant, cluster))
        self._hits.inc()
        return entry

    def lookup_lane(self, tenant: int, clusters) -> tuple[int, list[int]]:
        """`get()` for one lane's probed clusters at once: (hit bytes,
        missing cluster ids), one hit or miss per probe, hits refreshed
        most recent in probe order."""
        resident = self._by_tenant.get(tenant)
        if not resident:
            self._misses.inc(len(clusters))
            return 0, list(clusters)
        entries = self._entries
        hit_bytes = 0
        missing: list[int] = []
        nhits = 0
        for c in clusters:
            if c in resident:
                key = (tenant, c)
                hit_bytes += entries[key].nbytes
                entries.move_to_end(key)
                nhits += 1
            else:
                missing.append(c)
        self._hits.inc(nhits)
        self._misses.inc(len(missing))
        return hit_bytes, missing

    def lookup_lane_tiers(self, tenant: int, clusters
                          ) -> tuple[int, int, list[int], list[int]]:
        """`lookup_lane` with the split the tiered ledger needs: (full-tier
        hit bytes, sign-tier hit bytes, sign-tier cluster ids, missing
        cluster ids). A sign-tier resident is a hit (its sign bytes serve
        stage 0 from the cache, its LRU position refreshes), but its
        stage-1 plane blocks stream from device memory: the caller charges
        them like a miss's and promotes the entry."""
        resident = self._by_tenant.get(tenant)
        if not resident:
            self._misses.inc(len(clusters))
            return 0, 0, [], list(clusters)
        entries = self._entries
        full_bytes = sign_bytes = nhits = 0
        sign_hits: list[int] = []
        missing: list[int] = []
        for c in clusters:
            if c in resident:
                key = (tenant, c)
                e = entries[key]
                if e.tier == TIER_FULL:
                    full_bytes += e.nbytes
                else:
                    sign_bytes += e.nbytes
                    sign_hits.append(c)
                entries.move_to_end(key)
                nhits += 1
            else:
                missing.append(c)
        self._hits.inc(nhits)
        self._misses.inc(len(missing))
        return full_bytes, sign_bytes, sign_hits, missing

    def peek(self, tenant: int, cluster: int) -> bool:
        """Membership without touching the counters or the LRU."""
        return (tenant, cluster) in self._entries

    def touch(self, tenant: int, cluster: int) -> None:
        """Refresh an entry's LRU position without counting a hit."""
        if (tenant, cluster) in self._entries:
            self._entries.move_to_end((tenant, cluster))

    @staticmethod
    def _pack_plan(rows: np.ndarray, block_rows: int) -> tuple[bool, int]:
        """(packed?, slots) of one cluster's rows: ``ceil(rows / br)`` for
        a contiguous run, its distinct plane blocks when fragmented. The
        one source of admission arithmetic for `put` and the preload."""
        n_rows = int(rows.size)
        if n_rows == 0:
            return True, 0
        if int(rows[-1]) - int(rows[0]) + 1 == n_rows:
            return True, -(-n_rows // block_rows)
        return False, int(np.unique(rows // block_rows).size)

    @classmethod
    def entry_blocks(cls, rows, block_rows: int) -> int:
        """Slab slots one cluster's rows will occupy (see _pack_plan)."""
        return cls._pack_plan(np.atleast_1d(np.asarray(rows, np.int64)),
                              block_rows)[1]

    def put(self, tenant: int, cluster: int, rows, *,
            tier: int = TIER_FULL) -> np.ndarray | None:
        """Admit one (tenant, cluster)'s rows (global plane row ids,
        ascending) into the slab; the row copies and origin scalars wait
        for the next `flush_fills`. Returns the slot ids (empty for an
        empty or sign-tier cluster), or None when the view is larger than
        the whole slab (or, at the sign tier, the budget) — checked before
        a resident entry of the same key is replaced, so a refused re-put
        leaves it as it was.

        `tier` (with precision_tiers only): TIER_FULL copies the nibble
        rows into slots; TIER_SIGN admits at 1 bit: no slots, no fills,
        only the sign bytes charged, the launch table left pointing at
        the plane blocks. Under tiers, slot pressure demotes the least
        recently used full entry instead of dropping it, and byte
        pressure demotes full entries first, then drops sign entries."""
        if self.block_rows is None:
            raise RuntimeError("configure() the slot geometry first")
        if tier == TIER_SIGN and not self.precision_tiers:
            raise ValueError("sign-tier admission needs precision_tiers")
        br = self.block_rows
        rows = np.atleast_1d(np.asarray(rows, np.int64)).astype(np.int32)
        n_rows = int(rows.size)
        if n_rows == 0:
            tier = TIER_FULL        # a zero-slot memo: tiers are moot
        packed, nblk = self._pack_plan(rows, br)
        plane_blocks = np.unique(rows // br).astype(np.int32)
        sign_bytes = nblk * br * (self.bytes_per_row // 4)
        if packed:
            src = rows
            gid0s = [int(rows[0]) + i * br for i in range(nblk)] if n_rows \
                else []
            cnts = [min(br, n_rows - i * br) for i in range(nblk)]
        else:
            blocks = plane_blocks.astype(np.int64)
            src = (blocks[:, None] * br
                   + np.arange(br, dtype=np.int64)).reshape(-1)
            gid0s = (blocks * br).tolist()
            cnts = [br] * nblk
        if (nblk > self.num_slab_blocks if tier == TIER_FULL
                else sign_bytes > self.budget_bytes):
            # Squeezing it in would evict every other entry and then the
            # new one itself: it stays streamed from the plane instead.
            self._rejected.inc()
            return None
        key = (tenant, cluster)
        old = self._entries.pop(key, None)
        if old is not None:
            self._drop_entry(key, old)
        nslots = nblk if tier == TIER_FULL else 0
        while len(self._free) < nslots:
            # LRU skipping zero-slot entries: evicting an empty-cluster
            # memo frees nothing.
            victim = next((k for k, e in self._entries.items()
                           if e.slab_blocks.size), None)
            if victim is None:
                break
            if self.precision_tiers:
                self._demote(victim)    # free the slots, keep the signs
            else:
                self._drop_entry(victim, self._entries.pop(victim))
                self._evictions.inc()
        nbytes = (nblk * br * self.bytes_per_row if tier == TIER_FULL
                  else sign_bytes)
        if self.precision_tiers:
            # Byte pressure (sign charges hold budget but no slots): demote
            # the least recently used full entries first, then drop sign
            # entries, so precision degrades before residency is lost.
            while self.bytes_used + nbytes > self.budget_bytes:
                vic = next((k for k, e in self._entries.items()
                            if e.tier == TIER_FULL and e.slab_blocks.size),
                           None)
                if vic is not None:
                    self._demote(vic)
                    continue
                vic = next((k for k, e in self._entries.items()
                            if e.nbytes), None)
                if vic is None:
                    break
                self._drop_entry(vic, self._entries.pop(vic))
                self._evictions.inc()
        dst = np.asarray([self._free.pop() for _ in range(nslots)],
                         np.int32)
        self._entries[key] = _SlabEntry(slab_blocks=dst, n_rows=n_rows,
                                        nbytes=nbytes, tier=tier,
                                        plane_blocks=plane_blocks)
        self.bytes_used += nbytes
        self._by_tenant.setdefault(tenant, set()).add(cluster)
        if n_rows and tier == TIER_FULL:
            self._nonempty[tenant] = self._nonempty.get(tenant, 0) + 1
        row = self._tenant_rows.get(tenant)
        if tier == TIER_FULL:
            self._fill_bytes.inc(nbytes)
            for i, slot in enumerate(dst.tolist()):
                self._fill_blocks[slot] = (gid0s[i], cnts[i])
                slot_row0 = slot * br
                for j, s in enumerate(src[i * br:(i + 1) * br].tolist()):
                    self._fill_rows[slot_row0 + j] = int(s)
            if row is not None:
                base = self._plane_rows // br
                row[2][cluster, :nblk] = dst + base
                row[2][cluster, nblk:] = -1
        elif row is not None:
            # A sign-tier entry holds no slab rows: stage 1 keeps reading
            # the cluster's plane blocks.
            row[2][cluster] = row[1][cluster]
        self.version += 1
        return dst

    def _demote(self, key: tuple[int, int]) -> None:
        """Squeeze a full-tier entry down to the sign tier in place: free
        its slots (a pending fill aimed at them stays keyed by destination,
        and every launch runs on one stream, so a later fill into a slot
        an in-flight launch reads is ordered after it) and shrink its
        charge to its sign bytes, keeping its LRU position and residency;
        its launch-table row goes back to the plane blocks."""
        tenant, cluster = key
        e = self._entries[key]
        self.bytes_used -= e.nbytes
        self._free.extend(int(b) for b in e.slab_blocks)
        if e.n_rows:
            self._nonempty[tenant] = self._nonempty.get(tenant, 1) - 1
        sign_bytes = (e.slab_blocks.size * self.block_rows
                      * (self.bytes_per_row // 4))
        self._entries[key] = dataclasses.replace(
            e, slab_blocks=np.empty(0, np.int32), nbytes=sign_bytes,
            tier=TIER_SIGN)
        self.bytes_used += sign_bytes
        row = self._tenant_rows.get(tenant)
        if row is not None:
            row[2][cluster] = row[1][cluster]
        self._demotions.inc()
        self.version += 1

    def promote(self, tenant: int, cluster: int, rows) -> np.ndarray | None:
        """Admit a sign-tier resident again at full precision (a re-probe:
        the cluster is hot again)."""
        self._promotions.inc()
        return self.put(tenant, cluster, rows, tier=TIER_FULL)

    def _drop_entry(self, key: tuple[int, int], entry: _SlabEntry) -> None:
        """Return an entry's slots and roll its tenant's combined row back
        to the plane blocks. Pending fills aimed at the freed slots stay
        queued: keyed by destination, a reissued slot overwrites them, and
        a slot that stays free is referenced by no table."""
        tenant, cluster = key
        self.bytes_used -= entry.nbytes
        self._free.extend(int(b) for b in entry.slab_blocks)
        if entry.n_rows and entry.tier == TIER_FULL:
            # `fully_resident` counts full-tier views only: a sign-tier
            # resident has no slab rows for a compact launch.
            self._nonempty[tenant] = self._nonempty.get(tenant, 1) - 1
        clusters = self._by_tenant.get(tenant)
        if clusters is not None:
            clusters.discard(cluster)
        row = self._tenant_rows.get(tenant)
        if row is not None:
            row[2][cluster] = row[1][cluster]

    def fully_resident(self, tenant: int, nonempty_clusters: int) -> bool:
        """Whether all of the tenant's `nonempty_clusters` nonempty views
        are resident (the compact table's precondition)."""
        return self._nonempty.get(tenant, 0) >= nonempty_clusters

    def flush_fills(self) -> None:
        """Apply every queued admission fill in one dispatch, in place.
        Safe to defer: a launch flushes before it builds its table, so a
        slot is written before any table can reference it."""
        if not self._fill_blocks or self._slab_plane is None:
            return
        self._fill_dispatches.inc()
        base_row = self._plane_rows
        base_blk = self._plane_rows // self.block_rows
        rows = sorted(self._fill_rows.items())            # (dst, src)
        blks = sorted(self._fill_blocks.items())          # (slot, (g, c))
        self._fill_rows = {}
        self._fill_blocks = {}
        src_dst = np.asarray([[s for _, s in rows],
                              [d + base_row for d, _ in rows]], np.int64)
        blk = np.asarray([[b + base_blk for b, _ in blks],
                          [g for _, (g, _) in blks],
                          [c for _, (_, c) in blks]], np.int64)
        dev = self._slab_plane.device
        _apply_fills(self._slab_plane, self._inv_norms, self._gid0,
                     self._cnt, upload(src_dst, dev), upload(blk, dev),
                     self._sign)

    def _check_table(self, table: np.ndarray) -> np.ndarray:
        """Every id of a launch table must be a hole (-1) or a block of
        the combined plane: checked here on the host, before the upload,
        since the resident gathers read whatever block an id names."""
        limit = self._plane_rows // self.block_rows + self.num_slab_blocks
        if table.size and (table.min() < -1 or table.max() >= limit):
            raise ValueError(f"slab table ids must lie in [-1, {limit}), "
                             f"got [{table.min()}, {table.max()}]")
        return table

    def _tenant_row(self, tenant: int, host_row: np.ndarray) -> np.ndarray:
        """The tenant's (K, MB) combined-space row: its host plane row with
        every resident cluster's prefix pointing at its slots. Built once
        per table width, then kept in step by put/evict."""
        cached = self._tenant_rows.get(tenant)
        if cached is not None and cached[0] == host_row.shape[1]:
            return cached[2]
        comb_row = host_row.copy()
        base = self._plane_rows // self.block_rows
        for c in self._by_tenant.get(tenant, ()):
            e = self._entries.get((tenant, c))
            if e is not None and e.slab_blocks.size:
                nblk = e.slab_blocks.size
                comb_row[c, :nblk] = e.slab_blocks + base
                # A packed entry may need fewer blocks than the plane
                # table lists: hole the tail so those plane blocks cannot
                # surface its rows again.
                comb_row[c, nblk:] = -1
        self._tenant_rows[tenant] = (host_row.shape[1], host_row.copy(),
                                     comb_row)
        return comb_row

    def combined_table(self, tids: np.ndarray,
                       host_table: np.ndarray) -> torch.Tensor:
        """The launch's (B, K, MB) int32 table on the device: the index's
        plane block table (the ClusterPolicy's) with resident (lane,
        cluster) prefixes pointing into the slab. Cached per (slot-map
        version, tenant tuple)."""
        key = tids.tobytes()
        hit = self._table_cache.get(key)
        if hit is not None and hit[0] == self.version and \
                hit[1] == id(host_table):
            return hit[2]
        comb = host_table.copy()
        for i, t in enumerate(np.asarray(tids).tolist()):
            if t >= 0 and self._by_tenant.get(t):
                comb[i] = self._tenant_row(int(t), host_table[i])
        table = upload(self._check_table(comb), self._slab_plane.device)
        if len(self._table_cache) > 64:
            self._table_cache.clear()
        self._table_cache[key] = (self.version, id(host_table), table)
        return table

    def compact_table(self, tids: np.ndarray, num_clusters: int
                      ) -> tuple[torch.Tensor, int]:
        """The fully resident launch's (B, K, W) table, W the widest
        resident entry's slots (pow2-bucketed): typically narrower than the
        plane table, since packed entries do not straddle blocks. Valid
        only when every batch tenant is `fully_resident`. Cached like the
        full-width table."""
        key = ("compact", tids.tobytes())
        hit = self._table_cache.get(key)
        if hit is not None and hit[0] == self.version:
            return hit[1], hit[2]
        base = self._plane_rows // self.block_rows
        lanes = np.asarray(tids).tolist()
        w = 1
        for t in set(lanes):
            for c in self._by_tenant.get(t, ()):
                w = max(w, self._entries[(t, c)].slab_blocks.size)
        w = _pow2(w)
        comp = np.full((len(lanes), num_clusters, w), -1, np.int32)
        for i, t in enumerate(lanes):
            for c in self._by_tenant.get(t, ()):
                e = self._entries[(t, c)]
                comp[i, c, :e.slab_blocks.size] = e.slab_blocks + base
        table = upload(self._check_table(comp), self._slab_plane.device)
        if len(self._table_cache) > 64:
            self._table_cache.clear()
        self._table_cache[key] = (self.version, table, w)
        return table, w


class ServingRuntime:
    """Deadline-batched, cache-warmed serving loop over a MultiTenantIndex.

    submit() returns a RequestHandle; poll(now) launches every batch that
    is full or past its oldest deadline; flush() drains the queue and
    retires everything. The ledgers accumulate in `engine.SchedulePlan`
    units (exact analytic bytes), split between device memory and the
    cache when the hot-cluster cache serves part of a launch. Every launch
    runs on the index's device, on its current stream.
    """

    def __init__(self, index, cfg: RuntimeConfig | None = None, *,
                 registry=None, tracer=None):
        self.index = index
        self.cfg = cfg or RuntimeConfig()
        # Observability (repro_torch.obs): the null implementations by
        # default, and the derived publications (plan fan-out, energy
        # pricing) skipped unless `registry.enabled`.
        self.registry = NULL_REGISTRY if registry is None else registry
        self.tracer = NULL_TRACER if tracer is None else tracer
        reg = self.registry
        self._m_submitted = reg.counter("serve_requests_submitted")
        self._m_resolved = reg.counter("serve_requests_resolved")
        self._m_launches = reg.counter("serve_launches")
        self._m_deferred_fills = reg.counter("serve_deferred_fill_entries")
        self._m_prefetch_bytes = reg.counter("serve_prefetch_bytes")
        self._m_queue_wait = reg.histogram("serve_queue_wait_seconds")
        self._m_occupancy = reg.histogram("serve_batch_occupancy")
        self._m_launch_wall = reg.histogram("serve_launch_wall_seconds")
        self._m_inflight = reg.gauge("serve_inflight_depth")
        self._m_resolve_lag = reg.histogram("serve_resolve_lag_seconds")
        # The per-stage energy split is sampled every 8th launch; the
        # energy_uj_per_query histogram stays per launch.
        self._m_stage_uj: dict[str, object] = {}
        self._stage_energy_tick = 0
        # `now` is injectable everywhere; once a caller supplies one,
        # calls without it (flush() via result()) reuse the last value so
        # traces stay deterministic.
        self._last_now = 0.0
        self._simulated = False
        self.cache = (HotClusterCache(self.cfg.cache_bytes,
                                      registry=(reg if reg.enabled
                                                else None),
                                      precision_tiers=(
                                          self.cfg.precision_tiers))
                      if self.cfg.cache_bytes > 0 else None)
        self._queues: collections.OrderedDict[
            int, collections.deque[_Pending]] = collections.OrderedDict()
        # Completion queue: dispatched, unresolved launches, oldest first.
        self._inflight: collections.deque[_InFlight] = collections.deque()
        self._num_pending = 0
        self._next_id = 0
        self._seq = 0
        # tenant -> recently probed clusters, most recent first.
        self._recent: dict[int, list[int]] = {}
        # launch signature -> analytic base SchedulePlan.
        self._plan_cache: dict[tuple, engine.SchedulePlan] = {}
        # (arena generation, tids) -> device (B, K) selection validity.
        self._valid_cache: dict[tuple, torch.Tensor] = {}
        # (generation, tenant) -> (packed demand slots, nonempty clusters).
        self._tenant_demand: dict[tuple, tuple[int, int]] = {}
        # -- ledgers (engine.SchedulePlan units, exact bytes) --------------
        self.launches = 0
        self.queries_served = 0
        self.stage1_bytes_streamed = 0    # device-memory bytes, all launches
        self.stage1_bytes_sram = 0        # cache-served bytes, all launches
        self.stage1_bytes_vmapped = 0     # the one-query-at-a-time path
        self.prefetch_bytes = 0           # prior-warming copies
        self.stage_bytes: dict[str, int] = {}       # per stage, device memory
        self.stage_bytes_sram: dict[str, int] = {}  # per stage, cache
        self.last_plan: engine.SchedulePlan | None = None
        # -- the decode ledger (engine.kv_plan units) ----------------------
        self.decode_steps = 0
        self.decode_bytes_hbm = 0
        self.last_decode_plan: engine.SchedulePlan | None = None

    # -- admission ----------------------------------------------------------

    def submit(self, tenant_id: int, query_codes, *,
               deadline: float | None = None,
               now: float | None = None) -> RequestHandle:
        """Enqueue one request; returns its handle. deadline: absolute time
        (the clock of `now`) by which it must be in a launch; defaults to
        now + cfg.max_wait (no deadline when max_wait is 0)."""
        if int(tenant_id) < 0:
            raise ValueError(f"tenant id must be >= 0, got {tenant_id}")
        q = np.asarray(query_codes, np.int8)
        if q.ndim != 1 or q.shape[0] != self.index.arena.dim:
            raise ValueError(f"query must be ({self.index.arena.dim},) int8")
        now = self._clock(now)
        if deadline is None:
            deadline = (now + self.cfg.max_wait if self.cfg.max_wait > 0
                        else math.inf)
        handle = RequestHandle(self, self._next_id, int(tenant_id), deadline)
        self._next_id += 1
        pend = _Pending(handle=handle, query=q, seq=self._seq, submit_ts=now)
        self._seq += 1
        self._queues.setdefault(int(tenant_id), collections.deque()).append(
            pend)
        self._num_pending += 1
        self._m_submitted.inc()
        self.tracer.begin("request", handle.request_id, now=now,
                          tid=int(tenant_id), request=handle.request_id)
        if self.cfg.auto_flush and self._num_pending >= self.cfg.max_batch:
            self._launch(self._form_batch(), now)
        return handle

    def _clock(self, now: float | None) -> float:
        """An explicit `now` switches the runtime to simulated time: later
        calls without one reuse the last value instead of the wall clock."""
        if now is None:
            now = self._last_now if self._simulated else time.monotonic()
        else:
            self._simulated = True
        self._last_now = now
        return now

    def pending(self) -> int:
        return self._num_pending

    def _oldest_deadline(self) -> float | None:
        heads = [q[0].handle.deadline for q in self._queues.values() if q]
        return min(heads) if heads else None

    def ready(self, now: float | None = None) -> bool:
        """Would poll() launch something right now?"""
        if self._num_pending >= self.cfg.max_batch:
            return True
        oldest = self._oldest_deadline()
        if oldest is None:
            return False
        now = time.monotonic() if now is None else now
        return oldest <= now

    def next_deadline(self) -> float | None:
        """When the queue next forces a launch (None if nothing pending
        has a finite deadline)."""
        oldest = self._oldest_deadline()
        return None if oldest is None or math.isinf(oldest) else oldest

    def poll(self, now: float | None = None) -> list[RequestHandle]:
        """Launch every batch that is full or past its oldest deadline and
        retire the launches that landed (`reap`), without blocking.
        Returns the handles this call dispatched."""
        now = self._clock(now)
        launched: list[RequestHandle] = []
        while self._num_pending and self.ready(now):
            launched.extend(self._launch(self._form_batch(), now))
        self.reap()
        return launched

    def flush(self, now: float | None = None) -> list[RequestHandle]:
        """Drain the queue (deadlines ignored) and barrier: on return every
        handle ever dispatched is resolved and all deferred bookkeeping
        has run. Returns the handles this call drained."""
        now = self._clock(now)
        launched: list[RequestHandle] = []
        while self._num_pending:
            launched.extend(self._launch(self._form_batch(), now))
        self.barrier()
        return launched

    def barrier(self) -> int:
        """Retire every in-flight launch (blocking), oldest first; returns
        how many. Afterwards every ledger is final."""
        n = 0
        while self._inflight:
            self._retire(self._inflight.popleft())
            n += 1
        return n

    def reap(self) -> int:
        """Retire the launches that landed, oldest first, stopping at the
        first still running; returns how many."""
        n = 0
        while self._inflight and self._inflight[0].is_ready():
            self._retire(self._inflight.popleft())
            n += 1
        return n

    def in_flight(self) -> int:
        """Dispatched launches not yet resolved."""
        return len(self._inflight)

    def _retire_through(self, target: _InFlight) -> None:
        """Retire the queue head through `target` inclusive."""
        while self._inflight:
            infl = self._inflight.popleft()
            self._retire(infl)
            if infl is target:
                return

    def _retire(self, infl: _InFlight) -> None:
        """Resolve one launch: one read back of its three result tensors
        (blocking if still running), per-lane views handed out, request
        spans closed, then its deferred bookkeeping, in dispatch order."""
        res = infl.res
        k = res.indices.shape[1]
        out = torch.cat([res.indices, res.scores, res.candidate_indices],
                        dim=1).cpu()
        self._m_resolve_lag.observe(
            max(0.0, time.monotonic() - infl.dispatch_t))
        for i, req in enumerate(infl.group):
            req.handle._result = RetrievalResult(
                indices=out[i, :k], scores=out[i, k:2 * k],
                candidate_indices=out[i, 2 * k:])
            req.handle._inflight = None
            self._m_queue_wait.observe(
                max(0.0, infl.admit_now - req.submit_ts))
            self.tracer.end(req.handle.request_id, now=infl.admit_now,
                            request=req.handle.request_id,
                            launch=infl.launch_index)
        self._m_resolved.inc(len(infl.group))
        if infl.book is not None:
            infl.book()
        self._m_inflight.set(float(len(self._inflight)))

    def _form_batch(self) -> list[_Pending]:
        """Pick up to max_batch pending requests: fifo in arrival order;
        deadline_rr one request per tenant per pass, tenants ordered by
        their head request's deadline (FIFO within a tenant)."""
        group: list[_Pending] = []
        if self.cfg.fairness == "fifo":
            # k-way merge of the per-tenant queues by arrival seq.
            heads = [(q[0].seq, t) for t, q in self._queues.items() if q]
            heapq.heapify(heads)
            while len(group) < self.cfg.max_batch and heads:
                _, tid = heapq.heappop(heads)
                group.append(self._pop_from(tid))
                queue = self._queues.get(tid)
                if queue:
                    heapq.heappush(heads, (queue[0].seq, tid))
        else:
            order = sorted(
                (t for t, q in self._queues.items() if q),
                key=lambda t: (self._queues[t][0].handle.deadline,
                               self._queues[t][0].seq))
            while len(group) < self.cfg.max_batch:
                progressed = False
                for tid in order:
                    if len(group) >= self.cfg.max_batch:
                        break
                    if self._queues.get(tid):
                        group.append(self._pop_from(tid))
                        progressed = True
                if not progressed:
                    break
        return group

    def _pop_from(self, tid: int) -> _Pending:
        """Pop a tenant's head request; drop its queue once drained."""
        queue = self._queues[tid]
        pend = queue.popleft()
        self._num_pending -= 1
        if not queue:
            del self._queues[tid]
        return pend

    # -- launching ----------------------------------------------------------

    def _launch(self, group: list[_Pending],
                now: float | None = None) -> list[RequestHandle]:
        """Dispatch one batch and put it on the completion queue; with more
        than async_depth launches in flight, retire the oldest (blocking),
        so async_depth = 0 resolves the launch before returning."""
        b = len(group)
        if b == 0:
            return []
        now = self._clock(now)
        pb = _pow2(b)
        queries = np.zeros((pb, self.index.arena.dim), np.int8)
        tids = np.full((pb,), NO_TENANT, np.int32)
        for i, req in enumerate(group):
            queries[i] = req.query
            tids[i] = req.handle.tenant_id
            req.handle.launch_index = self.launches
            self.tracer.instant("admit", now=now, tid=req.handle.tenant_id,
                                request=req.handle.request_id,
                                launch=self.launches)
        t0 = time.monotonic()
        with self.tracer.span("launch", now=now, batch=b, padded=pb,
                              index=self.launches):
            res, plan, book = self._execute(queries, tids)
        done = None
        if res.indices.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(res.indices.device))
        self._m_launch_wall.observe(time.monotonic() - t0)
        self._m_launches.inc()
        self._m_occupancy.observe(float(b))
        self.launches += 1
        self.queries_served += b
        if plan is not None:
            self._account_plan(plan, b)
        infl = _InFlight(group=group, res=res, launch_index=self.launches - 1,
                         admit_now=now, dispatch_t=time.monotonic(),
                         book=book, done=done)
        for req in group:
            req.handle._inflight = infl
        self._inflight.append(infl)
        self._m_inflight.set(float(len(self._inflight)))
        while len(self._inflight) > self.cfg.async_depth:
            self._retire(self._inflight.popleft())
        return [req.handle for req in group]

    def _account_plan(self, plan: engine.SchedulePlan, b: int) -> None:
        """Fold one launch's plan into the ledgers (at dispatch for the
        uncached path, in the deferred bookkeeping for the cached one;
        either way in launch order)."""
        self.last_plan = plan
        # stage1_bytes counts what the launch streamed, padding lanes
        # included; the one-query-at-a-time comparison only the b real
        # requests.
        self.stage1_bytes_streamed += plan.stage1_bytes
        self.stage1_bytes_sram += plan.stage1_bytes_sram
        self.stage1_bytes_vmapped += (
            plan.stage1_bytes_vmapped // plan.batch) * b
        for s in plan.stages:
            self.stage_bytes[s.name] = (
                self.stage_bytes.get(s.name, 0) + s.bytes_hbm)
            if s.bytes_sram:
                self.stage_bytes_sram[s.name] = (
                    self.stage_bytes_sram.get(s.name, 0) + s.bytes_sram)
        if self.registry.enabled:
            plan.publish(self.registry)
            dim = self.index.arena.dim
            energy.observe_cost(
                self.registry,
                energy.cost_cascade(plan.stages, dim, batch=plan.batch),
                queries=b)
            self._stage_energy_tick += 1
            if (self._stage_energy_tick - 1) % 8 == 0:
                for s in plan.stages:
                    h = self._m_stage_uj.get(s.name)
                    if h is None:
                        h = self._m_stage_uj[s.name] = self.registry.histogram(
                            "energy_uj_per_query_stage", stage=s.name)
                    h.observe(energy.stage_cost_uj(s, dim, batch=plan.batch),
                              b)

    def _execute(self, queries: np.ndarray, tids: np.ndarray
                 ) -> tuple[RetrievalResult, engine.SchedulePlan | None,
                            Callable[[], None] | None]:
        """Dispatch one batch: (result tensors, plan if known, deferred
        bookkeeping). The uncached plan is analytic; the cached path's
        plan needs the selection read back and lands in `book`."""
        if self.cache is not None:
            layout = self.index.cluster_layout(tids)
            if layout is not None:
                return self._execute_cached(queries, tids, *layout)
        res = self.index.retrieve(upload(queries, self.index.device), tids)
        return res, self.index.last_plan, None

    # -- the hot-cluster-cache path -----------------------------------------

    def _warm_from_prior(self, tids: np.ndarray) -> int:
        """Copy each batch tenant's recently probed clusters into the slab
        (refreshing the ones still resident); returns the bytes copied,
        which the launch is charged as device-memory traffic."""
        bytes_fetched = 0
        for t in set(int(x) for x in tids.tolist()):
            if t < 0:
                continue
            recent = self._recent.get(t)
            if not recent:
                continue
            rows_of = self.index.cluster_rows(t)
            for c in recent:
                if self.cache.peek(t, c):
                    self.cache.touch(t, c)
                    continue
                slots = self.cache.put(t, c, rows_of.get(c, ()))
                if slots is None:
                    continue          # oversized: stays streamed
                bytes_fetched += len(slots) * self.cache.block_rows * \
                    self.cache.bytes_per_row
        return bytes_fetched

    def _preload_tenants(self, tids: np.ndarray) -> tuple[int, bool]:
        """Pin every batch tenant's cluster set into the slab when the
        batch's packed demand fits the budget together. Returns (bytes
        copied, every batch tenant fully resident) — residency checked
        after all admissions, since a later tenant's puts may evict an
        earlier one's entries."""
        cache = self.cache
        br = cache.block_rows
        gen = self.index.arena.generation
        tenants = sorted({int(x) for x in tids.tolist() if x >= 0})
        demand = 0
        stats = {}
        for t in tenants:
            key = (gen, t)
            st = self._tenant_demand.get(key)
            if st is None:
                rows_of = self.index.cluster_rows(t)
                st = (sum(cache.entry_blocks(r, br)
                          for r in rows_of.values()),
                      sum(1 for r in rows_of.values() if r.size))
                if len(self._tenant_demand) > 4096:
                    self._tenant_demand.clear()
                self._tenant_demand[key] = st
            stats[t] = st
            demand += st[0]
        if demand * br * cache.bytes_per_row > cache.budget_bytes:
            return 0, False
        bytes_fetched = 0
        for t in tenants:
            if cache.fully_resident(t, stats[t][1]):
                continue
            for c, rows in self.index.cluster_rows(t).items():
                if cache.peek(t, c):
                    continue
                slots = cache.put(t, c, rows)
                if slots is not None:
                    bytes_fetched += len(slots) * br * cache.bytes_per_row
        resident = all(cache.fully_resident(t, stats[t][1])
                       for t in tenants)
        return bytes_fetched, resident

    def _cluster_valid(self, tids: np.ndarray,
                       host_table: np.ndarray) -> torch.Tensor:
        """The (B, K) selection validity (the plane table's first block
        >= 0) on the device, cached per (arena generation, tenant tuple)."""
        key = (self.index.arena.generation, tids.tobytes())
        hit = self._valid_cache.get(key)
        if hit is not None:
            return hit
        if len(self._valid_cache) > 64:
            self._valid_cache.clear()
        valid = upload(host_table[:, :, 0] >= 0, self.index.device)
        self._valid_cache[key] = valid
        return valid

    def _execute_cached(self, queries: np.ndarray, tids: np.ndarray,
                        policy: engine.ClusterPolicy,
                        host_table: np.ndarray
                        ) -> tuple[RetrievalResult, None,
                                   Callable[[], None]]:
        """One launch through the slab path.

        At dispatch: pin the slab to the arena generation, warm the session
        (the priors, or the preload), apply the queued fills, take the
        compact table when every batch tenant is resident (else the
        full-width one; both cached per slot-map version) and launch the
        cascade with a `SlabPolicy`. Nothing here reads the card back: the
        (B, nprobe) selection that the hit/miss ledger, the LRU, the miss
        admissions and the session prior need is read in `book`, run at
        retire time in launch order. Pipelined launches therefore warm
        from priors up to `async_depth` launches old, which moves only
        where bytes come from, never what is scored."""
        index = self.index
        db = index.arena.db()
        cache = self.cache
        br = policy.block_rows
        d2 = db.msb_plane.shape[1]
        num_docs, dim = db.num_docs, db.dim
        k_clusters = policy.centroid_msb.shape[0]
        cache.configure(br, d2)
        if (self._inflight
                and cache.generation != index.arena.generation):
            # The arena mutated: retire what was dispatched against the old
            # generation first, so its bookkeeping reads the slot map its
            # launches encoded.
            self.barrier()
        cache.sync_generation(index.arena.generation)
        cache.ensure_slab(db.msb_plane, db.norms_sq, policy.owner,
                          policy.labels, k_clusters)
        compact = False
        prefetched = 0
        if self.cfg.preload:
            prefetched, compact = self._preload_tenants(tids)
        if not compact:
            prefetched += self._warm_from_prior(tids)
        # One fill dispatch per launch, before any table references the
        # slots.
        cache.flush_fills()
        if compact:
            slab_blocks, width = cache.compact_table(tids, k_clusters)
            if min(policy.nprobe, k_clusters) * width * br < index.cfg.k:
                compact = False     # too narrow to hold k: full width
        if not compact:
            slab_blocks = cache.combined_table(tids, host_table)
        prescreen = (index.cfg.prescreen_c0 is not None
                     and index.arena.dim % 8 == 0)
        spolicy = engine.SlabPolicy(
            packed_labels=cache.packed_labels,
            tenant_ids=policy.tenant_ids, centroid_msb=policy.centroid_msb,
            centroid_norms=policy.centroid_norms,
            cluster_valid=self._cluster_valid(tids, host_table),
            slab_blocks=slab_blocks, block_gid0=cache.block_gid0,
            block_count=cache.block_count, slab_plane=cache.slab_plane,
            inv_norms=cache.inv_norms, nprobe=policy.nprobe, block_rows=br,
            sign_plane=(cache.sign_plane if prescreen else None),
            block_tier=(cache.block_tier if cache.precision_tiers
                        else None))
        res, top_clusters = index.engine.retrieve_with_clusters(
            upload(queries, self.index.device), db, spolicy)
        del db              # no view of the arena outlives the dispatch
        arena_gen = index.arena.generation
        b_real = int((tids >= 0).sum())
        probe_rows = engine.probe_rows(spolicy)
        c0 = (index.cfg.prescreen_budget(probe_rows) if prescreen
              else None)

        def book() -> None:
            # Admissions run after the whole hit/miss loop, so the ledger
            # reads the slot map as of retire time; with a barrier per
            # turn that is the map the launch's table encoded.
            tc = top_clusters.cpu().numpy()
            bsz = tc.shape[0]
            block_bytes = br * d2
            sign_block_bytes = br * (d2 // 4)   # 1-bit vs 4-bit rows
            tiers = cache.precision_tiers
            hit_bytes = miss_bytes = 0
            ps_sram = ps_hbm = 0      # stage-0 sign-byte split
            # A mutation between dispatch and retire means cluster_rows
            # now describes another arena: admit nothing (the next cached
            # dispatch drops the slab anyway).
            stale = index.arena.generation != arena_gen
            to_admit: dict[tuple[int, int], int] = {}
            to_promote: dict[tuple[int, int], int] = {}
            for i in range(bsz):
                t = int(tids[i])
                if t < 0:
                    continue                  # padding lane
                row_table = host_table[i]
                probes = tc[i].tolist()
                if tiers:
                    (lane_full, lane_sign, sign_hits,
                     missing) = cache.lookup_lane_tiers(t, probes)
                    hit_bytes += lane_full
                    if c0 is not None:
                        # Resident probes serve stage 0 from the cache: a
                        # full entry's sign bytes are 1/4 of its charge, a
                        # sign entry's charge is its sign bytes.
                        ps_sram += lane_full // 4 + lane_sign
                    for c in sign_hits:
                        key = (t, c)
                        if key not in to_promote:
                            to_promote[key] = int((row_table[c] >= 0).sum())
                        # no slab rows: stage 1 streamed the plane blocks
                        miss_bytes += to_promote[key] * block_bytes
                else:
                    lane_hit, missing = cache.lookup_lane(t, probes)
                    hit_bytes += lane_hit
                    if c0 is not None:
                        ps_sram += lane_hit // 4
                for c in missing:
                    key = (t, c)
                    if key not in to_admit:
                        to_admit[key] = int((row_table[c] >= 0).sum())
                    # a miss streamed the cluster's plane blocks
                    miss_bytes += to_admit[key] * block_bytes
                    if c0 is not None:
                        ps_hbm += to_admit[key] * sign_block_bytes
            if (to_admit or to_promote) and not stale:
                self._m_deferred_fills.inc(len(to_admit) + len(to_promote))
                for (t, c) in to_admit:
                    # Under tiers a first contact admits at 1 bit; a
                    # re-probe promotes to full (its plane bytes charged
                    # once, above, as the miss it replaces).
                    cache.put(t, c, index.cluster_rows(t).get(c, ()),
                              tier=(TIER_SIGN if tiers else TIER_FULL))
                for (t, c) in to_promote:
                    cache.promote(t, c, index.cluster_rows(t).get(c, ()))
            pkey = (num_docs, dim, bsz, k_clusters, probe_rows)
            base = self._plan_cache.get(pkey)
            if base is None:
                if len(self._plan_cache) > 256:
                    self._plan_cache.clear()
                base = engine.plan(index.cfg, num_docs=num_docs, dim=dim,
                                   batch=bsz, kind="cluster",
                                   num_clusters=k_clusters,
                                   view_rows=probe_rows)
                self._plan_cache[pkey] = base
            approx_hbm = miss_bytes + prefetched
            approx_sram = hit_bytes
            if c0 is not None and probe_rows:
                # A prescreened stage 1 reads only the C0 survivors: prorate
                # the cluster-level split by the survivor fraction. Warming
                # copies are whole clusters, charged in full.
                frac = min(1.0, c0 / probe_rows)
                approx_hbm = int(miss_bytes * frac) + prefetched
                approx_sram = int(hit_bytes * frac)
            plan = engine.cache_split_plan(
                base, hbm_bytes=approx_hbm, sram_bytes=approx_sram,
                prescreen_hbm=(ps_hbm if c0 is not None else None),
                prescreen_sram=ps_sram)
            self.prefetch_bytes += prefetched
            self._m_prefetch_bytes.inc(prefetched)
            index.last_plan = plan
            self._account_plan(plan, b_real)
            # Refresh each tenant's session prior with the clusters this
            # turn probed (most recent first, bounded). Compact launches
            # skip it: the preload pins the whole session.
            if self.cfg.prior_clusters and not compact:
                for i in range(bsz):
                    t = int(tids[i])
                    if t < 0:
                        continue
                    fresh = list(dict.fromkeys(int(c) for c in tc[i]))
                    old = [c for c in self._recent.get(t, [])
                           if c not in fresh]
                    self._recent[t] = (fresh + old)[:self.cfg.prior_clusters]

        return res, None, book

    # -- reporting ----------------------------------------------------------

    def cache_stats(self) -> dict:
        self.barrier()    # stats are as of the last retired launch
        if self.cache is None:
            return {"enabled": False}
        return {"enabled": True, "entries": len(self.cache),
                "bytes_used": self.cache.bytes_used,
                "budget_bytes": self.cache.budget_bytes,
                "slab_blocks": self.cache.num_slab_blocks,
                "slab_blocks_used": (self.cache.num_slab_blocks
                                     - len(self.cache._free)),
                **self.cache.snapshot()}

    def energy_ledger(self, dim: int | None = None):
        """cost_cascade of the most recent launch's plan."""
        self.barrier()    # the cached path's plan lands at retire time
        if self.last_plan is None:
            raise RuntimeError("no launch has run yet")
        return energy.cost_cascade(self.last_plan.stages,
                                   dim or self.index.arena.dim,
                                   batch=self.last_plan.batch)

    # -- decode accounting --------------------------------------------------

    def account_decode(self, plan: engine.SchedulePlan, *, dim: int,
                       tokens: int = 1):
        """Charge a decode run's KV-cascade ledger to this runtime.

        `plan` is one decode step's `engine.kv_plan` (kind "decode");
        `tokens` scales it to the run (the stages are the same every step
        at a fixed cache length). The scaled ledger fans out through the
        same `SchedulePlan.publish` counters as retrieval launches, and
        the per-token cost lands in the `energy_uj_per_token` histogram.
        Returns the per-token CostBreakdown."""
        if plan.kind != "decode":
            raise ValueError(f"account_decode wants a kind='decode' plan, "
                             f"got {plan.kind!r}")
        scaled = dataclasses.replace(
            plan,
            stages=tuple(dataclasses.replace(
                s, bytes_hbm=s.bytes_hbm * tokens,
                bytes_sram=s.bytes_sram * tokens,
                compares=s.compares * tokens) for s in plan.stages),
            stage1_bytes=plan.stage1_bytes * tokens,
            stage1_bytes_vmapped=plan.stage1_bytes_vmapped * tokens,
            stage2_bytes=plan.stage2_bytes * tokens)
        self.decode_steps += tokens
        self.decode_bytes_hbm += sum(s.bytes_hbm for s in scaled.stages)
        self.last_decode_plan = plan
        cost = energy.cost_cascade(plan.stages, dim, batch=plan.batch)
        if self.registry.enabled:
            scaled.publish(self.registry)
            energy.observe_decode_cost(self.registry, cost, tokens=tokens)
        return cost
