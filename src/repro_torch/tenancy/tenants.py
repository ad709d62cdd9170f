"""Tenant table + the multi-tenant index facade.

Port of `repro.tenancy.tenants`. `TenantTable` is pure host-side metadata:
tenant_id -> the arena slots the tenant owns (insertion order preserved)
plus the derived contiguous row-slot segments. The device-side source of
truth for query masking is the arena's `owner` tensor — the table exists
for allocation accounting, compaction ordering (rows regrouped per tenant
so each tenant is one contiguous segment afterwards) and diagnostics.

`MultiTenantIndex` glues arena + table into the object a server holds:
ingest (quantize + pack into free slots), delete (tombstone), compact
(repack + remap) and retrieve (one batched cascade launch over the shared
slab for a mixed batch of tenants), all on one device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device, upload
from repro_torch.core import clustering, engine, retrieval
from repro_torch.tenancy.arena import Arena, _as_tensor


class TenantTable:
    """tenant_id -> live arena slots (and their contiguous segments)."""

    def __init__(self):
        self._slots: dict[int, list[int]] = {}
        self._segments: dict[int, list[tuple[int, int]]] = {}  # cache

    def add(self, tenant_id: int) -> None:
        self._slots.setdefault(int(tenant_id), [])

    @property
    def tenant_ids(self) -> list[int]:
        return sorted(self._slots)

    def slots(self, tenant_id: int) -> list[int]:
        return list(self._slots.get(int(tenant_id), ()))

    def num_docs(self, tenant_id: int) -> int:
        return len(self._slots.get(int(tenant_id), ()))

    def record_insert(self, tenant_id: int, slots) -> None:
        self.add(tenant_id)
        self._slots[int(tenant_id)].extend(int(s) for s in np.atleast_1d(slots))
        self._segments.pop(int(tenant_id), None)

    def record_delete(self, tenant_id: int, slots) -> None:
        dead = {int(s) for s in np.atleast_1d(slots)}
        mine = self._slots.get(int(tenant_id))
        if mine is None or not dead <= set(mine):
            raise KeyError(f"tenant {tenant_id} does not own slots "
                           f"{sorted(dead - set(mine or ()))}")
        self._slots[int(tenant_id)] = [s for s in mine if s not in dead]
        self._segments.pop(int(tenant_id), None)

    def segments(self, tenant_id: int) -> list[tuple[int, int]]:
        """The tenant's slots as sorted half-open [start, stop) runs.

        Cached per tenant (invalidated by inserts/deletes/remaps): the
        batched query path reads this on every request."""
        tenant_id = int(tenant_id)
        cached = self._segments.get(tenant_id)
        if cached is not None:
            return cached
        slots = sorted(self._slots.get(tenant_id, ()))
        runs: list[tuple[int, int]] = []
        for s in slots:
            if runs and runs[-1][1] == s:
                runs[-1] = (runs[-1][0], s + 1)
            else:
                runs.append((s, s + 1))
        self._segments[tenant_id] = runs
        return runs

    def compaction_order(self, cluster_labels=None) -> np.ndarray:
        """Live slots grouped by tenant — compacting in this order leaves
        every tenant as ONE contiguous segment.

        cluster_labels: optional (capacity,) slot -> cluster map; when
        given, each tenant's slots are additionally grouped by cluster,
        so every (tenant, cluster) pair lands in a contiguous run — the
        layout that makes the cascade's selected clusters dense block
        gathers. Tenant contiguity (the windowed fast path's invariant)
        is preserved either way."""
        if cluster_labels is None:
            order = [s for t in self.tenant_ids for s in self._slots[t]]
        else:
            lab = np.asarray(cluster_labels)
            order = [s for t in self.tenant_ids
                     for s in sorted(self._slots[t],
                                     key=lambda sl: (lab[sl], sl))]
        return np.asarray(order, np.int64)

    def remap(self, mapping: np.ndarray) -> None:
        """Apply a compaction's old->new slot mapping."""
        for t, slots in self._slots.items():
            moved = [int(mapping[s]) for s in slots]
            if any(m < 0 for m in moved):
                raise ValueError(f"compaction dropped live slots of tenant {t}")
            self._slots[t] = moved
        self._segments.clear()


class MultiTenantIndex:
    """Shared-arena index serving many per-user corpora on one device.

    One retrieval config serves every tenant; per-request tenant ids
    select the segments. `device` (the CUDA device unless
    ``device="cpu"``) holds the arena, the engine and the codebook.
    """

    def __init__(self, capacity: int, dim: int,
                 cfg: retrieval.RetrievalConfig | None = None,
                 *, scale: float | None = None,
                 clusters: clustering.ClusterParams | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.arena = Arena(capacity, dim, scale=scale, device=self.device)
        self.table = TenantTable()
        self.cfg = cfg or retrieval.RetrievalConfig()
        self._engine = engine.RetrievalEngine(self.cfg, self.device)
        # Optional cluster-pruned cascade: an online-maintained codebook
        # labels every ingested row; batched retrieves then run the
        # 3-stage cascade (centroid prune -> gathered INT4 scan -> exact
        # rescore) instead of scanning the whole arena.
        self.cluster_params = clusters
        if clusters is not None and capacity % clusters.block_rows:
            # A partial tail block would leave the gather a ragged plane;
            # insist the block size tiles the arena.
            raise ValueError(
                f"block_rows {clusters.block_rows} must divide arena "
                f"capacity {capacity} (keeps the block-gather kernel's "
                f"plane un-padded on the query hot path)")
        self.clusters = (clustering.ClusterIndex(
            clusters.num_clusters, dim, seed=clusters.seed,
            iters=clusters.kmeans_iters, device=self.device)
            if clusters is not None else None)
        # Analytic SchedulePlan of the most recent retrieve() launch.
        self.last_plan: engine.SchedulePlan | None = None
        # (arena generation, tenant-id bytes) -> windowed layout /
        # ClusterPolicy / None; a server re-issues the same tenant
        # groupings between mutations. Entries from older arena
        # generations are dead weight (cluster entries pin capacity-sized
        # device buffers), so the cache is dropped wholesale whenever the
        # arena mutates — see _layout_cache_for_generation.
        self._layout_cache: dict = {}
        self._layout_cache_gen = -1

    # -- ingestion / deletion ------------------------------------------------

    def ingest(self, tenant_id: int, embeddings) -> np.ndarray:
        """Online-ingest (B, D) float embeddings for one tenant.

        Quantizes under the arena's fixed scale and packs into free slots —
        no rebuild of existing rows. Returns assigned slot ids (B,)."""
        return self.ingest_codes(tenant_id, self.arena.quantize(embeddings))

    def ingest_codes(self, tenant_id: int, codes) -> np.ndarray:
        slots = self.arena.insert(codes, int(tenant_id))
        self.table.record_insert(tenant_id, slots)
        if self.clusters is not None:
            # Assign the new rows online (trains the codebook on the very
            # first batch) and label the slots. The codebook's running
            # sums live on the host, so the codes are copied there; a
            # failed insert above never reaches the sums.
            labels = self.clusters.add(_host_codes(codes))
            self.arena.set_labels(slots, labels)
        return slots

    def delete(self, tenant_id: int, slots) -> None:
        """Tombstone a tenant's documents (checked against ownership)."""
        self.table.record_delete(tenant_id, slots)
        if self.clusters is not None:
            sl = np.unique(np.atleast_1d(np.asarray(slots, np.int64)))
            labels = self.arena.cluster_labels[sl]
            live = labels >= 0
            if live.any():
                codes = self.arena.read_codes(sl[live])
                self.clusters.remove(_host_codes(codes), labels[live])
        self.arena.delete(slots)

    def compact(self) -> np.ndarray:
        """Reclaim tombstones; returns old->new slot mapping (-1 = dead).

        With clustering enabled the repack order groups each tenant's
        rows by cluster (tenant contiguity preserved), and the codebook
        refreshes from its running sums — no corpus re-read."""
        labels = (self.arena.cluster_labels if self.clusters is not None
                  else None)
        mapping = self.arena.compact(self.table.compaction_order(labels))
        self.table.remap(mapping)
        if self.clusters is not None:
            self.clusters.refresh()
        return mapping

    # -- query ---------------------------------------------------------------

    @property
    def engine(self) -> engine.RetrievalEngine:
        """The index's RetrievalEngine, re-keyed if `cfg` was replaced."""
        if self._engine.cfg != self.cfg:
            self._engine = engine.RetrievalEngine(self.cfg, self.device)
        return self._engine

    def _layout_cache_for_generation(self) -> dict:
        """The layout cache, valid for the CURRENT arena generation only:
        every mutation invalidates all cached layouts."""
        if self._layout_cache_gen != self.arena.generation:
            self._layout_cache.clear()
            self._layout_cache_gen = self.arena.generation
        return self._layout_cache

    def _on_device(self, arr: np.ndarray) -> torch.Tensor:
        return upload(np.asarray(arr, np.int32), self.device)

    def _contiguous_layout(self, tenant_ids
                           ) -> tuple[torch.Tensor, torch.Tensor, int] | None:
        """(per-lane segment starts, tenant ids, pow2 window) when every
        requested tenant is ONE contiguous slot run; None when fragmented
        (then only the full-arena masked scan is correct). Cached per
        (arena generation, cfg, tenant-id tuple) — cfg is part of the key
        because the window floor depends on cfg.k."""
        cache = self._layout_cache_for_generation()
        key = (self.cfg, tenant_ids.tobytes())
        if key in cache:
            return cache[key]
        # window >= k keeps the in-window candidate budget well-posed even
        # for tenants holding fewer than k docs (lanes pad with -1).
        starts, longest = [], max(1, self.cfg.k)
        layout = None
        for t in tenant_ids:
            segs = self.table.segments(int(t))
            if len(segs) > 1:
                break
            start, stop = segs[0] if segs else (0, 0)
            starts.append(start)
            longest = max(longest, stop - start)
        else:
            window = 1 << (longest - 1).bit_length()  # pow2 buckets
            if window < self.arena.capacity:          # else: full scan
                layout = (self._on_device(starts),
                          self._on_device(tenant_ids), window)
        if len(cache) > 512:          # many distinct tid tuples backstop
            cache.clear()
        cache[key] = layout
        return layout

    def _cluster_layout(self, tids_host
                        ) -> tuple[engine.ClusterPolicy, np.ndarray] | None:
        """The batch's (ClusterPolicy, host block table): per-LANE block
        tables listing, for each cluster, the arena blocks holding that
        (tenant, cluster)'s rows. Correct for ANY layout (fresh tail
        inserts and fragmented tenants just list more blocks); after
        cluster-grouped compaction each entry is a dense run. None when
        clustering is off/untrained or the gathered view could not hold k
        rows. Cached for the current arena generation per (codebook
        generation, cfg, tenant-id tuple)."""
        if self.clusters is None or not self.clusters.trained:
            return None
        params = self.cluster_params
        cache = self._layout_cache_for_generation()
        key = ("cluster", self.clusters.generation, self.cfg,
               tids_host.tobytes())
        if key in cache:
            return cache[key]
        labels = self.arena.cluster_labels
        br = params.block_rows
        k_clusters = self.clusters.num_clusters
        tables = {}
        for t in np.unique(tids_host):
            if t < 0:
                continue
            # restricted to the tenant's own slots: O(S log S) in the
            # tenant's rows, not O(capacity)
            tables[int(t)] = clustering.block_table(
                labels, k_clusters, br, pad_pow2=False,
                rows=np.asarray(self.table.slots(int(t)), np.int64))
        mb = max((t.shape[1] for t in tables.values()), default=1)
        mb = 1 << (mb - 1).bit_length()      # pow2 buckets
        nprobe = min(params.nprobe, k_clusters)
        layout = None
        # The prune must BUY something: when fragmentation inflates the
        # per-lane gathered view to arena size (many interleaved
        # single-doc ingests before a compact), the windowed/masked scan
        # is the cheaper launch — fall back until compact() re-densifies.
        # The lower bound keeps the in-view top-k well-posed.
        if max(1, self.cfg.k) <= nprobe * mb * br < self.arena.capacity:
            table = np.full((len(tids_host), k_clusters, mb), -1, np.int32)
            for i, t in enumerate(tids_host):
                if int(t) in tables:
                    per = tables[int(t)]
                    table[i, :, :per.shape[1]] = per
            cb = self.clusters.codebook()
            policy = engine.ClusterPolicy(
                owner=self.arena.owner,
                tenant_ids=self._on_device(tids_host),
                labels=self._on_device(labels),
                centroid_msb=cb.msb_plane, centroid_norms=cb.norms_sq,
                cluster_blocks=self._on_device(table),
                nprobe=nprobe, block_rows=br)
            layout = (policy, table)
        if len(cache) > 512:          # many distinct tid tuples backstop
            cache.clear()
        cache[key] = layout
        return layout

    def cluster_rows(self, tenant: int) -> dict[int, np.ndarray]:
        """Host-side per-cluster row ids of one tenant, each ASCENDING —
        the exact rows (and row order) that cluster's view streams in the
        batched cascade. Cached per (arena generation, codebook
        generation, tenant); empty dict when clustering is off/untrained.
        """
        if self.clusters is None or not self.clusters.trained:
            return {}
        cache = self._layout_cache_for_generation()
        key = ("cluster_rows", self.clusters.generation, int(tenant))
        if key in cache:
            return cache[key]
        out: dict[int, np.ndarray] = {}
        slots = np.sort(np.asarray(self.table.slots(int(tenant)), np.int64))
        if slots.size:
            labs = np.asarray(self.arena.cluster_labels)[slots]
            order = np.argsort(labs, kind="stable")   # rows stay ascending
            labs, rows = labs[order], slots[order].astype(np.int32)
            bounds = np.flatnonzero(np.diff(labs)) + 1
            for lab, grp in zip(labs[np.r_[0, bounds]] if labs.size else (),
                                np.split(rows, bounds)):
                if lab >= 0:
                    out[int(lab)] = grp
        if len(cache) > 512:
            cache.clear()
        cache[key] = out
        return out

    def cluster_policy(self, tenant_ids) -> engine.ClusterPolicy | None:
        """The ClusterPolicy a batched retrieve for `tenant_ids` would run
        (None when clustering is off/untrained or the prune would not beat
        the windowed/masked scan)."""
        layout = self.cluster_layout(tenant_ids)
        return None if layout is None else layout[0]

    def cluster_layout(self, tenant_ids
                       ) -> tuple[engine.ClusterPolicy, np.ndarray] | None:
        """The (ClusterPolicy, host-side (B, K, MB) np block table) a
        batched retrieve for `tenant_ids` would run; the host table
        mirrors `policy.cluster_blocks`, so a caller reads it without a
        device sync."""
        tids_host = np.atleast_1d(np.asarray(tenant_ids, np.int32))
        return self._cluster_layout(tids_host)

    def retrieve(self, query_codes, tenant_ids) -> retrieval.RetrievalResult:
        """Per-tenant retrieval; single query or mixed cross-tenant batch.

        Chooses the engine POLICY host-side and hands the batch to the one
        batched cascade: with clustering enabled a batch runs the
        cluster-pruned cascade (each lane streams only its top-nprobe
        clusters' blocks); otherwise it takes the windowed fast path (each
        lane streams only its tenant's contiguous segment) whenever the
        layout allows — after interleaved ingests fragment a tenant, it
        falls back to the full-arena masked scan until compact() restores
        contiguity. A (D,) query runs the masked policy as a B=1 lane. The
        launch's analytic SchedulePlan lands in `self.last_plan`.
        """
        query_codes = _as_tensor(query_codes, self.device)
        db = self.arena.db()
        if query_codes.ndim == 1:
            if int(tenant_ids) < 0:
                raise ValueError(f"tenant id must be >= 0, got {tenant_ids}")
            policy = engine.MaskedPolicy(
                owner=self.arena.owner,
                tenant_ids=self._on_device([int(tenant_ids)]))
            self.last_plan = self.engine.plan_for(db, 1, policy)
            return self.engine.retrieve_single(query_codes, db, policy)
        tids_host = np.atleast_1d(np.asarray(tenant_ids, np.int32))
        # Negative ids are sentinels (-1 = FREE/tombstone owner, -2 =
        # NO_TENANT padding); only the padding sentinel may be queried —
        # anything else negative is a caller bug that must not match rows.
        bad = tids_host[(tids_host < 0) & (tids_host != retrieval.NO_TENANT)]
        if bad.size:
            raise ValueError("tenant ids must be >= 0 (or NO_TENANT for "
                             f"padding lanes), got {bad.tolist()}")
        layout = self._cluster_layout(tids_host)
        policy = None if layout is None else layout[0]
        if policy is None:
            layout = self._contiguous_layout(tids_host)
            if layout is not None:
                starts, tids, window = layout
                policy = engine.WindowedPolicy(owner=self.arena.owner,
                                               tenant_ids=tids,
                                               starts=starts, window=window)
            else:
                policy = engine.MaskedPolicy(
                    owner=self.arena.owner,
                    tenant_ids=self._on_device(tids_host))
        self.last_plan = self.engine.plan_for(db, len(tids_host), policy)
        return self.engine.retrieve(query_codes, db, policy)

    # -- introspection -------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.arena.capacity

    @property
    def num_live(self) -> int:
        return self.arena.num_live

    def utilization(self) -> float:
        return self.arena.num_live / self.arena.capacity


def _host_codes(codes) -> np.ndarray:
    """int8 codes (a tensor on any device, or numpy) as a host array."""
    if isinstance(codes, torch.Tensor):
        return codes.cpu().numpy()
    return np.asarray(codes, np.int8)
