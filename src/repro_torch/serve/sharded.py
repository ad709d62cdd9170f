"""Sharded multi-tenant serving with elastic failover.

Port of `repro.serve.sharded`. It joins three pieces into one serving
layer:

  * `tenancy.PlacementTable` — explicit, rendezvous-hashed tenant -> shard
    placement (deterministic, minimal movement on shrink);
  * per-shard `MultiTenantIndex` + `ServingRuntime` pairs, each on its own
    device — the serving stack (deadline batching, hot slab cache on the
    owning shard, asynchronous dispatch) runs unchanged shard-side;
  * `core/index.py`'s tournament merge for spread tenants, and the
    shrink-and-resume posture of elastic training for device loss.

One submit() fans a request out to the tenant's owner shards; each owner
runs the cascade over ITS rows only and proposes its local top-k (exact
stage-2 scores — every row is rescored by its owner, the tournament's
owner-only exact rescore with the all-gather realised on the host); the
merge takes the global top-k over the shard-major concatenation, the
same selection order `core/index.py` applies. Results are translated from
arena slots to per-tenant DOCUMENT ORDINALS (the tenant-local ids given
at ingest), which makes them placement-invariant: the same trace on 1
shard and on N shards returns bit-identical (indices, scores).

Elastic failover (`fail_shard`): mark the shard dead, shrink the mesh to
the survivors, re-place ONLY the lost shard's tenants from the host-side
corpus log (rendezvous hashing keeps everyone else in place), re-ingest
their documents in ordinal order (arena generation bumps invalidate the
affected shards' cache entries), and resubmit the affected unresolved
requests under the new placement. Resolved handles are never recomputed
and unresolved ones resolve exactly once — the ledger shows zero dropped
and zero duplicated.

Determinism (what bit parity across placements rests on):
  * all shards quantize under the same fixed arena scale, so a document's
    INT8 codes are identical wherever it lands;
  * within a shard a tenant's slots ascend in ingest order, so per-shard
    tie-breaks match the single-arena tie-break (by ordinal);
  * spread > 1 requires the MIPS metric: exact int32 dot scores are
    globally comparable, so the host-side merge is a pure top-k. Cosine's
    non-division comparator needs per-candidate norms that never leave
    the shard, so cosine tenants place with spread 1 (enforced).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import current, resolve_device, visible_devices
from repro_torch.core import quantization
from repro_torch.core.retrieval import RetrievalConfig, RetrievalResult
from repro_torch.distributed.sharding import serving_shard_mesh
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.runtime.fault import HeartbeatMonitor
from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime
from repro_torch.tenancy import MultiTenantIndex, PlacementTable


@dataclasses.dataclass(frozen=True)
class ShardedRuntimeConfig:
    """Topology + per-shard serving knobs.

    num_shards: serving shards (each one arena + one ServingRuntime,
        placed round-robin over the runtime's devices; when there are
        fewer devices than shards, shards share them — the routing, merge
        and failover logic is the same).
    capacity_per_shard / dim / scale: per-shard arena geometry. The
        quantization scale is shared by ALL shards (fixed at build), so
        codes are placement-invariant.
    spread: shards per tenant (>1 row-shards one tenant's corpus over
        several arenas; requires metric == "mips", see the module doc).
    retrieval / runtime: the per-shard RetrievalConfig / RuntimeConfig —
        every shard runs the same config.
    clusters: optional per-shard ClusterParams. Each shard trains its own
        codebook on its own rows, so cluster-pruned candidate sets are
        placement-DEPENDENT; leave None (full masked or windowed scans)
        when bit parity across placements is required.

    Bit parity across shard counts also requires the stage-1 candidate
    budget to cover every tenant's row count (`retrieval.num_candidates`
    scales with arena capacity, which differs per placement — set
    candidate_frac=1.0 and max_candidates >= the largest tenant so the
    approximate stage never cuts a real row).
    """

    num_shards: int = 4
    capacity_per_shard: int = 1024
    dim: int = 64
    spread: int = 1
    retrieval: RetrievalConfig = dataclasses.field(
        default_factory=RetrievalConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    clusters: object | None = None
    scale: float | None = None

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if not 1 <= self.spread <= self.num_shards:
            raise ValueError(f"spread must be in [1, num_shards], got "
                             f"{self.spread}")
        if self.spread > 1 and self.retrieval.metric != "mips":
            raise ValueError(
                "spread > 1 merges exact scores across shards, which is "
                "only well-defined for the globally-comparable MIPS "
                "metric (cosine needs per-candidate norms that never "
                "leave the owning shard) — use spread=1 for cosine")


class _Shard:
    __slots__ = ("sid", "device", "index", "runtime", "alive")

    def __init__(self, sid, device, index, runtime):
        self.sid = sid
        self.device = device
        self.index = index
        self.runtime = runtime
        self.alive = True


@dataclasses.dataclass
class _SReq:
    """One logical request: its query, its per-shard sub-handles, and its
    merged result (set exactly once)."""
    rid: int
    tenant_id: int
    query: np.ndarray
    deadline: float | None
    subs: dict = dataclasses.field(default_factory=dict)  # sid -> handle
    result: RetrievalResult | None = None
    resubmits: int = 0


class ShardedHandle:
    """Future-style handle for one sharded request (the single-runtime
    RequestHandle contract: `done()` never blocks, `result(wait=False)`
    returns None as the not-ready signal)."""

    __slots__ = ("_rt", "_req")

    def __init__(self, rt: "ShardedServingRuntime", req: _SReq):
        self._rt = rt
        self._req = req

    @property
    def request_id(self) -> int:
        return self._req.rid

    @property
    def tenant_id(self) -> int:
        return self._req.tenant_id

    @property
    def state(self) -> str:
        if self._req.result is not None:
            return "resolved"
        states = {h.state for h in self._req.subs.values()}
        return "in_flight" if states <= {"in_flight", "resolved"} \
            else "pending"

    def done(self) -> bool:
        return (self._req.result is not None
                or all(h.done() for h in self._req.subs.values()))

    def result(self, *, wait: bool = True) -> RetrievalResult | None:
        return self._rt._resolve(self._req, wait=wait)

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"ShardedHandle(id={self._req.rid}, "
                f"tenant={self._req.tenant_id}, {self.state})")


class ShardedServingRuntime:
    """Tenant-sharded serving over N per-device ServingRuntimes.

    devices: the devices shards are dealt over, round-robin (None: every
    visible CUDA device, raising without one; ["cpu"] puts every shard on
    the CPU)."""

    def __init__(self, cfg: ShardedRuntimeConfig | None = None, *,
                 devices=None, registry=None,
                 heartbeat_timeout_s: float = 30.0):
        self.cfg = cfg or ShardedRuntimeConfig()
        self.registry = NULL_REGISTRY if registry is None else registry
        devices = (visible_devices() if devices is None
                   else [resolve_device(d) for d in devices])
        c = self.cfg
        self._shards: dict[int, _Shard] = {}
        for sid in range(c.num_shards):
            dev = devices[sid % len(devices)]
            index = MultiTenantIndex(
                c.capacity_per_shard, c.dim, c.retrieval, scale=c.scale,
                clusters=c.clusters, device=dev)
            runtime = ServingRuntime(
                index, c.runtime,
                registry=self.registry.labeled(shard=str(sid)))
            self._shards[sid] = _Shard(sid, dev, index, runtime)
        self.placement = PlacementTable(range(c.num_shards), spread=c.spread)
        self.mesh = serving_shard_mesh([s.device
                                        for s in self._shards.values()])
        # Every shard's arena shares shard 0's fixed quantization scale
        # (same dim + same explicit scale => identical by construction;
        # checked because placement-invariant codes ride on it).
        self._scale = float(self._shards[0].index.arena.scale)
        if any(float(s.index.arena.scale) != self._scale
               for s in self._shards.values()):
            raise RuntimeError("shards disagree on the arena scale")
        self.monitor = HeartbeatMonitor(timeout_s=heartbeat_timeout_s)
        for sid in self._shards:
            self.monitor.beat(str(sid))
        # Host-side corpus log: tenant -> ordinal -> INT8 codes (None =
        # deleted). THE failover source of truth — a lost shard's rows
        # are re-ingested from here, in ordinal order.
        self._corpus: dict[int, list[np.ndarray | None]] = {}
        # (sid, tenant) -> ordinals placed on that shard, ingest order.
        self._placed: dict[tuple[int, int], list[int]] = {}
        # (sid, tenant) -> {arena slot -> ordinal} (result translation).
        self._slot_ord: dict[tuple[int, int], dict[int, int]] = {}
        # tenant -> {ordinal -> (sid, slot)} (deletes + failover purge).
        self._ord_loc: dict[int, dict[int, tuple[int, int]]] = {}
        self._live_reqs: dict[int, _SReq] = {}
        self._next_rid = 0
        # -- exactly-once ledger -------------------------------------------
        self.submitted = 0
        self.resolved = 0
        self.resolved_by_tenant: dict[int, int] = {}
        self.resubmitted = 0
        self.failovers = 0
        self.docs_restored = 0

    # -- topology ------------------------------------------------------------

    @property
    def live_shards(self) -> list[int]:
        return [sid for sid, s in self._shards.items() if s.alive]

    def shard(self, sid: int) -> _Shard:
        return self._shards[sid]

    def _ctx(self, sid: int):
        return current(self._shards[sid].device)

    def _check_live(self, sid: int) -> _Shard:
        s = self._shards[sid]
        if not s.alive:
            raise RuntimeError(f"shard {sid} is dead")
        return s

    # -- ingestion -----------------------------------------------------------

    def ingest(self, tenant_id: int, embeddings) -> np.ndarray:
        """Quantize under the shared fixed scale and place; returns the
        new documents' tenant-local ordinals."""
        x = torch.from_numpy(np.array(embeddings, np.float32, copy=True))
        codes = quantization.quantize_int8_fixed(x, self._scale).numpy()
        return self.ingest_codes(tenant_id, codes)

    def ingest_codes(self, tenant_id: int, codes) -> np.ndarray:
        tid = int(tenant_id)
        codes = np.asarray(codes, np.int8)
        if codes.ndim != 2 or codes.shape[1] != self.cfg.dim:
            raise ValueError(f"codes must be (B, {self.cfg.dim}) int8")
        log = self._corpus.setdefault(tid, [])
        base = len(log)
        ordinals = list(range(base, base + codes.shape[0]))
        by_shard: dict[int, list[int]] = {}
        for o in ordinals:
            by_shard.setdefault(self.placement.doc_shard(tid, o), []).append(o)
        for sid, ords in sorted(by_shard.items()):
            self._ingest_on(sid, tid, codes[[o - base for o in ords]], ords)
        log.extend(codes[i] for i in range(codes.shape[0]))
        return np.asarray(ordinals, np.int64)

    def _ingest_on(self, sid: int, tid: int, codes: np.ndarray,
                   ordinals: list[int]) -> None:
        shard = self._check_live(sid)
        with self._ctx(sid):
            slots = shard.index.ingest_codes(tid, codes)
        self._placed.setdefault((sid, tid), []).extend(ordinals)
        smap = self._slot_ord.setdefault((sid, tid), {})
        omap = self._ord_loc.setdefault(tid, {})
        for slot, o in zip(slots.tolist(), ordinals):
            smap[slot] = o
            omap[o] = (sid, slot)

    def delete(self, tenant_id: int, ordinals) -> None:
        """Tombstone documents by tenant-local ordinal (everywhere they
        live; deleted ordinals are skipped by failover re-ingest)."""
        tid = int(tenant_id)
        omap = self._ord_loc.get(tid, {})
        by_shard: dict[int, list[int]] = {}
        for o in np.atleast_1d(np.asarray(ordinals, np.int64)).tolist():
            sid, slot = omap[o]
            by_shard.setdefault(sid, []).append(slot)
            self._corpus[tid][o] = None
            del omap[o]
            del self._slot_ord[(sid, tid)][slot]
            self._placed[(sid, tid)].remove(o)
        for sid, slots in sorted(by_shard.items()):
            with self._ctx(sid):
                self._shards[sid].index.delete(tid, slots)

    def num_docs(self, tenant_id: int) -> int:
        return sum(1 for c in self._corpus.get(int(tenant_id), ())
                   if c is not None)

    # -- serving -------------------------------------------------------------

    def submit(self, tenant_id: int, query_codes, *,
               deadline: float | None = None,
               now: float | None = None) -> ShardedHandle:
        """Fan one request out to the tenant's owner shards."""
        tid = int(tenant_id)
        q = np.asarray(query_codes, np.int8)
        req = _SReq(self._next_rid, tid, q, deadline)
        self._next_rid += 1
        for sid in self.placement.owners(tid):
            shard = self._check_live(sid)
            with self._ctx(sid):
                req.subs[sid] = shard.runtime.submit(
                    tid, q, deadline=deadline, now=now)
        self._live_reqs[req.rid] = req
        self.submitted += 1
        return ShardedHandle(self, req)

    def poll(self, now: float | None = None) -> list[ShardedHandle]:
        """Poll every live shard, then harvest (non-blocking) any request
        whose sub-results all landed. Returns handles resolved here."""
        for sid in self.live_shards:
            with self._ctx(sid):
                self._shards[sid].runtime.poll(now)
            self.monitor.beat(str(sid))
        return self._harvest(blocking=False)

    def flush(self, now: float | None = None) -> list[ShardedHandle]:
        """Drain every live shard and resolve every outstanding request."""
        for sid in self.live_shards:
            with self._ctx(sid):
                self._shards[sid].runtime.flush(now)
            self.monitor.beat(str(sid))
        return self._harvest(blocking=True)

    def barrier(self) -> int:
        n = 0
        for sid in self.live_shards:
            with self._ctx(sid):
                n += self._shards[sid].runtime.barrier()
        self._harvest(blocking=False)
        return n

    def _harvest(self, *, blocking: bool) -> list[ShardedHandle]:
        out = []
        for req in list(self._live_reqs.values()):
            if blocking or all(h.done() for h in req.subs.values()):
                self._resolve(req, wait=True)
                out.append(ShardedHandle(self, req))
        return out

    def _resolve(self, req: _SReq, *, wait: bool) -> RetrievalResult | None:
        if req.result is not None:
            return req.result
        if not wait and not all(h.done() for h in req.subs.values()):
            return None
        parts = {}
        for sid in sorted(req.subs):
            with self._ctx(sid):
                parts[sid] = req.subs[sid].result(wait=True)
        req.result = self._merge(req.tenant_id, parts)
        # Exactly-once: the request leaves the live set the moment its
        # result exists — a later failover can never resubmit it, and a
        # second result() call returns the cached merge.
        if self._live_reqs.pop(req.rid, None) is None:
            raise RuntimeError(f"request {req.rid} resolved twice")
        self.resolved += 1
        self.resolved_by_tenant[req.tenant_id] = (
            self.resolved_by_tenant.get(req.tenant_id, 0) + 1)
        return req.result

    # -- tournament merge ----------------------------------------------------

    def _xlate(self, sid: int, tid: int, arr) -> np.ndarray:
        """Arena slots -> tenant-local ordinals (-1 pads pass through)."""
        smap = self._slot_ord.get((sid, tid), {})
        arr = np.asarray(arr)
        flat = arr.reshape(-1).tolist()
        return np.fromiter((smap.get(s, -1) for s in flat), np.int64,
                           count=len(flat)).reshape(arr.shape)

    def _merge(self, tid: int, parts: dict[int, RetrievalResult]
               ) -> RetrievalResult:
        """Owner proposals -> global top-k, in tournament order.

        Each owner's (indices, scores) is its exact local top-k — the
        "local proposals, owner-rescored" half of the ShardedIndex
        tournament. The global top-k over their shard-major concatenation
        is exact (it is contained in the union of local top-ks) and the
        (score desc, ordinal asc) order reproduces the single-arena
        tie-break, because within a shard slots ascend in ordinal order.
        """
        k = self.cfg.retrieval.k
        items = []         # (score, ordinal) over all owners' proposals
        cands = []
        for sid in sorted(parts):
            r = parts[sid]
            idx = self._xlate(sid, tid, r.indices)
            sc = np.asarray(r.scores)
            cands.append(self._xlate(sid, tid, r.candidate_indices))
            if len(parts) == 1:
                return RetrievalResult(indices=idx, scores=sc,
                                       candidate_indices=cands[0])
            items.extend((s, o) for s, o in zip(sc.tolist(), idx.tolist())
                         if o >= 0)
        items.sort(key=lambda t: (-t[0], t[1]))
        indices = np.full((k,), -1, np.int64)
        scores = np.zeros((k,), np.int32)       # engine pad convention
        for j, (s, o) in enumerate(items[:k]):
            indices[j] = o
            scores[j] = s
        return RetrievalResult(indices=indices, scores=scores,
                               candidate_indices=np.concatenate(cands))

    # -- elastic failover ----------------------------------------------------

    def fail_shard(self, sid: int, now: float | None = None) -> dict:
        """Lose one shard and resume: shrink the mesh, re-place its
        tenants from the host corpus log, invalidate the affected cache
        generations, resubmit its unresolved requests. No request is
        dropped (every live handle resolves) or duplicated (resolved
        handles keep their result and never recompute)."""
        sid = int(sid)
        shard = self._check_live(sid)
        if len(self.live_shards) == 1:
            raise RuntimeError("cannot fail the last live shard")
        shard.alive = False
        self.monitor.remove(str(sid))
        moved = self.placement.remove_shard(sid)

        # Requests that routed through the dead shard (exactly those whose
        # tenant moved); their surviving sub-results are discarded — the
        # whole fan-out re-runs under the post-failure placement, which is
        # safe because results are placement-invariant.
        affected = [r for r in self._live_reqs.values() if sid in r.subs]

        restored = 0
        for tid in sorted(moved):
            lost = self._placed.pop((sid, tid), [])
            self._slot_ord.pop((sid, tid), None)
            codes, ords = [], []
            for o in lost:
                self._ord_loc[tid].pop(o, None)
                row = self._corpus[tid][o]
                if row is not None:
                    codes.append(row)
                    ords.append(o)
            by_shard: dict[int, tuple[list, list]] = {}
            for row, o in zip(codes, ords):
                dst = self.placement.doc_shard(tid, o)
                by_shard.setdefault(dst, ([], []))[0].append(row)
                by_shard[dst][1].append(o)
            for dst, (rows, os_) in sorted(by_shard.items()):
                self._ingest_on(dst, tid, np.stack(rows).astype(np.int8),
                                os_)
                restored += len(os_)
            # The re-ingest bumped the target arenas' generations; sync
            # the owning shards' slab caches NOW so stale entries for the
            # moved tenants are invalidated at failover time, not lazily
            # at their next launch.
            for dst in moved[tid]:
                cache = self._shards[dst].runtime.cache
                if cache is not None:
                    cache.sync_generation(
                        self._shards[dst].index.arena.generation)
        self.docs_restored += restored

        for req in affected:
            req.subs = {}
            for dst in self.placement.owners(req.tenant_id):
                with self._ctx(dst):
                    req.subs[dst] = self._shards[dst].runtime.submit(
                        req.tenant_id, req.query, deadline=req.deadline,
                        now=now)
            req.resubmits += 1
        self.resubmitted += len(affected)
        self.failovers += 1
        self.mesh = serving_shard_mesh(
            [self._shards[s].device for s in self.live_shards])
        return {"shard": sid, "live_shards": self.live_shards,
                "moved_tenants": sorted(moved),
                "docs_restored": restored,
                "requests_resubmitted": len(affected)}

    # -- ledgers -------------------------------------------------------------

    def ledger(self) -> dict:
        """Request ledger + per-shard byte ledgers, aggregated.

        `dropped` and `duplicated` are computed, not asserted: submitted
        splits exactly into resolved + outstanding, and resolutions are
        counted at the single site that sets a request's result."""
        shards = {sid: s.runtime for sid, s in self._shards.items()}
        return {
            "submitted": self.submitted,
            "resolved": self.resolved,
            "outstanding": len(self._live_reqs),
            "dropped": self.submitted - self.resolved - len(self._live_reqs),
            "duplicated": self.resolved - sum(
                self.resolved_by_tenant.values()),
            "resolved_by_tenant": dict(sorted(
                self.resolved_by_tenant.items())),
            "resubmitted": self.resubmitted,
            "failovers": self.failovers,
            "docs_restored": self.docs_restored,
            "shard_lanes_served": {sid: r.queries_served
                                   for sid, r in shards.items()},
            "launches": sum(r.launches for r in shards.values()),
            "stage1_bytes_hbm": sum(r.stage1_bytes_streamed
                                    for r in shards.values()),
            "stage1_bytes_sram": sum(r.stage1_bytes_sram
                                     for r in shards.values()),
        }
