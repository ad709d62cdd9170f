"""Cross-tenant batch scheduler: many users, one kernel launch.

Port of `repro.tenancy.scheduler`: `CrossTenantBatchScheduler` is a thin
synchronous facade over a `ServingRuntime` configured for the legacy
contract — strict FIFO grouping, no deadline-forced launches, no cache.
flush() packs up to `max_batch` requests into one batched retrieval over
the shared arena per group, padding partial groups to power-of-two
buckets with NO_TENANT lanes. The exact analytic byte counts of every
flush accumulate in `stage1_bytes_streamed` / `stage1_bytes_vmapped` /
`stage_bytes`.
"""
from __future__ import annotations

from repro_torch.core.retrieval import RetrievalResult
from repro_torch.tenancy.tenants import MultiTenantIndex


class CrossTenantBatchScheduler:
    """Queue + flush loop around MultiTenantIndex.retrieve: submit()
    returns an int ticket that an explicit flush() resolves."""

    def __init__(self, index: MultiTenantIndex, *, max_batch: int = 16,
                 registry=None, tracer=None):
        # Imported here: repro_torch.serve imports this package.
        from repro_torch.serve.runtime import RuntimeConfig, ServingRuntime
        self.index = index
        self.max_batch = max_batch
        self._rt = ServingRuntime(index, RuntimeConfig(
            max_batch=max_batch, max_wait=0.0, fairness="fifo",
            cache_bytes=0, auto_flush=False),
            registry=registry, tracer=tracer)

    @property
    def registry(self):
        """The wrapped runtime's metrics registry (repro_torch.obs)."""
        return self._rt.registry

    @property
    def tracer(self):
        """The wrapped runtime's request-lifecycle tracer."""
        return self._rt.tracer

    def submit(self, tenant_id: int, query_codes) -> int:
        """Enqueue one request; returns a ticket id resolved by flush()."""
        return self._rt.submit(tenant_id, query_codes).request_id

    def pending(self) -> int:
        return self._rt.pending()

    @property
    def launches(self) -> int:
        return self._rt.launches

    @property
    def stage1_bytes_streamed(self) -> int:
        return self._rt.stage1_bytes_streamed

    @property
    def stage1_bytes_vmapped(self) -> int:
        return self._rt.stage1_bytes_vmapped

    @property
    def stage_bytes(self) -> dict[str, int]:
        return self._rt.stage_bytes

    def flush(self) -> dict[int, RetrievalResult]:
        """Drain the queue in max_batch groups, one launch per group:
        {ticket id -> that request's RetrievalResult} (padding lanes
        dropped)."""
        return {h.request_id: h.result() for h in self._rt.flush()}
