"""Multi-tenant streaming index: shared arenas, online ingest, batch serving.

Port of `repro.tenancy`: many per-user corpora packed into one
pre-allocated nibble-planar arena on the device, online insert/delete
without rebuild, and one batched cascade launch for a mixed batch of
users' queries; `CrossTenantBatchScheduler` is the synchronous facade over
the serving runtime (`repro_torch.serve`).
"""
from repro_torch.tenancy.arena import Arena, ArenaFull, ArenaStats, FREE
from repro_torch.tenancy.placement import PlacementTable
from repro_torch.tenancy.tenants import MultiTenantIndex, TenantTable
from repro_torch.tenancy.scheduler import CrossTenantBatchScheduler

__all__ = ["Arena", "ArenaFull", "ArenaStats", "CrossTenantBatchScheduler",
           "FREE", "MultiTenantIndex", "PlacementTable", "TenantTable"]
