"""Multi-tenant streaming index: shared arenas, online ingest, batch serving.

Port of `repro.tenancy`: many per-user corpora packed into one
pre-allocated nibble-planar arena on the device, online insert/delete
without rebuild, and one batched cascade launch for a mixed batch of
users' queries. (The reference's `CrossTenantBatchScheduler` wraps its
serving runtime and is not ported here.)
"""
from repro_torch.tenancy.arena import Arena, ArenaFull, ArenaStats, FREE
from repro_torch.tenancy.placement import PlacementTable
from repro_torch.tenancy.tenants import MultiTenantIndex, TenantTable

__all__ = ["Arena", "ArenaFull", "ArenaStats", "FREE", "MultiTenantIndex",
           "PlacementTable", "TenantTable"]
