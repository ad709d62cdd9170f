"""Tenant -> shard placement for sharded serving.

Port of `repro.tenancy.placement` (pure Python, unchanged). The sharded
serving runtime needs an EXPLICIT tenant->shard table with two
properties the elastic path depends on:

  * deterministic: the same tenant maps to the same shard set on every
    host, with no coordination traffic — placement is pure arithmetic
    over (tenant id, shard id), never mutable routing state that could
    drift between a router and a shard;
  * minimal movement on shrink: when a shard dies, ONLY the tenants it
    owned may move. Everyone else's placement (and therefore their arena
    contents, cache generations and in-flight work) is untouched.

Both come from rendezvous (highest-random-weight) hashing: each tenant
ranks every live shard by a stable per-(tenant, shard) hash and owns the
top `spread` shards. Removing a shard from the candidate set only
changes the ranking of tenants that ranked IT in their top `spread` —
the textbook HRW minimal-disruption property.

`spread` > 1 shards one tenant's corpus row-wise over several shards
(the pod-scale layout for corpora bigger than one arena); documents are
dealt round-robin over the owner set by their per-tenant ingest ordinal.
"""
from __future__ import annotations

import hashlib


def _weight(tenant_id: int, shard_id: int) -> int:
    """Stable per-(tenant, shard) rendezvous weight.

    blake2b rather than hash(): Python randomizes str/bytes hashing per
    process, and placement must agree across processes and restarts."""
    h = hashlib.blake2b(f"{tenant_id}:{shard_id}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class PlacementTable:
    """Rendezvous-hashed tenant -> shard-set mapping over live shards."""

    def __init__(self, shard_ids, *, spread: int = 1):
        shard_ids = [int(s) for s in shard_ids]
        if len(set(shard_ids)) != len(shard_ids):
            raise ValueError(f"duplicate shard ids: {shard_ids}")
        if not shard_ids:
            raise ValueError("need at least one shard")
        if spread < 1:
            raise ValueError("spread must be >= 1")
        self._live: list[int] = sorted(shard_ids)
        self.spread = spread
        self._tenants: set[int] = set()
        self._cache: dict[int, tuple[int, ...]] = {}

    # -- topology ----------------------------------------------------------

    @property
    def live_shards(self) -> list[int]:
        return list(self._live)

    @property
    def tenants(self) -> list[int]:
        """Every tenant ever routed through this table (registration is
        how remove_shard knows whose placement to diff)."""
        return sorted(self._tenants)

    # -- lookup ------------------------------------------------------------

    def owners(self, tenant_id: int) -> tuple[int, ...]:
        """The tenant's owner shards: top-`spread` live shards by
        rendezvous weight (descending; shard id breaks exact ties)."""
        tenant_id = int(tenant_id)
        if tenant_id < 0:
            raise ValueError(f"tenant id must be >= 0, got {tenant_id}")
        self._tenants.add(tenant_id)
        cached = self._cache.get(tenant_id)
        if cached is not None:
            return cached
        ranked = sorted(self._live,
                        key=lambda s: (-_weight(tenant_id, s), s))
        out = tuple(ranked[:min(self.spread, len(ranked))])
        self._cache[tenant_id] = out
        return out

    def shard_of(self, tenant_id: int) -> int:
        """The tenant's PRIMARY shard (owners()[0])."""
        return self.owners(tenant_id)[0]

    def doc_shard(self, tenant_id: int, ordinal: int) -> int:
        """Owner of one document: ordinals deal round-robin over the
        owner set, so a spread tenant's corpus splits near-evenly."""
        owners = self.owners(tenant_id)
        return owners[int(ordinal) % len(owners)]

    def table(self) -> dict[int, tuple[int, ...]]:
        """The explicit placement table (tenant -> owner shards) for every
        registered tenant — what an operator dashboard renders."""
        return {t: self.owners(t) for t in self.tenants}

    # -- elastic shrink ----------------------------------------------------

    def remove_shard(self, shard_id: int) -> dict[int, tuple[int, ...]]:
        """Drop a dead shard; returns {affected tenant: new owner set}.

        Affected tenants are exactly those whose owner set contained the
        dead shard — rendezvous hashing guarantees every other tenant's
        owner set is unchanged (asserted below, cheaply, because the
        elastic path's no-spurious-movement contract rides on it)."""
        shard_id = int(shard_id)
        if shard_id not in self._live:
            raise KeyError(f"shard {shard_id} is not live "
                           f"(live: {self._live})")
        if len(self._live) == 1:
            raise ValueError("cannot remove the last live shard")
        before = {t: self.owners(t) for t in self.tenants}
        self._live.remove(shard_id)
        self._cache.clear()
        moved: dict[int, tuple[int, ...]] = {}
        for t, old in before.items():
            new = self.owners(t)
            if shard_id in old:
                moved[t] = new
            else:
                assert new == old, (t, old, new)
        return moved
