"""Distribution: the serving mesh (`sharding.serving_shard_mesh`) and the
INT8 error-feedback gradient compression (`compression`).

Port of `repro.distributed`'s serving half and of the numerics core of
its gradient compression. The parameter, optimizer and cache rules and
the two-level compressed all-reduce wait for ROADMAP A2's training half.
"""
from repro_torch.distributed import compression
from repro_torch.distributed.sharding import Mesh, serving_shard_mesh

__all__ = ["Mesh", "compression", "serving_shard_mesh"]
