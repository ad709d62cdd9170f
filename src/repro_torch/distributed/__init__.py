"""Distribution: the serving mesh (`sharding.serving_shard_mesh`).

Port of `repro.distributed`'s serving half. The parameter, optimizer and
cache rules and the compressed gradient all-reduce wait for the training
port (ROADMAP A3).
"""
from repro_torch.distributed.sharding import Mesh, serving_shard_mesh

__all__ = ["Mesh", "serving_shard_mesh"]
