"""Distribution: the serving mesh and the training rules
(`sharding`), the mesh of `torch.distributed` ranks and its collectives
(`collectives`), and the INT8 error-feedback gradient compression with
the two-level compressed all-reduce (`compression`); the port of
`repro.distributed`.
"""
from repro_torch.distributed import collectives, compression
from repro_torch.distributed.collectives import RankMesh, World
from repro_torch.distributed.sharding import (Mesh, NamedSharding,
                                              PartitionSpec,
                                              serving_shard_mesh)

__all__ = ["Mesh", "NamedSharding", "PartitionSpec", "RankMesh", "World",
           "collectives", "compression", "serving_shard_mesh"]
