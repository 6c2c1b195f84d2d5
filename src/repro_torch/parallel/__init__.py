"""The port's process mesh, partition specs and the transport under the
MoE collectives (counterpart of ``repro/parallel``)."""
from repro_torch.parallel.mesh import (AxisGroup, Mesh, ParallelDims,
                                       axis_size, make_mesh,
                                       production_dims)
from repro_torch.parallel.sharding import (P, PartitionSpec, ShardingRules,
                                           gather_full, local_shard)

__all__ = ["AxisGroup", "Mesh", "ParallelDims", "axis_size", "make_mesh",
           "production_dims", "P", "PartitionSpec", "ShardingRules",
           "gather_full", "local_shard"]
