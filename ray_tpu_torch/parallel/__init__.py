"""Parallelism over ``torch.distributed`` (counterpart of
``ray_tpu.parallel``): named device meshes, logical-axis sharding rules
as DTensor placements, regex partition rules, and context parallelism
(ring attention over the flash kernels, Ulysses all-to-all).  Pipeline
parallelism arrives with a later slice of the port."""

from .mesh import (AXIS_ORDER, MeshSpec, create_mesh, gang_mesh,
                   local_mesh, process_contiguous_devices)
from .partition_rules import (match_partition_rules, named_tree_map,
                              prune_spec, shard_tree, tree_shardings)
from .ring_attention import ring_attention
from .sharding import (PartitionSpec, ShardingRules, logical_sharding,
                       shard_pytree, with_logical_constraint)
from .ulysses import ulysses_attention

__all__ = ["AXIS_ORDER", "MeshSpec", "PartitionSpec", "ShardingRules",
           "create_mesh", "gang_mesh", "local_mesh", "logical_sharding",
           "match_partition_rules", "named_tree_map",
           "process_contiguous_devices", "prune_spec", "ring_attention",
           "shard_pytree", "shard_tree", "tree_shardings",
           "ulysses_attention", "with_logical_constraint"]
