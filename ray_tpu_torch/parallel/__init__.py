"""Parallelism over ``torch.distributed`` (counterpart of
``ray_tpu.parallel``): named device meshes, logical-axis sharding rules
as DTensor placements, regex partition rules, context parallelism (ring
attention over the flash kernels, Ulysses all-to-all), GPipe pipeline
parallelism, and the autograd-aware all-reduces they share."""

from .mesh import (AXIS_ORDER, MeshSpec, create_mesh, gang_mesh,
                   local_mesh, process_contiguous_devices)
from .partition_rules import (match_partition_rules, named_tree_map,
                              prune_spec, shard_tree, tree_shardings)
from .pipeline import pipeline_apply, stack_stage_params
from .ring_attention import ring_attention
from .sharding import (PartitionSpec, ShardingRules, logical_sharding,
                       shard_pytree, with_logical_constraint)
from .ulysses import ulysses_attention

__all__ = ["AXIS_ORDER", "MeshSpec", "PartitionSpec", "ShardingRules",
           "create_mesh", "gang_mesh", "local_mesh", "logical_sharding",
           "match_partition_rules", "named_tree_map", "pipeline_apply",
           "process_contiguous_devices", "prune_spec", "ring_attention",
           "shard_pytree", "shard_tree", "stack_stage_params",
           "tree_shardings",
           "ulysses_attention", "with_logical_constraint"]
