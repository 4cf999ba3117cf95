"""Tensor-parallel serving: sharding plans (``sharding``) and the ranks of
one instance with their controller/worker channel (``group``)."""

from repro_torch.distributed.group import (DivergenceError, TPGroup,
                                           current_group, mirrored, spawn)
from repro_torch.distributed.sharding import (P, PartitionSpec, ServingMesh,
                                              ShardingPlan, cache_specs,
                                              leaf_param_specs,
                                              paged_cache_specs, param_specs,
                                              serving_plan, shard_for_rank,
                                              validate_specs)

__all__ = ["DivergenceError", "P", "PartitionSpec", "ServingMesh",
           "ShardingPlan", "TPGroup", "cache_specs", "current_group",
           "leaf_param_specs", "mirrored", "paged_cache_specs", "param_specs",
           "serving_plan", "shard_for_rank", "spawn", "validate_specs"]
