"""Tensor-parallel serving and sharded training: sharding plans
(``sharding``), the ranks of the instances with their controller/worker
channels (``group``), and ZeRO-3 over the data axis (``fsdp``)."""

from repro_torch.distributed.group import (DivergenceError, TPGroup,
                                           current_group, mirrored, spawn)
from repro_torch.distributed.sharding import (P, PartitionSpec, ServingMesh,
                                              ShardingPlan, assemble,
                                              batch_specs, cache_specs,
                                              leaf_param_specs,
                                              opt_state_specs,
                                              paged_cache_specs, param_specs,
                                              serving_plan, shard_for_rank,
                                              training_plan, validate_specs)

__all__ = ["DivergenceError", "P", "PartitionSpec", "ServingMesh",
           "ShardingPlan", "TPGroup", "assemble", "batch_specs",
           "cache_specs", "current_group", "leaf_param_specs", "mirrored",
           "opt_state_specs", "paged_cache_specs", "param_specs",
           "serving_plan", "shard_for_rank", "spawn", "training_plan",
           "validate_specs"]
