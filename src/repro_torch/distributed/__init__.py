"""Logical-axis sharding over DTensor meshes (port of
``repro.distributed``)."""
from .sharding import (LOGICAL_RULES, P, activation_sharding, batch_spec,
                       cache_spec, distribute_model, params_shardings,
                       partition_spec, placements, shard_act)

__all__ = ["LOGICAL_RULES", "P", "partition_spec", "params_shardings",
           "batch_spec", "cache_spec", "placements", "distribute_model",
           "activation_sharding", "shard_act"]
