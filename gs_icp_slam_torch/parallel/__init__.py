from .mapping import (make_mesh, shard_map_state, make_parallel_opt_step,
                      ParallelMappingStep)
from .sharded import MAP_AXIS, place_state, state_shardings
from .launch import global_mesh, init_distributed

__all__ = ["make_mesh", "shard_map_state", "make_parallel_opt_step",
           "ParallelMappingStep", "MAP_AXIS", "place_state",
           "state_shardings", "global_mesh", "init_distributed"]
