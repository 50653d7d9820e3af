from .gaussian_map import (GaussianMap, add_gaussians, empty_map, map_params,
                           prune_large_and_transparent, trackable_export,
                           with_params)
from .optimizer import AdamState, adam_init, adam_step, map_lr_tree

__all__ = ["AdamState", "GaussianMap", "adam_init", "adam_step",
           "add_gaussians", "empty_map", "map_lr_tree", "map_params",
           "prune_large_and_transparent", "trackable_export", "with_params"]
