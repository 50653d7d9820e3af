from .gaussian_map import (GaussianMap, add_gaussians, empty_map, map_params,
                           trackable_export)

__all__ = ["GaussianMap", "add_gaussians", "empty_map", "map_params",
           "trackable_export"]
