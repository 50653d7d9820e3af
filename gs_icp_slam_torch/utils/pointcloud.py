"""RGB-D -> point cloud with the reference's pixel-grid downsampling
(gs_icp_slam.py:177-196, mp_Tracker.py:394-431).

The pattern picks every `rate`-th column on rows {0, rate-1, 2*rate-1, ...}
(the first row is special-cased to 0).  x_pre=(u-cx)/fx and y_pre=(v-cy)/fy
are precomputed once; every frame yields exactly len(idxs) samples, with
invalid depths masked rather than dropped.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DownsampleFilter:
    """Precomputed subsample indices + unprojection coefficients."""

    flat_idxs: np.ndarray  # (P,) int32 flat pixel indices into H*W
    x_pre: np.ndarray  # (P,) float32, (u-cx)/fx
    y_pre: np.ndarray  # (P,) float32, (v-cy)/fy
    gh: int = 0  # sample-grid rows (P = gh * gw, row-major)
    gw: int = 0  # sample-grid cols

    @property
    def num_points(self) -> int:
        return int(self.flat_idxs.shape[0])


def make_downsample_filter(width: int, height: int, fx: float, fy: float,
                           cx: float, cy: float, rate: int) -> DownsampleFilter:
    """Replicates the reference's set_downsample_filter row/col pattern."""
    h_val = rate * np.arange(0, int(height / rate) + 1)
    h_val = h_val - 1
    h_val[0] = 0
    h_val = h_val * width
    a, b = np.meshgrid(h_val, np.arange(0, width, rate), indexing="ij")
    flat_idxs = (a + b).reshape(-1).astype(np.int32)
    u = (flat_idxs % width).astype(np.float32)
    v = (flat_idxs // width).astype(np.float32)
    x_pre = (u - cx) / fx
    y_pre = (v - cy) / fy
    return DownsampleFilter(flat_idxs=flat_idxs, x_pre=x_pre, y_pre=y_pre,
                            gh=len(h_val), gw=len(range(0, width, rate)))


def downsample_pointcloud(filt: DownsampleFilter, depth: torch.Tensor,
                          rgb: torch.Tensor, depth_scale: float,
                          depth_trunc: float) -> dict:
    """The per-frame downsampled point cloud.

    depth (H, W) raw depth (divided by depth_scale); rgb (H, W, 3) uint8 or
    float.  Returns a dict of length-P tensors on depth's device: points
    (P, 3) camera-frame xyz, colors (P, 3) in [0, 1], z (P,), valid
    (z != 0; these become Gaussians) and trackable (valid & z <=
    depth_trunc; these take part in tracking).
    """
    dev = depth.device
    idxs = torch.as_tensor(filt.flat_idxs, dtype=torch.long, device=dev)
    z = depth.reshape(-1)[idxs].to(torch.float32) / depth_scale
    colors = rgb.reshape(-1, 3)[idxs].to(torch.float32)
    if rgb.dtype == torch.uint8:
        colors = colors / 255.0
    x = torch.as_tensor(filt.x_pre, device=dev) * z
    y = torch.as_tensor(filt.y_pre, device=dev) * z
    points = torch.stack([x, y, z], dim=-1)
    valid = z != 0.0
    trackable = valid & (z <= depth_trunc)
    return {"points": points, "colors": colors, "z": z, "valid": valid,
            "trackable": trackable}
