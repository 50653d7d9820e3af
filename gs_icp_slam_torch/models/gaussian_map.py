"""The Gaussian map: fixed-capacity tensors with a live mask (counterpart of
gs_icp_slam_tpu/models/gaussian_map.py).

Capacity C is fixed up front; `n` counts slots ever allocated and `live`
marks allocated, unpruned slots, as in the JAX package (and the reference's
prefix-counted shared buffers).  Parameter semantics match the reference:
  xyz           world position
  f_dc          SH degree-0 coefficients, RGB2SH(color)
  f_rest        higher SH bands (none in SLAM mode)
  log_scaling   log of Gaussian extents, initialized from G-ICP covariance
                scales divided by clamp((z^1.5)*2, min=1)
  rotation      xyzw quaternion (un-normalized storage)
  opacity_logit inverse sigmoid of opacity

Pruning clears `live` bits.  `compact` and `densify_clone_split`, which
neither engine's main path calls, are not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import resolve_device
from ..utils.quat import quat_normalize
from ..utils.sh import rgb_to_sh


class GaussianMap(NamedTuple):
    xyz: torch.Tensor            # (C, 3) float32
    f_dc: torch.Tensor           # (C, 3) float32
    f_rest: torch.Tensor         # (C, R, 3) float32, R = (sh+1)^2 - 1
    log_scaling: torch.Tensor    # (C, 3) float32
    rotation: torch.Tensor       # (C, 4) float32 xyzw
    opacity_logit: torch.Tensor  # (C, 1) float32
    trackable: torch.Tensor      # (C,) bool — eligible as G-ICP target
    live: torch.Tensor           # (C,) bool — allocated and not pruned
    n: int                       # slots ever allocated

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def scaling(self) -> torch.Tensor:
        return torch.exp(self.log_scaling)

    @property
    def rotation_normalized(self) -> torch.Tensor:
        return quat_normalize(self.rotation)

    @property
    def opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity_logit)

    @property
    def num_live(self) -> int:
        return int(self.live.sum())


_PARAM_FIELDS = ("xyz", "f_dc", "f_rest", "log_scaling", "rotation",
                 "opacity_logit")


def map_params(m: GaussianMap) -> dict:
    """The trainable-parameter subset (what Adam sees)."""
    return {f: getattr(m, f) for f in _PARAM_FIELDS}


def with_params(m: GaussianMap, params: dict) -> GaussianMap:
    return m._replace(**params)


def empty_map(capacity: int, sh_degree: int = 0,
              device="cuda") -> GaussianMap:
    device = resolve_device(device)
    r = (sh_degree + 1) ** 2 - 1
    f32 = dict(dtype=torch.float32, device=device)
    rotation = torch.zeros((capacity, 4), **f32)
    rotation[:, 3] = 1.0  # identity quat keeps dead slots benign
    return GaussianMap(
        xyz=torch.zeros((capacity, 3), **f32),
        f_dc=torch.zeros((capacity, 3), **f32),
        f_rest=torch.zeros((capacity, r, 3), **f32),
        log_scaling=torch.zeros((capacity, 3), **f32),
        rotation=rotation,
        opacity_logit=torch.full((capacity, 1), -10.0, **f32),
        trackable=torch.zeros(capacity, dtype=torch.bool, device=device),
        live=torch.zeros(capacity, dtype=torch.bool, device=device),
        n=0,
    )


def _gicp_log_scales(scales: torch.Tensor, z_vals: torch.Tensor) -> torch.Tensor:
    """Reference scale init (gaussian_model.py:142-144): the G-ICP
    sqrt-eigenvalues shrunk by clamp((z^1.5)*2, min=1) before the log."""
    z = torch.clamp((z_vals ** 1.5) * 2.0, min=1.0)
    return torch.log(torch.clamp(scales, min=1e-12) / z[:, None])


def add_gaussians(m: GaussianMap, points: torch.Tensor, colors: torch.Tensor,
                  quats: torch.Tensor, scales: torch.Tensor,
                  z_vals: torch.Tensor, trackable: torch.Tensor,
                  valid: torch.Tensor,
                  init_opacity: float = 0.1) -> GaussianMap:
    """Append the valid rows of a candidate batch at the tail, in order;
    rows past capacity are dropped (create_from_pcd2_tensor /
    add_from_pcd2_tensor, gaussian_model.py:134,165).  Updates the map's
    tensors in place and returns it with the new count."""
    C = m.capacity
    sel = torch.nonzero(valid).squeeze(1)  # stable partition: valid rows
    count = int(sel.shape[0])
    room = max(min(count, C - m.n), 0)
    sel = sel[:room]
    dst = slice(m.n, m.n + room)
    m.xyz[dst] = points[sel]
    m.f_dc[dst] = rgb_to_sh(colors[sel])
    m.log_scaling[dst] = _gicp_log_scales(scales[sel], z_vals[sel])
    m.rotation[dst] = quats[sel]
    m.opacity_logit[dst] = math.log(init_opacity / (1.0 - init_opacity))
    m.trackable[dst] = trackable[sel]
    m.live[dst] = True
    if m.f_rest.shape[1] > 0:
        m.f_rest[dst] = 0.0
    return m._replace(n=min(m.n + count, C))


def trackable_export(m: GaussianMap, opacity_th: float, out_capacity: int):
    """get_trackable_gaussians_tensor (gaussian_model.py:207-215): xyz,
    normalized rotation and scaling of the live trackable Gaussians with
    opacity above the threshold, in slot order, in a buffer of
    out_capacity rows.  Returns (points, rots, scales, valid)."""
    mask = m.live & m.trackable & (m.opacity[:, 0] > opacity_th)
    order = torch.argsort((~mask).to(torch.int8), stable=True)[:out_capacity]
    count = int(mask.sum())
    valid = torch.arange(order.shape[0], device=mask.device) < count
    return (m.xyz[order], m.rotation_normalized[order], m.scaling[order],
            valid)


def prune_large_and_transparent(m: GaussianMap, min_opacity: float,
                                extent: float | None) -> GaussianMap:
    """prune_large_and_transparent (gaussian_model.py:580-592): clear the
    live bit of slots with opacity < min_opacity or, given an extent, a
    largest scale > 0.1 * extent."""
    kill = m.opacity[:, 0] < min_opacity
    if extent is not None:
        kill = kill | (torch.max(m.scaling, dim=-1).values > 0.1 * extent)
    return m._replace(live=m.live & ~kill)
