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

Pruning clears `live` bits; `compact` reclaims dead slots and
`densify_clone_split` is 3DGS's adaptive density control.  Neither engine
calls those two, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import resolve_device
from ..ops.projection import covariance_3d
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


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


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


def trackable_mask(m: GaussianMap, opacity_th: float) -> torch.Tensor:
    """The slots the target export takes: live, trackable, with opacity
    above the threshold."""
    return m.live & m.trackable & (m.opacity[:, 0] > opacity_th)


def trackable_export(m: GaussianMap, opacity_th: float, out_capacity: int):
    """get_trackable_gaussians_tensor (gaussian_model.py:207-215): xyz,
    normalized rotation and scaling of the live trackable Gaussians with
    opacity above the threshold, in slot order, in a buffer of
    out_capacity rows.  Returns (points, rots, scales, valid)."""
    mask = trackable_mask(m, opacity_th)
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


def densify_clone_split(m: GaussianMap, grad_norm: torch.Tensor,
                        extent: float, generator: torch.Generator | None = None,
                        grad_threshold: float = 2e-4,
                        percent_dense: float = 0.01,
                        max_new: int = 4096) -> GaussianMap:
    """Adaptive density control: densify_and_clone / densify_and_split
    (gaussian_model.py:494-541).  The reference defines these but its SLAM
    mapper never calls them; density comes from keyframe insertion.

    grad_norm (C,): per-Gaussian positional gradient norm, the trigger;
    extent: scene extent (small/large split at percent_dense * extent);
    generator: the source of the split samples' standard normal noise, a
    (2, max_new, 3) draw on the map's device; max_new: cap on the
    Gaussians selected per call (each yields up to two rows).  Returns a
    new map; the input map is not modified."""
    max_new = min(max_new, m.capacity)
    eps = torch.randn((2, max_new, 3), generator=generator,
                      device=m.xyz.device, dtype=m.xyz.dtype)
    return densify_clone_split_with_noise(m, grad_norm, extent, eps,
                                          grad_threshold, percent_dense,
                                          max_new)


def densify_clone_split_with_noise(m: GaussianMap, grad_norm: torch.Tensor,
                                   extent: float, eps: torch.Tensor,
                                   grad_threshold: float = 2e-4,
                                   percent_dense: float = 0.01,
                                   max_new: int = 4096) -> GaussianMap:
    """densify_clone_split with its split noise given: eps (2, max_new, 3)
    standard normal samples.  The hot Gaussians (live, grad_norm >=
    grad_threshold), at most max_new in slot order, each write row a at
    the tail; the large ones among them (largest scale > percent_dense *
    extent) also write row b after all rows a.  A small Gaussian's row a is
    its copy (clone).  A large one is split: row a is moved by L eps[0] and
    row b by L eps[1] (L the Cholesky factor of its covariance), both with
    scales / 1.6, and the original is killed.  Rows past capacity drop."""
    C = m.capacity
    max_new = min(max_new, C)
    dev = m.xyz.device
    big = torch.max(m.scaling, dim=-1).values > percent_dense * extent
    hot = m.live & (grad_norm >= grad_threshold)
    sel_split = hot & big
    order = torch.argsort((~hot).to(torch.int8), stable=True)[:max_new]
    count = min(int(hot.sum()), max_new)
    ok = torch.arange(order.shape[0], device=dev) < count

    xyz, logs, rot = m.xyz[order], m.log_scaling[order], m.rotation[order]
    is_split = sel_split[order]

    # split: two samples from N(xyz, Sigma) with scales / 1.6
    # (gaussian_model.py:494-521); clone: exact copies (:523-541).  A
    # covariance that is not numerically positive definite (a flat
    # G-ICP seed with a vanishing third scale) gets a NaN factor, as
    # jnp.linalg.cholesky gives it
    L, info = torch.linalg.cholesky_ex(
        covariance_3d(rot, torch.exp(logs))
        + 1e-12 * torch.eye(3, dtype=logs.dtype, device=dev))
    L = torch.where((info == 0)[:, None, None], L, float("nan"))
    offs = torch.einsum("nij,snj->sni", L, eps)
    split_logs = logs - math.log(1.6)

    row_a_xyz = torch.where(is_split[:, None], xyz + offs[0], xyz)
    row_a_logs = torch.where(is_split[:, None], split_logs, logs)
    row_b_xyz = xyz + offs[1]
    ok_a, ok_b = ok, ok & is_split

    # the slots: rows a from n on, then rows b, each in selection order;
    # a row whose slot is past capacity drops
    n_a = int(ok_a.sum())
    slot_a = m.n + torch.cumsum(ok_a.to(torch.int64), 0) - 1
    slot_b = m.n + n_a + torch.cumsum(ok_b.to(torch.int64), 0) - 1
    put_a = ok_a & (slot_a < C)
    put_b = ok_b & (slot_b < C)

    def put(base, rows_a, rows_b):
        out = base.clone()
        out[slot_a[put_a]] = rows_a[put_a]
        out[slot_b[put_b]] = rows_b[put_b]
        return out

    pick = {f: getattr(m, f)[order] for f in
            ("f_dc", "f_rest", "rotation", "opacity_logit", "trackable")}
    live = put(m.live, ok_a, ok_b)
    # split originals are pruned (the reference's prune_filter after split)
    live[order[ok & is_split]] = False
    return GaussianMap(
        xyz=put(m.xyz, row_a_xyz, row_b_xyz),
        f_dc=put(m.f_dc, pick["f_dc"], pick["f_dc"]),
        f_rest=put(m.f_rest, pick["f_rest"], pick["f_rest"]),
        log_scaling=put(m.log_scaling, row_a_logs, split_logs),
        rotation=put(m.rotation, pick["rotation"], pick["rotation"]),
        opacity_logit=put(m.opacity_logit, pick["opacity_logit"],
                          pick["opacity_logit"]),
        trackable=put(m.trackable, pick["trackable"], pick["trackable"]),
        live=live,
        n=min(m.n + n_a + int(ok_b.sum()), C),
    )


def compact(m: GaussianMap, extra_trees=()):
    """Squeeze dead slots out so that the tail is free again (outside the
    hot loop; pruning only clears bits).  `extra_trees` are dicts (or
    nested dicts/tuples) of per-slot tensors permuted the same way, such as
    Adam's m and v; their dead rows are zeroed, so that a revived slot
    starts with fresh optimizer state, as the reference's cat-with-zeros
    surgery does (gaussian_model.py:450).  Returns the map, or (map,
    *extra_trees) when extra trees are given."""
    C = m.capacity
    order = torch.argsort((~m.live).to(torch.int8), stable=True)
    count = int(m.live.sum())
    keep = torch.arange(C, device=m.live.device) < count

    def perm_zero(x):
        if isinstance(x, dict):
            return {k: perm_zero(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(perm_zero(v) for v in x)
        y = x[order]
        return torch.where(keep.reshape((C,) + (1,) * (y.ndim - 1)), y,
                           torch.zeros_like(y))

    out = m._replace(
        xyz=m.xyz[order], f_dc=m.f_dc[order], f_rest=m.f_rest[order],
        log_scaling=m.log_scaling[order], rotation=m.rotation[order],
        opacity_logit=m.opacity_logit[order],
        trackable=m.trackable[order] & keep, live=keep, n=count)
    extras = tuple(perm_zero(t) for t in extra_trees)
    return (out,) + extras if extras else out
