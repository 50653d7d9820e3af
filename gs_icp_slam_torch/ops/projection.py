"""Gaussian preprocessing for rasterization: the EWA splatting math
(counterpart of gs_icp_slam_tpu/ops/projection.py).

  * world -> camera transform, frustum cull at z <= znear (0.2)
  * 3D covariance from (quat, scale): Sigma = R S S^T R^T
  * EWA projection Sigma' = J W Sigma W^T J^T (2x2), + 0.3 px low-pass
  * conic = inverse of Sigma', radius = ceil(3 sqrt(lambda_max))
  * SH -> RGB with the 0.5 offset and clamp-to-positive

Differentiable with autograd.  Clamps that gradients pass through use
torch.maximum / torch.minimum, which split the gradient at a tie as
jnp.maximum / jnp.minimum do (torch.clamp passes all of it): an RGB of
exactly 0 after the 0.5 offset is common, since rgb_to_sh(0) + 0.5 rounds
to 0 for black pixels.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ..utils.quat import quat_to_rotmat
from ..utils.sh import C0, eval_sh

# Compositing constants of the CUDA rasterizer
ALPHA_MIN = 1.0 / 255.0   # splats fainter than this are skipped
ALPHA_MAX = 0.99          # alpha saturation clamp
T_EPS = 1e-4              # stop compositing when transmittance drops below


def tile_rect(mx: torch.Tensor, my: torch.Tensor, radius: torch.Tensor,
              ntx: int, nty: int, tile: int, span: int):
    """Tile rectangle covered by each splat (CUDA getRect), clamped to a
    span x span window: anchored at the true rect whenever it fits in the
    span window, else centred on the splat's own tile.  Returns inclusive
    float bounds (tx0, ty0, tx1, ty1); radius 0 gives tx1 < tx0."""
    tx_min = torch.floor((mx - radius) / tile)
    tx_max = torch.floor((mx + radius) / tile)
    ty_min = torch.floor((my - radius) / tile)
    ty_max = torch.floor((my + radius) / tile)
    ctx = torch.floor(mx / tile)
    cty = torch.floor(my / tile)
    half = (span - 1) // 2
    fits_x = (tx_max - tx_min) <= (span - 1)
    fits_y = (ty_max - ty_min) <= (span - 1)
    ax = torch.where(fits_x, tx_min, torch.maximum(tx_min, ctx - half))
    ay = torch.where(fits_y, ty_min, torch.maximum(ty_min, cty - half))
    tx0 = torch.clamp(ax, 0, ntx - 1)
    ty0 = torch.clamp(ay, 0, nty - 1)
    tx1 = torch.clamp(torch.minimum(tx_max, tx0 + (span - 1)), max=ntx - 1)
    ty1 = torch.clamp(torch.minimum(ty_max, ty0 + (span - 1)), max=nty - 1)
    empty = radius <= 0.0
    tx1 = torch.where(empty, tx0 - 1.0, tx1)
    ty1 = torch.where(empty, ty0 - 1.0, ty1)
    return tx0, ty0, tx1, ty1


@lru_cache(maxsize=None)
def _scalar(c: float, dtype: torch.dtype, device: torch.device):
    """A 0-dim constant, made once per device: a fresh one per call would
    be a host-to-device copy in every projection."""
    return torch.tensor(c, dtype=dtype, device=device)


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.maximum(x, _scalar(c, x.dtype, x.device))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(_max(x, lo), _scalar(hi, x.dtype, x.device))


class Splats2D(NamedTuple):
    """Per-Gaussian screen-space quantities (all length N, masked)."""

    mean2d: torch.Tensor   # (N, 2) pixel coordinates
    conic: torch.Tensor    # (N, 3) upper-triangular inverse 2D covariance
    radius: torch.Tensor   # (N,) int32 pixel radius (0 = culled)
    depth: torch.Tensor    # (N,) camera-space z
    rgb: torch.Tensor      # (N, 3) decoded colour
    opacity: torch.Tensor  # (N,) sigmoid-activated opacity
    visible: torch.Tensor  # (N,) bool: survives the frustum cull


def covariance_3d(quat: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T from xyzw quaternion and linear scales."""
    R = quat_to_rotmat(quat)
    return torch.einsum("...ij,...j,...kj->...ik", R, scale * scale, R)


def _cov3d_components(quat: torch.Tensor, scale: torch.Tensor):
    """Symmetric Sigma = R S^2 R^T as six (N,) components."""
    n = _max(torch.sqrt(torch.sum(quat * quat, dim=-1)), 1e-12)
    x, y, z, w = (quat[:, 0] / n, quat[:, 1] / n, quat[:, 2] / n,
                  quat[:, 3] / n)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    s0 = scale[:, 0] ** 2
    s1 = scale[:, 1] ** 2
    s2 = scale[:, 2] ** 2
    sxx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    sxy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    sxz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    syy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    syz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    szz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return sxx, sxy, sxz, syy, syz, szz


def project_gaussians_packed(xyz: torch.Tensor, quat: torch.Tensor,
                             scale: torch.Tensor, opacity: torch.Tensor,
                             sh: torch.Tensor, sh_degree: int,
                             w2c: torch.Tensor, fx: float, fy: float,
                             cx: float, cy: float, width: int, height: int,
                             live: torch.Tensor, znear: float = 0.2,
                             scale_modifier: float = 1.0):
    """Channel-first preprocess of N Gaussians for one view.

    Returns (attr (10, N) float32, radius (N,) int32, visible (N,) bool),
    attr rows [mx, my, conic_a, conic_b, conic_c, r, g, b, opacity, depth].
    sh is (N, (deg+1)^2, 3); dead slots (live False) are culled.
    """
    R = w2c[:3, :3]
    tvec = w2c[:3, 3]
    t = xyz @ R.T + tvec
    tx_, ty_, z = t[:, 0], t[:, 1], t[:, 2]
    in_front = z > znear

    safe_z = torch.where(in_front, z, 1.0)
    inv_z = 1.0 / safe_z
    mx = fx * tx_ * inv_z + cx
    my = fy * ty_ * inv_z + cy

    lim_x = 1.3 * (width / (2.0 * fx))
    lim_y = 1.3 * (height / (2.0 * fy))
    txz = _clip(tx_ * inv_z, -lim_x, lim_x)
    tyz = _clip(ty_ * inv_z, -lim_y, lim_y)

    sxx, sxy, sxz, syy, syz, szz = _cov3d_components(quat, scale * scale_modifier)

    w00, w01, w02 = R[0, 0], R[0, 1], R[0, 2]
    w10, w11, w12 = R[1, 0], R[1, 1], R[1, 2]
    w20, w21, w22 = R[2, 0], R[2, 1], R[2, 2]

    def row(wa, wb, wc):
        return (wa * sxx + wb * sxy + wc * sxz,
                wa * sxy + wb * syy + wc * syz,
                wa * sxz + wb * syz + wc * szz)

    m00, m01, m02 = row(w00, w01, w02)
    m10, m11, m12 = row(w10, w11, w12)
    m20, m21, m22 = row(w20, w21, w22)
    a = m00 * w00 + m01 * w01 + m02 * w02
    b = m00 * w10 + m01 * w11 + m02 * w12
    c = m00 * w20 + m01 * w21 + m02 * w22
    d = m10 * w10 + m11 * w11 + m12 * w12
    e = m10 * w20 + m11 * w21 + m12 * w22
    f = m20 * w20 + m21 * w21 + m22 * w22

    j00 = fx * inv_z
    j02 = -fx * txz * inv_z
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z

    c00 = j00 * (j00 * a + j02 * c) + j02 * (j00 * c + j02 * f) + 0.3
    c01 = j11 * (j00 * b + j02 * e) + j12 * (j00 * c + j02 * f)
    c11 = j11 * (j11 * d + j12 * e) + j12 * (j11 * e + j12 * f) + 0.3

    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    conic_a = c11 * inv_det
    conic_b = -c01 * inv_det
    conic_c = c00 * inv_det

    mid = 0.5 * (c00 + c11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))

    on_screen = ((mx > -radius_f) & (mx < width + radius_f)
                 & (my > -radius_f) & (my < height + radius_f))
    visible = live & in_front & det_ok & on_screen
    radius = torch.where(visible, radius_f, 0.0).to(torch.int32)

    if sh_degree == 0:
        rr = _max(C0 * sh[:, 0, 0] + 0.5, 0.0)
        gg = _max(C0 * sh[:, 0, 1] + 0.5, 0.0)
        bb = _max(C0 * sh[:, 0, 2] + 0.5, 0.0)
    else:
        campos = -tvec @ R
        dirs = xyz - campos
        dirs = dirs / _max(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                           1e-12)
        rgb = _max(eval_sh(sh_degree, sh.transpose(-1, -2), dirs) + 0.5, 0.0)
        rr, gg, bb = rgb[:, 0], rgb[:, 1], rgb[:, 2]

    attr = torch.stack([mx, my, conic_a, conic_b, conic_c, rr, gg, bb,
                        opacity, z], dim=0)
    return attr, radius, visible


def project_gaussians(xyz: torch.Tensor, quat: torch.Tensor,
                      scale: torch.Tensor, opacity: torch.Tensor,
                      sh: torch.Tensor, sh_degree: int, w2c: torch.Tensor,
                      fx: float, fy: float, cx: float, cy: float, width: int,
                      height: int, live: torch.Tensor, znear: float = 0.2,
                      scale_modifier: float = 1.0) -> Splats2D:
    """Preprocess N Gaussians for one view: the struct-of-rows view of
    project_gaussians_packed, for the dense reference renderer
    (ops/rasterize_ref.py) and tests.  quat (N, 4) xyzw, scale (N, 3)
    linear extents, opacity (N,) in [0, 1], sh (N, (deg+1)^2, 3), w2c
    (4, 4); dead slots (live False) are culled."""
    attr, radius, visible = project_gaussians_packed(
        xyz, quat, scale, opacity, sh, sh_degree, w2c, fx, fy, cx, cy,
        width, height, live, znear, scale_modifier)
    return Splats2D(mean2d=attr[0:2].T, conic=attr[2:5].T, radius=radius,
                    depth=attr[9], rgb=attr[5:8].T, opacity=attr[8],
                    visible=visible)
