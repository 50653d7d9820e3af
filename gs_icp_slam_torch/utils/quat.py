"""Quaternion utilities.  Convention: **xyzw** (scalar-last), as in the JAX
package and the reference system (not torch's habitual wxyz).  All
functions are batched over leading dimensions.
"""
from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) to unit length."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion(s) -> rotation matrix/matrices (..., 3, 3); the input
    is normalized first (reference build_rotation)."""
    q = quat_normalize(q)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)], -1),
        torch.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)], -1),
        torch.stack([2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)], -1),
    ]
    return torch.stack(rows, dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix/matrices (..., 3, 3) -> xyzw quaternion(s).

    Branch-free Shepperd's method: all four candidates are computed and the
    one of the largest diagonal pivot is selected with `where`.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    sw = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) * 2.0
    qw_w, qx_w, qy_w, qz_w = 0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw
    sx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 2.0
    qw_x, qx_x, qy_x, qz_x = (m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx
    sy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) * 2.0
    qw_y, qx_y, qy_y, qz_y = (m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy
    sz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) * 2.0
    qw_z, qx_z, qy_z, qz_z = (m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22

    def sel(a, b, c, d):
        return torch.where(cond0, a, torch.where(cond1, b, torch.where(cond2, c, d)))

    q = torch.stack([sel(qx_w, qx_x, qx_y, qx_z), sel(qy_w, qy_x, qy_y, qy_z),
                     sel(qz_w, qz_x, qz_y, qz_z), sel(qw_w, qw_x, qw_y, qw_z)], -1)
    return quat_normalize(q)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 (x) q2, xyzw layout, broadcasting over batches."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2
    z = w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    return torch.stack([x, y, z, w], dim=-1)
