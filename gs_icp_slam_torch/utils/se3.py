"""SE(3) helpers for the G-ICP Gauss-Newton tracker.

Twist convention: xi = (omega, v) with rotation first; left perturbation
T <- exp(xi^) @ T.  Taylor fallbacks near theta = 0.
"""
from __future__ import annotations

import torch


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    return torch.stack([torch.stack([zero, -wz, wy], -1),
                        torch.stack([wz, zero, -wx], -1),
                        torch.stack([-wy, wx, zero], -1)], dim=-2)


def _safe(small: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(small, torch.ones_like(x), x)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (3,) rotation vector -> (3, 3) rotation matrix."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2)
    K = skew(omega)
    K2 = K @ K
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / _safe(small, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / _safe(small, theta2))
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(6,) twist (omega, v) -> (4, 4) homogeneous transform."""
    omega, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2)
    K = skew(omega)
    K2 = K @ K
    small = theta2 < 1e-12
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / _safe(small, theta2))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / _safe(small, theta2 * theta))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = so3_exp(omega)
    V = eye + b[..., None, None] * K + c[..., None, None] * K2
    t = (V @ v[..., None])[..., 0]
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (4, 4) transform to (..., 3) points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ t[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out
