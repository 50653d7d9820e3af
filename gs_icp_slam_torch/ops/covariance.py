"""Per-point covariance estimation and the covariance <-> (quat, scale)
bridge of the paper's covariance sharing.

  * estimate_covariances    ~ fast_gicp calculate_*_covariance_with_filter
  * cov_to_quat_scale       ~ get_*_rotationsq / get_*_scales
  * quat_scale_to_reg_cov6  ~ set_target_covariances_fromqs (and
    quat_scale_to_reg_cov, the same as (N, 3, 3) matrices)
  * regularize_plane: eigenvalues -> (eps, 1, 1) ascending, the G-ICP plane
    prior (fast_gicp RegularizationMethod PLANE, eps = 1e-3).

Scales exported to the mapper are sqrt(eigenvalues) of the RAW covariance,
while registration uses the regularized one.
"""
from __future__ import annotations

import torch

from ..utils.quat import quat_to_rotmat, rotmat_to_quat
from .eigh3 import eigh3x3


def estimate_covariances(points: torch.Tensor, neighbor_idx: torch.Tensor,
                         valid: torch.Tensor,
                         neighbor_sqd: torch.Tensor | None = None,
                         max_dist: float | None = None) -> torch.Tensor:
    """Biased sample covariance (N, 3, 3) of each point's k neighbours
    (neighbor_idx (N, k), self included).  Invalid points get the identity.
    With `max_dist` (linear units) below 1e4 and `neighbor_sqd` given,
    neighbours beyond it are left out (fast_gicp set_max_knn_distance)."""
    nbrs = points[neighbor_idx.long()]  # (N, k, 3)
    k = neighbor_idx.shape[1]
    if max_dist is not None and max_dist < 1e4 and neighbor_sqd is not None:
        keep = (neighbor_sqd <= max_dist * max_dist)[..., None]
        cnt = torch.clamp(keep.sum(dim=1), min=1).to(points.dtype)
        mean = torch.where(keep, nbrs, 0.0).sum(dim=1, keepdim=True) / cnt[:, None]
        centered = torch.where(keep, nbrs - mean, 0.0)
        cov = torch.einsum("nki,nkj->nij", centered, centered) / cnt[..., None]
    else:
        mean = nbrs.mean(dim=1, keepdim=True)
        centered = nbrs - mean
        cov = torch.einsum("nki,nkj->nij", centered, centered) / k
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    return torch.where(valid[:, None, None], cov, eye)


def regularize_plane(cov: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """G-ICP plane regularization: C -> V diag(eps, 1, 1) V^T (ascending)."""
    _, vecs = eigh3x3(cov)
    d = torch.tensor([eps, 1.0, 1.0], dtype=cov.dtype, device=cov.device)
    return torch.einsum("...ij,j,...kj->...ik", vecs, d, vecs)


def cov_to_quat_scale(cov: torch.Tensor):
    """Raw covariances -> (xyzw quat, sqrt-eigenvalue scales), columns of
    the rotation in ascending eigenvalue order."""
    vals, vecs = eigh3x3(cov)
    scales = torch.sqrt(torch.clamp(vals, min=1e-12))
    return rotmat_to_quat(vecs), scales


def quat_scale_to_cov(quat: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """C = R diag(s^2) R^T."""
    R = quat_to_rotmat(quat)
    return torch.einsum("...ij,...j,...kj->...ik", R, scales * scales, R)


def quat_scale_to_reg_cov(quat: torch.Tensor, scales: torch.Tensor,
                          eps: float = 1e-3) -> torch.Tensor:
    """Plane-regularized covariance (..., 3, 3) directly from (quat,
    scale), no eigh: C = R diag(s^2) R^T is already an eigendecomposition,
    so the smallest s^2 (the first of a tie) becomes eps and the others 1
    (set_target_covariances_fromqs, mp_Tracker.py:288)."""
    R = quat_to_rotmat(quat)
    amin = torch.argmin(scales * scales, dim=-1)
    d = torch.where(torch.arange(3, device=R.device) == amin[..., None],
                    eps, 1.0).to(R.dtype)
    return torch.einsum("...ij,...j,...kj->...ik", R, d, R)


def quat_scale_to_reg_cov6(quat: torch.Tensor, scales: torch.Tensor,
                           eps: float = 1e-3) -> torch.Tensor:
    """Plane-regularized covariance components (6, N) from (quat, scale),
    rows [m00, m01, m02, m11, m12, m22]: C = R diag(s^2) R^T is already an
    eigendecomposition, so the smallest s^2 becomes eps and the others 1."""
    n = torch.clamp(torch.sqrt(torch.sum(quat * quat, dim=-1)), min=1e-12)
    x, y, z, w = (quat[:, 0] / n, quat[:, 1] / n, quat[:, 2] / n, quat[:, 3] / n)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    amin = torch.argmin(scales * scales, dim=-1)
    one = torch.ones_like(x)
    d0 = torch.where(amin == 0, eps, one)
    d1 = torch.where(amin == 1, eps, one)
    d2 = torch.where(amin == 2, eps, one)
    m00 = d0 * r00 * r00 + d1 * r01 * r01 + d2 * r02 * r02
    m01 = d0 * r00 * r10 + d1 * r01 * r11 + d2 * r02 * r12
    m02 = d0 * r00 * r20 + d1 * r01 * r21 + d2 * r02 * r22
    m11 = d0 * r10 * r10 + d1 * r11 * r11 + d2 * r12 * r12
    m12 = d0 * r10 * r20 + d1 * r11 * r21 + d2 * r12 * r22
    m22 = d0 * r20 * r20 + d1 * r21 * r21 + d2 * r22 * r22
    return torch.stack([m00, m01, m02, m11, m12, m22], dim=0)
