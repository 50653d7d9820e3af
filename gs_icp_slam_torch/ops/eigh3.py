"""Closed-form eigendecomposition of batched symmetric 3x3 matrices.

Ported as written in the JAX package (trigonometric eigenvalues, Smith's
algorithm, plus cross-product eigenvectors, all branch-free), not as
`torch.linalg.eigh`: its eigenvector order and signs become the
quaternions that seed the map, so they must match the reference.
Matrices are pre-scaled by their max |entry|; repeated eigenvalues fall
back to orthogonal completion and isotropic inputs to the identity basis.
"""
from __future__ import annotations

import torch

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


def _det3(a: torch.Tensor) -> torch.Tensor:
    """3x3 determinant as the rule of Sarrus, term for term in the order of
    jnp.linalg.det's 3x3 case: acos near +-1 amplifies any rounding
    difference in det into the eigenvalues."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def _eye_like(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=A.dtype, device=A.device)


def eigvals3x3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues (ascending) of symmetric (..., 3, 3) matrices."""
    scale = torch.clamp(torch.amax(torch.abs(A), dim=(-1, -2)), min=1e-30)
    As = A / scale[..., None, None]

    q = (As[..., 0, 0] + As[..., 1, 1] + As[..., 2, 2]) / 3.0
    B = As - q[..., None, None] * _eye_like(A)
    p2 = torch.sum(B * B, dim=(-1, -2)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    safe_p = torch.where(p > 1e-12, p, torch.ones_like(p))
    C = B / safe_p[..., None, None]
    r = torch.clamp(_det3(C) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    lam2 = q + 2.0 * p * torch.cos(phi)  # largest
    lam0 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)  # smallest
    lam1 = 3.0 * q - lam0 - lam2
    vals = torch.stack([lam0, lam1, lam2], dim=-1)
    iso = (p <= 1e-12)[..., None]
    vals = torch.where(iso, torch.stack([q, q, q], dim=-1), vals)
    return vals * scale[..., None]


def _null_vector(M: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """Unit v with M v ~ 0 for near-singular symmetric M (..., 3, 3): the
    largest cross product of row pairs, or `fallback` when all vanish."""
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best12 = n12 > n02
    c_b = torch.where(best12[..., None], c12, c02)
    n_b = torch.where(best12, n12, n02)
    best01 = n01 > n_b
    c = torch.where(best01[..., None], c01, c_b)
    n = torch.where(best01, n01, n_b)
    ok = n > 1e-24
    unit = c / torch.sqrt(torch.where(ok, n, torch.ones_like(n)))[..., None]
    return torch.where(ok[..., None], unit, fallback)


def _any_orthonormal(v: torch.Tensor) -> torch.Tensor:
    """Some unit vector orthogonal to unit v (branch-free)."""
    use_x = torch.abs(v[..., 0]) < 0.9
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device).expand_as(v)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=v.dtype, device=v.device).expand_as(v)
    u = torch.linalg.cross(v, torch.where(use_x[..., None], ex, ey))
    return u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=1e-20)


def eigh3x3(A: torch.Tensor):
    """Full symmetric 3x3 eigendecomposition.

    Returns vals (..., 3) ascending and vecs (..., 3, 3) with COLUMNS the
    corresponding eigenvectors, right-handed (a rotation matrix).
    """
    scale = torch.clamp(torch.amax(torch.abs(A), dim=(-1, -2)), min=1e-30)
    As = A / scale[..., None, None]
    vals_s = eigvals3x3(As)

    eye = _eye_like(A)
    lam0 = vals_s[..., 0]
    lam2 = vals_s[..., 2]
    row_shape = As[..., 0, :].shape

    e_z = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device).expand(row_shape)
    v0 = _null_vector(As - lam0[..., None, None] * eye, fallback=e_z)
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=A.dtype, device=A.device).expand(row_shape)
    v2_raw = _null_vector(As - lam2[..., None, None] * eye, fallback=e_x)
    v2_raw = v2_raw - torch.sum(v2_raw * v0, dim=-1, keepdim=True) * v0
    n2 = torch.linalg.norm(v2_raw, dim=-1, keepdim=True)
    v2 = torch.where(n2 > 1e-10, v2_raw / torch.clamp(n2, min=1e-20),
                     _any_orthonormal(v0))
    v1 = torch.linalg.cross(v2, v0)  # right-handed [v0, v1, v2]

    vecs = torch.stack([v0, v1, v2], dim=-1)
    return vals_s * scale[..., None], vecs
