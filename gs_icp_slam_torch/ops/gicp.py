"""Generalized-ICP frame-to-map registration (counterpart of
gs_icp_slam_tpu/ops/gicp.py).

  * correspondences: kernel K2 (ops.nn_cuda.nn_search_pre) recomputed every
    Gauss-Newton iteration, gated at max_correspondence_distance^2 on the
    squared distance (fast_gicp's kd-tree + threshold gate); the target
    carries a spatial order of its slots (Morton, made once where it is
    built) and the source one of its points (8x8 pixel blocks of the
    grid), which keep K2's chunk bounds tight;
  * the step: Mahalanobis point-to-distribution Gauss-Newton over se(3)
    with left perturbation, as a Python loop with a per-iteration
    convergence check on the fast_gicp epsilons (one host sync per
    iteration);
  * covariances: plane-regularized (ops.covariance); target covariances can
    come from optimized map Gaussians (covariance sharing).

Per-point registration state is channel-first as in the JAX package: the
target stores points (3, T) and covariance components (6, T), so one
(9, S) gather fetches every correspondence, and the accumulation is
component arithmetic on (S,) vectors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..config import GICPConfig
from ..utils.se3 import se3_exp
from .covariance import (cov_to_quat_scale, estimate_covariances,
                         quat_scale_to_reg_cov6, regularize_plane)
from .knn import knn_search, knn_search_grid, resolve_grid_span
from .nn_cuda import morton_order, nn_search_pre

_BIG = 3.4e38


class GICPTarget(NamedTuple):
    """Fixed-capacity target (map) cloud with registration covariances:
    points (3, T); cov6 (6, T) plane-regularized rows [m00, m01, m02, m11,
    m12, m22]; valid (T,); nn_bias (1, T), 0 on valid slots and +3.4e38 on
    invalid ones (kernel K2's reference layout); nn_order (T,) int32, the
    slots in K2's reference order (spatial_order), or None for slot
    order.  The slots themselves stay in place: K2 reports slot indices."""

    points: torch.Tensor
    cov6: torch.Tensor
    valid: torch.Tensor
    nn_bias: torch.Tensor
    nn_order: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.points.shape[1]


class GICPSource(NamedTuple):
    """Per-frame source cloud (trackable subset of the downsampled frame)."""

    points: torch.Tensor  # (S, 3) camera-frame
    cov6: torch.Tensor  # (6, S) plane-regularized components, camera-frame
    quat: torch.Tensor  # (S, 4) xyzw of the raw covariance eigenbasis
    scales: torch.Tensor  # (S, 3) sqrt raw eigenvalues
    valid: torch.Tensor  # (S,) bool
    nn_order: torch.Tensor | None = None  # (S,) int32 K2's query order


def _identity_cov6(n: int, device) -> torch.Tensor:
    c6 = torch.zeros((6, n), dtype=torch.float32, device=device)
    c6[0] = 1.0
    c6[3] = 1.0
    c6[5] = 1.0
    return c6


def empty_target(capacity: int, device="cuda") -> GICPTarget:
    device = resolve_device(device)
    return GICPTarget(points=torch.zeros((3, capacity), device=device),
                      cov6=_identity_cov6(capacity, device),
                      valid=torch.zeros(capacity, dtype=torch.bool, device=device),
                      nn_bias=torch.full((1, capacity), _BIG, device=device))


def _cov_mat_to6(cov: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) symmetric -> (6, N) components."""
    return torch.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                        cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], dim=0)


def spatial_order(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """K2's reference order of a (3, T) cloud: nn_cuda.morton_order on a
    1024^3 grid, so that a run of slots is a compact piece of space, the
    invalid slots last in increasing order.  (T,) int32, a permutation of
    [0, T); one sort, no host sync."""
    return morton_order(points.T, valid, bits=10)


_GRID_ORDERS: dict = {}
_BLOCK = 8  # 8 x 8 pixels: one K2 query group of 64


def grid_block_order(gh: int, gw: int, device) -> torch.Tensor:
    """K2's query order of a row-major (gh, gw) pixel-grid cloud: blocks
    of 8 x 8 pixels, row-major, and the pixels of each block row-major,
    so that K2's groups of 64 queries are compact patches of the image
    rather than strips of a row.  (gh*gw,) int32, made once per grid and
    device."""
    key = (gh, gw, str(device))
    if key not in _GRID_ORDERS:
        p = torch.arange(gh * gw, device=device)
        r, c = p // gw, p % gw
        nbx = -(-gw // _BLOCK)
        k = (((r // _BLOCK) * nbx + c // _BLOCK) * _BLOCK * _BLOCK
             + (r % _BLOCK) * _BLOCK + c % _BLOCK)
        _GRID_ORDERS[key] = torch.argsort(k).to(torch.int32)
    return _GRID_ORDERS[key]


def _build_target(points_nc: torch.Tensor, cov6: torch.Tensor,
                  valid: torch.Tensor, capacity: int | None) -> GICPTarget:
    """points_nc (P, 3), cov6 (6, P), valid (P,) -> GICPTarget of
    `capacity` slots (P when None)."""
    p = points_nc.shape[0]
    tc = capacity if capacity is not None else p
    if tc < p:
        raise ValueError(f"{p} points exceed the target capacity {tc}")
    dev = points_nc.device
    pts = torch.zeros((3, tc), dtype=torch.float32, device=dev)
    pts[:, :p] = points_nc.T
    c6 = _identity_cov6(tc, dev)
    c6[:, :p] = cov6
    v = torch.zeros(tc, dtype=torch.bool, device=dev)
    v[:p] = valid
    bias = torch.where(v, 0.0, _BIG).to(torch.float32)[None].contiguous()
    return GICPTarget(points=pts, cov6=c6, valid=v, nn_bias=bias,
                      nn_order=spatial_order(pts, v))


def make_source(points: torch.Tensor, valid: torch.Tensor, cfg: GICPConfig,
                trackable: torch.Tensor | None = None,
                grid: tuple[int, int] | None = None,
                query_grid: tuple[int, int] | None = None) -> GICPSource:
    """Source covariances (mp_Tracker.py:191-195).  Covariances are
    estimated among `valid` points (all become Gaussians), while
    `trackable` gates registration.  `grid` = (gh, gw) of the downsampled
    frame; with cfg.source_knn == "grid" the neighbour search is the
    image-window one, else the exact k-NN (kernel K3).  The points' grid
    (`query_grid`, else `grid`) orders K2's queries (grid_block_order)."""
    if trackable is None:
        trackable = valid
    if grid is not None and cfg.source_knn == "grid":
        span = resolve_grid_span(cfg.k_neighbors, cfg.grid_knn_span)
        idx, sqd = knn_search_grid(points, valid, grid[0], grid[1],
                                   k=cfg.k_neighbors, span=span)
    else:
        idx, sqd = knn_search(points, points, valid, k=cfg.k_neighbors)
    cov_raw = estimate_covariances(points, idx, valid, neighbor_sqd=sqd,
                                   max_dist=cfg.knn_max_distance)
    quat, scales = cov_to_quat_scale(cov_raw)
    cov_reg = regularize_plane(cov_raw, cfg.plane_eps)
    qg = query_grid or grid
    return GICPSource(points=points, cov6=_cov_mat_to6(cov_reg), quat=quat,
                      scales=scales, valid=trackable,
                      nn_order=None if qg is None else grid_block_order(
                          *qg, points.device))


def target_from_points(points: torch.Tensor, valid: torch.Tensor,
                       cfg: GICPConfig, capacity: int | None = None):
    """Frame-0 target: covariances from the exact k-NN (kernel K3) over the
    world-transformed first cloud, plus the raw-covariance (quat, scale)
    pairs that seed the first Gaussians (mp_Tracker.py:157-169)."""
    idx, sqd = knn_search(points, points, valid, k=cfg.k_neighbors)
    cov_raw = estimate_covariances(points, idx, valid, neighbor_sqd=sqd,
                                   max_dist=cfg.knn_max_distance)
    quat, scales = cov_to_quat_scale(cov_raw)
    cov_reg = regularize_plane(cov_raw, cfg.plane_eps)
    target = _build_target(points, _cov_mat_to6(cov_reg), valid, capacity)
    return target, quat, scales


def target_from_gaussians(xyz: torch.Tensor, quat: torch.Tensor,
                          scales: torch.Tensor, valid: torch.Tensor,
                          cfg: GICPConfig,
                          capacity: int | None = None) -> GICPTarget:
    """Covariance sharing, map -> tracker (set_target_covariances_fromqs,
    mp_Tracker.py:286-288): optimized Gaussian rotations/scales become the
    registration covariances, with no k-NN."""
    cov6 = quat_scale_to_reg_cov6(quat, scales, cfg.plane_eps)
    return _build_target(xyz, cov6, valid, capacity)


def _rotate_cov6(R: torch.Tensor, c6: torch.Tensor):
    """(R Sigma R^T) components from (6, S) components and 3x3 R."""
    c00, c01, c02, c11, c12, c22 = c6
    r = R

    def rowdot(wa, wb, wc):
        return (wa * c00 + wb * c01 + wc * c02,
                wa * c01 + wb * c11 + wc * c12,
                wa * c02 + wb * c12 + wc * c22)

    m0 = rowdot(r[0, 0], r[0, 1], r[0, 2])
    m1 = rowdot(r[1, 0], r[1, 1], r[1, 2])
    m2 = rowdot(r[2, 0], r[2, 1], r[2, 2])

    def coldot(m, wa, wb, wc):
        return m[0] * wa + m[1] * wb + m[2] * wc

    return (coldot(m0, r[0, 0], r[0, 1], r[0, 2]),
            coldot(m0, r[1, 0], r[1, 1], r[1, 2]),
            coldot(m0, r[2, 0], r[2, 1], r[2, 2]),
            coldot(m1, r[1, 0], r[1, 1], r[1, 2]),
            coldot(m1, r[2, 0], r[2, 1], r[2, 2]),
            coldot(m2, r[2, 0], r[2, 1], r[2, 2]))


def _chol_solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled scalar Cholesky solve of the 6x6 Gauss-Newton system (H is
    SPD plus damping), ported as written: the same operation order as the
    JAX version, with the diagonal clamped at 1e-20."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-20))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def _inv3x3_sym6(b00, b01, b02, b11, b12, b22):
    """Cofactor inverse of symmetric 3x3 given as components."""
    A = b11 * b22 - b12 * b12
    B = b02 * b12 - b01 * b22
    C = b01 * b12 - b02 * b11
    det = b00 * A + b01 * B + b02 * C
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, 1e-30)
    D = b00 * b22 - b02 * b02
    E = b01 * b02 - b00 * b12
    F = b00 * b11 - b01 * b01
    return (A * inv_det, B * inv_det, C * inv_det, D * inv_det,
            E * inv_det, F * inv_det)


def _gn_step(T: torch.Tensor, source: GICPSource, target: GICPTarget,
             tgt9: torch.Tensor, cfg: GICPConfig):
    """One Gauss-Newton linearization and update: (T_new, delta, idx, sqd)."""
    R = T[:3, :3]
    p = source.points @ R.T + T[:3, 3]
    idx, sqd = nn_search_pre(p.contiguous(), target.points, target.nn_bias,
                             target.nn_order, source.nn_order)
    w = (source.valid & (sqd < cfg.max_correspondence_distance ** 2)
         ).to(torch.float32)

    g9 = tgt9[:, idx.long()]  # ONE (9, S) gather
    ex = g9[0] - p[:, 0]
    ey = g9[1] - p[:, 1]
    ez = g9[2] - p[:, 2]

    # M = inv(t_cov + R Cs R^T), weighted by w
    rc = _rotate_cov6(R, source.cov6)
    m00, m01, m02, m11, m12, m22 = _inv3x3_sym6(
        g9[3] + rc[0], g9[4] + rc[1], g9[5] + rc[2],
        g9[6] + rc[3], g9[7] + rc[4], g9[8] + rc[5])
    m00, m01, m02 = m00 * w, m01 * w, m02 * w
    m11, m12, m22 = m11 * w, m12 * w, m22 * w

    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    # B = A^T M with A = skew(p)
    b00 = pz * m01 - py * m02
    b01 = pz * m11 - py * m12
    b02 = pz * m12 - py * m22
    b10 = -pz * m00 + px * m02
    b11 = -pz * m01 + px * m12
    b12 = -pz * m02 + px * m22
    b20 = py * m00 - px * m01
    b21 = py * m01 - px * m11
    b22 = py * m02 - px * m12

    # every per-point term of H and g, summed in one reduction
    terms = torch.stack([
        b01 * pz - b02 * py, -b00 * pz + b02 * px, b00 * py - b01 * px,
        -b10 * pz + b12 * px, b10 * py - b11 * px, b20 * py - b21 * px,
        b00, b01, b02, b10, b11, b12, b20, b21, b22,
        m00, m01, m02, m11, m12, m22,
        b00 * ex + b01 * ey + b02 * ez,
        b10 * ex + b11 * ey + b12 * ez,
        b20 * ex + b21 * ey + b22 * ez,
        m00 * ex + m01 * ey + m02 * ez,
        m01 * ex + m11 * ey + m12 * ez,
        m02 * ex + m12 * ey + m22 * ez,
    ])
    s = terms.sum(dim=1)
    H00 = torch.stack([torch.stack([s[0], s[1], s[2]]),
                       torch.stack([s[1], s[3], s[4]]),
                       torch.stack([s[2], s[4], s[5]])])
    H01 = -s[6:15].reshape(3, 3)
    H11 = torch.stack([torch.stack([s[15], s[16], s[17]]),
                       torch.stack([s[16], s[18], s[19]]),
                       torch.stack([s[17], s[19], s[20]])])
    g = torch.cat([s[21:24], -s[24:27]])
    H = torch.cat([torch.cat([H00, H01], dim=1),
                   torch.cat([H01.T, H11], dim=1)], dim=0)
    H = H + cfg.lm_init_lambda * torch.trace(H) * torch.eye(
        6, dtype=H.dtype, device=H.device)
    delta = _chol_solve6(H, -g)
    if cfg.degeneracy_thresh > 0.0:
        # solution remapping (Zhang & Kaess 2016): zero the update along
        # eigendirections of H below thresh * the largest eigenvalue
        evals, evecs = torch.linalg.eigh(H)
        keep = (evals >= cfg.degeneracy_thresh * evals[-1]).to(delta.dtype)
        delta = evecs @ (keep * (evecs.T @ delta))
    return se3_exp(delta) @ T, delta, idx, sqd


def predicted_rotation_deg(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """Angle (degrees) of the rotation between two poses."""
    tr_rel = torch.trace(T1[:3, :3].T @ T2[:3, :3])
    cos_half = torch.sqrt(torch.clamp(1.0 + tr_rel, min=1e-12)) * 0.5
    return 2.0 * torch.rad2deg(torch.arccos(torch.clamp(cos_half, -1.0, 1.0)))


def gicp_align(source: GICPSource, target: GICPTarget,
               init_T: torch.Tensor, cfg: GICPConfig,
               init_T2: torch.Tensor | None = None):
    """Align source onto target from init_T (camera-to-world).

    `init_T2`: the constant-velocity seed of the adaptive motion model.
    The loop starts from init_T2 when the predicted inter-frame rotation
    (the init_T -> init_T2 angle) exceeds cfg.adaptive_trigger_deg, else
    from init_T (the JAX docstring has the measurements behind this).

    Returns (T, n_iters, idx, sqd): the optimized 4x4 transform mapping
    source (camera) points into the target (world) frame, the iteration
    count, and the last linearization's correspondences (what fast_gicp's
    get_source_correspondence returns after align).
    """
    tgt9 = torch.cat([target.points, target.cov6], dim=0)
    T = init_T.to(torch.float32)
    if init_T2 is not None:
        pred = predicted_rotation_deg(init_T, init_T2)
        T = torch.where(pred > cfg.adaptive_trigger_deg,
                        init_T2.to(torch.float32), T)
    S = source.points.shape[0]
    dev = source.points.device
    idx = torch.zeros(S, dtype=torch.int32, device=dev)
    sqd = torch.full((S,), _BIG, dtype=torch.float32, device=dev)
    n_iters = 0
    while n_iters < cfg.max_iterations:
        T, delta, idx, sqd = _gn_step(T, source, target, tgt9, cfg)
        n_iters += 1
        converged = ((delta[:3].abs().max() < cfg.rotation_epsilon)
                     & (delta[3:].abs().max() < cfg.transformation_epsilon))
        if bool(converged):  # the per-iteration host sync
            break
    return T, n_iters, idx, sqd


def source_correspondences(T: torch.Tensor, source_points: torch.Tensor,
                           target: GICPTarget,
                           query_order: torch.Tensor | None = None):
    """Squared NN distance of each transformed source point in the target
    (the fork's get_source_correspondence, mp_Tracker.py:231), which feeds
    the keyframe overlap ratio and the overlap dedup.  Kernel K2;
    query_order is the source's nn_order."""
    p = source_points @ T[:3, :3].T + T[:3, 3]
    return nn_search_pre(p.contiguous(), target.points, target.nn_bias,
                         target.nn_order, query_order)

