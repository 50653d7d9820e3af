"""Absolute trajectory error, TUM protocol.

Matches the reference's evaluate_ate (mp_Tracker.py:441-480): rigid Horn/SVD
alignment of the translation components only (no scale), then RMSE of the
aligned point-wise differences.  The reference multiplies by 100 when
printing (cm); we return meters and let callers scale.
"""
from __future__ import annotations

import numpy as np


def align_horn(model: np.ndarray, data: np.ndarray):
    """Find rigid (R, t) minimizing ||R @ model + t - data||.

    Args:
      model, data: (N, 3) corresponding 3D points (trajectory translations).
    Returns:
      R (3, 3), t (3,), trans_error (N,) per-point residual norms.
    """
    model = np.asarray(model, np.float64).T  # (3, N)
    data = np.asarray(data, np.float64).T
    model_zc = model - model.mean(axis=1, keepdims=True)
    data_zc = data - data.mean(axis=1, keepdims=True)
    W = model_zc @ data_zc.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    R = U @ S @ Vh
    t = data.mean(axis=1) - R @ model.mean(axis=1)
    aligned = R @ model + t[:, None]
    err = np.linalg.norm(aligned - data, axis=0)
    return R, t, err


def ate_rmse(gt_poses: np.ndarray, est_poses: np.ndarray) -> float:
    """RMSE (meters) after Horn alignment of est onto gt translations.

    gt_poses/est_poses: (N, 4, 4) c2w; only [:3, 3] is used (the reference
    evaluates translation-only, mp_Tracker.py:465-480).
    """
    n = min(len(gt_poses), len(est_poses))
    gt = np.asarray(gt_poses)[:n, :3, 3]
    est = np.asarray(est_poses)[:n, :3, 3]
    _, _, err = align_horn(est, gt)
    return float(np.sqrt(np.mean(err ** 2)))
