"""Absolute trajectory error, TUM protocol: a frozen copy of the port's
eval/ate.py.  Rigid Horn/SVD alignment of the translations (no scale),
then the RMSE of the aligned differences, in metres."""
from __future__ import annotations

import numpy as np


def align_horn(model: np.ndarray, data: np.ndarray):
    """(R, t, per-point residual norms) minimising ||R model + t - data||
    over (N, 3) corresponding points."""
    model = np.asarray(model, np.float64).T
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
    err = np.linalg.norm(R @ model + t[:, None] - data, axis=0)
    return R, t, err


def ate_rmse(gt_poses: np.ndarray, est_poses: np.ndarray) -> float:
    """RMSE (m) after Horn alignment of est onto gt; (N, 4, 4) c2w poses,
    translations only."""
    n = min(len(gt_poses), len(est_poses))
    gt = np.asarray(gt_poses)[:n, :3, 3]
    est = np.asarray(est_poses)[:n, :3, 3]
    _, _, err = align_horn(est, gt)
    return float(np.sqrt(np.mean(err ** 2)))
