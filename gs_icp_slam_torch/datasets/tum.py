"""TUM RGB-D loader with timestamp association (counterpart of
gs_icp_slam_tpu/datasets/tum.py).

Conventions from the reference TrajManager (utils/traj_utils.py:63-137):
  * rgb.txt / depth.txt / groundtruth.txt (or pose.txt) listings
  * rgb<->depth<->pose associated by nearest timestamp, max_dt = 0.08
  * frames subsampled so consecutive kept frames are > 1/32 s apart
  * pose rows: tx ty tz qx qy qz qw (xyzw) -> c2w
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.camera import Intrinsics
from ..utils.quat import quat_to_rotmat
from .base import RGBDFrame, RGBDSequence

TUM_FR1_INTR = Intrinsics(width=640, height=480, fx=517.3, fy=516.5,
                          cx=318.6, cy=255.3, depth_scale=5000.0,
                          depth_trunc=6.0)


def _parse_list(path: str, skiprows: int = 0) -> np.ndarray:
    rows = []
    with open(path) as f:
        for li, line in enumerate(f):
            if li < skiprows or line.startswith("#") or not line.strip():
                continue
            rows.append(line.split())
    return np.asarray(rows, dtype=np.str_)


def associate_frames(t_img, t_depth, t_pose, max_dt: float = 0.08):
    """Nearest-timestamp association (traj_utils.py:124-140)."""
    out = []
    for i, t in enumerate(t_img):
        j = int(np.argmin(np.abs(t_depth - t)))
        k = int(np.argmin(np.abs(t_pose - t)))
        if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
            out.append((i, j, k))
    return out


def pose_from_tq(pvec: np.ndarray) -> np.ndarray:
    """[tx ty tz qx qy qz qw] -> 4x4 c2w (traj_utils.py:55-62); the
    rotation in float32, as the JAX loader computes it."""
    pose = np.eye(4)
    q = torch.from_numpy(np.asarray(pvec[3:7], np.float32))
    pose[:3, :3] = quat_to_rotmat(q).numpy()
    pose[:3, 3] = pvec[:3]
    return pose


class TumSequence(RGBDSequence):
    def __init__(self, root: str, intr: Intrinsics = TUM_FR1_INTR,
                 frame_rate: float = 32.0, max_frames: int | None = None):
        self.root = root
        self.intr = intr

        pose_file = os.path.join(root, "groundtruth.txt")
        if not os.path.isfile(pose_file):
            pose_file = os.path.join(root, "pose.txt")
        img = _parse_list(os.path.join(root, "rgb.txt"))
        dep = _parse_list(os.path.join(root, "depth.txt"))
        pose = _parse_list(pose_file, skiprows=1)
        t_img = img[:, 0].astype(np.float64)
        t_dep = dep[:, 0].astype(np.float64)
        t_pose = pose[:, 0].astype(np.float64)
        pose_vecs = pose[:, 1:].astype(np.float64)

        assoc = associate_frames(t_img, t_dep, t_pose)
        keep = [0]
        for a in range(1, len(assoc)):
            t0 = t_img[assoc[keep[-1]][0]]
            t1 = t_img[assoc[a][0]]
            if t1 - t0 > 1.0 / frame_rate:
                keep.append(a)

        self.color_paths, self.depth_paths, poses = [], [], []
        for ix in keep:
            i, j, k = assoc[ix]
            self.color_paths.append(os.path.join(root, str(img[i, 1])))
            self.depth_paths.append(os.path.join(root, str(dep[j, 1])))
            poses.append(pose_from_tq(pose_vecs[k]))
        self.poses = np.asarray(poses)
        if max_frames is not None:
            self.color_paths = self.color_paths[:max_frames]
            self.depth_paths = self.depth_paths[:max_frames]
            self.poses = self.poses[:max_frames]

    def __len__(self) -> int:
        return len(self.color_paths)

    def frame(self, i: int) -> RGBDFrame:
        from PIL import Image

        with Image.open(self.color_paths[i]) as im:
            rgb = np.asarray(im.convert("RGB"))
        with Image.open(self.depth_paths[i]) as im:
            depth = np.asarray(im, dtype=np.float32)
        return RGBDFrame(rgb=rgb, depth=depth, gt_c2w=self.poses[i])
