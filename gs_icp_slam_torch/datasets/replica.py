"""Replica RGB-D loader (counterpart of gs_icp_slam_tpu/datasets/replica.py).

Layout and conventions from the reference (mp_Tracker.py:337-352,
utils/traj_utils.py:42-53):
  <root>/images/frame%06d.jpg        color
  <root>/depth_images/depth%06d.png  16-bit depth, scale 6553.5
  <root>/traj.txt                    one flattened 4x4 c2w per line

Frames load lazily through PIL (the reference preloads everything with
cv2/open3d; lazy keeps startup O(1)).
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.camera import Intrinsics
from .base import RGBDFrame, RGBDSequence

REPLICA_INTR = Intrinsics(width=1200, height=680, fx=600.0, fy=600.0,
                          cx=599.5, cy=339.5, depth_scale=6553.5,
                          depth_trunc=12.0)


def load_replica_traj(path: str) -> np.ndarray:
    """traj.txt: flattened 4x4 c2w rows (traj_utils.py:42-53)."""
    with open(path) as f:
        rows = [list(map(float, line.split())) for line in f if line.strip()]
    return np.asarray(rows, np.float64).reshape(-1, 4, 4)


class ReplicaSequence(RGBDSequence):
    def __init__(self, root: str, intr: Intrinsics = REPLICA_INTR,
                 max_frames: int | None = None):
        self.root = root
        self.intr = intr
        self.poses = load_replica_traj(os.path.join(root, "traj.txt"))
        names = sorted(n for n in os.listdir(os.path.join(root, "images"))
                       if n.endswith(".jpg"))
        self._frames = [os.path.splitext(n)[0] for n in names]
        if max_frames is not None:
            self._frames = self._frames[:max_frames]

    def __len__(self) -> int:
        return len(self._frames)

    def frame(self, i: int) -> RGBDFrame:
        from PIL import Image

        stem = self._frames[i]  # "frame000123"
        with Image.open(os.path.join(self.root, "images",
                                     stem + ".jpg")) as im:
            rgb = np.asarray(im.convert("RGB"))
        with Image.open(os.path.join(self.root, "depth_images",
                                     "depth" + stem[5:] + ".png")) as im:
            depth = np.asarray(im, dtype=np.float32)
        return RGBDFrame(rgb=rgb, depth=depth, gt_c2w=self.poses[i])
