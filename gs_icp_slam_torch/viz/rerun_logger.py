"""Live visualization via rerun.io (counterpart of
gs_icp_slam_tpu/viz/rerun_logger.py), matching the reference's streaming
(SURVEY §2.16: rr.init("3dgsviewer") + per-frame camera pose / pinhole /
image logging at mp_Tracker.py:128-147, map point logging on keyframes).

The rerun SDK is optional: constructing a RerunLogger without it raises
ImportError with install instructions, and callers only build one behind a
--rerun_viewer flag.  The logger takes host arrays (numpy).
"""
from __future__ import annotations

import numpy as np


class RerunLogger:
    def __init__(self, intr, app_id: str = "3dgsviewer", spawn: bool = True):
        try:
            import rerun as rr
        except ImportError as e:
            raise ImportError(
                "rerun-sdk is not installed; pip install rerun-sdk to use "
                "--rerun_viewer") from e
        self.rr = rr
        self.intr = intr
        rr.init(app_id)
        if spawn:
            try:
                rr.spawn()
            except Exception:
                rr.connect()

    def log_frame(self, i: int, c2w: np.ndarray, rgb: np.ndarray,
                  depth: np.ndarray) -> None:
        """Camera pose + pinhole + image (mp_Tracker.py:128-147)."""
        rr = self.rr
        rr.set_time_sequence("frame", i)
        rr.log("cam/current",
               rr.Transform3D(translation=c2w[:3, 3],
                              mat3x3=c2w[:3, :3]))
        rr.log("cam/current",
               rr.Pinhole(resolution=[self.intr.width, self.intr.height],
                          focal_length=[self.intr.fx, self.intr.fy],
                          principal_point=[self.intr.cx, self.intr.cy]))
        rr.log("cam/current", rr.Image(rgb))

    def log_points(self, i: int, points: np.ndarray,
                   colors: np.ndarray | None = None,
                   path: str = "map/trackable") -> None:
        """Trackable map points on keyframes (mp_Tracker.py:186-189)."""
        rr = self.rr
        rr.set_time_sequence("frame", i)
        rr.log(path, rr.Points3D(points, colors=colors))

    def log_render(self, i: int, image_chw: np.ndarray,
                   path: str = "mapper/render") -> None:
        """Rendered RGB from the mapper (mp_Mapper.py:250-257)."""
        rr = self.rr
        rr.set_time_sequence("frame", i)
        img = np.clip(image_chw.transpose(1, 2, 0) * 255, 0,
                      255).astype(np.uint8)
        rr.log(path, rr.Image(img))
