"""Pinhole intrinsics (counterpart of gs_icp_slam_tpu/utils/camera.py).

The SLAM pipeline works with the world-to-camera rigid transform and these
intrinsics; the OpenGL helpers of the JAX module serve viewers and come
with them in a later slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


@dataclass(frozen=True)
class Intrinsics:
    """Static pinhole intrinsics for one dataset/sensor."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    depth_scale: float = 1.0
    depth_trunc: float = 100.0

    @property
    def fovx(self) -> float:
        return focal2fov(self.fx, self.width)

    @property
    def fovy(self) -> float:
        return focal2fov(self.fy, self.height)

    @property
    def tan_fovx(self) -> float:
        return math.tan(self.fovx / 2.0)

    @property
    def tan_fovy(self) -> float:
        return math.tan(self.fovy / 2.0)

    def matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )
