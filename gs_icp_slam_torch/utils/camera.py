"""Camera model and projection matrices (counterpart of
gs_icp_slam_tpu/utils/camera.py).

The SLAM pipeline works with the world-to-camera rigid transform and pinhole
intrinsics; the OpenGL-style matrices of the reference
(utils/graphics_utils.py:38-77, scene/shared_objs.py:8-41) serve viewers and
map export.

Reference pose convention quirk (kept for the compat helpers only): the
reference's Camera carries R = c2w rotation and t = w2c translation, and
`getWorld2View2(R, t)` builds w2c as [[R^T, t], [0, 1]].
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def world_to_view(R_c2w, t_w2c, device=None) -> torch.Tensor:
    """Build w2c 4x4 from the reference's (R=c2w rotation, t=w2c
    translation), on `device` (by default the inputs' device, the CPU for
    arrays)."""
    R_c2w = torch.as_tensor(R_c2w, device=device)
    t_w2c = torch.as_tensor(t_w2c, dtype=R_c2w.dtype, device=R_c2w.device)
    T = torch.zeros((4, 4), dtype=R_c2w.dtype, device=R_c2w.device)
    T[:3, :3] = R_c2w.T
    T[:3, 3] = t_w2c
    T[3, 3] = 1.0
    return T


def gl_projection_matrix(znear: float, zfar: float, fovx: float,
                         fovy: float) -> np.ndarray:
    """OpenGL-style projection with z_sign=+1 (reference
    graphics_utils.py:51-71)."""
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


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


@dataclass(frozen=True)
class Camera:
    """A posed camera: static intrinsics + a world-to-camera transform, a
    (4, 4) tensor on its device.

    `w2c` maps world -> camera (camera looks down +z, x right, y down — the
    RDF convention the reference uses for Replica/TUM).
    """

    intr: Intrinsics
    w2c: torch.Tensor  # (4, 4)

    @property
    def c2w(self) -> torch.Tensor:
        from .se3 import invert_se3

        return invert_se3(self.w2c)

    @property
    def center(self) -> torch.Tensor:
        """Camera position in world coordinates."""
        return self.c2w[:3, 3]
