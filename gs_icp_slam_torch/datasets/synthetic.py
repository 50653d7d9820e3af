"""Procedural RGB-D sequence: a textured box room with an analytic camera
trajectory (counterpart of gs_icp_slam_tpu/datasets/synthetic.py, numpy
only, the same pixels for the same arguments).

The environment has no Replica/TUM data (zero egress), so tests and the
benchmark drive the SLAM stack with this scene instead.  Geometry is an
axis-aligned box viewed from inside; depth is the exact ray/box exit
distance (z-depth, like a real RGB-D sensor), and color is a smooth 3D
procedural texture of the hit point, so both G-ICP (planes + depth) and the
gaussian mapper (smooth appearance) behave as they do on real data.

No counterpart in the reference (it has no tests, SURVEY §4); the closest
analogue is the role Replica room0 plays in replica.sh.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.camera import Intrinsics
from .base import RGBDFrame, RGBDSequence


@dataclass(frozen=True)
class SyntheticScene:
    """Box extents (meters) and texture frequencies."""

    # y half-extent below the vertical frustum reach so floor+ceiling are
    # always visible: a view of a single wall is planar-degenerate for G-ICP
    half_extent: tuple = (2.0, 1.0, 2.0)
    tex_freq: float = 1.7
    depth_scale: float = 1000.0  # raw depth = mm, like TUM/Replica pngs


def _texture(p: np.ndarray, freq: float) -> np.ndarray:
    """Smooth RGB texture of 3D points (N, 3) -> (N, 3) in [0, 1]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.28 * np.sin(freq * (x + 0.7 * z)) + 0.14 * np.sin(3.1 * freq * y + 1.0)
    g = 0.5 + 0.28 * np.sin(freq * (y + 0.9 * x) + 2.1) + 0.14 * np.sin(2.3 * freq * z)
    b = 0.5 + 0.28 * np.sin(freq * (z + 0.8 * y) + 4.2) + 0.14 * np.sin(2.9 * freq * x + 0.5)
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def _ray_box_exit(origin: np.ndarray, dirs: np.ndarray,
                  half: np.ndarray) -> np.ndarray:
    """Distance (in units of |dirs|) from origin to the box boundary along
    each ray, for origins inside the box.  dirs (..., 3) need not be unit —
    with camera rays of the form (xn, yn, 1) the result IS the z-depth."""
    with np.errstate(divide="ignore"):
        t_lo = (-half - origin) / dirs
        t_hi = (half - origin) / dirs
    t_exit = np.maximum(t_lo, t_hi)  # per-axis positive crossing
    return np.min(t_exit, axis=-1)


def _camera_rays(intr: Intrinsics) -> np.ndarray:
    u = np.arange(intr.width, dtype=np.float64)
    v = np.arange(intr.height, dtype=np.float64)
    gu, gv = np.meshgrid(u, v)
    xn = (gu - intr.cx) / intr.fx
    yn = (gv - intr.cy) / intr.fy
    return np.stack([xn, yn, np.ones_like(xn)], axis=-1)  # (H, W, 3)


def _look_rotation(forward: np.ndarray, up_hint=(0.0, -1.0, 0.0)) -> np.ndarray:
    """c2w rotation whose +z is `forward` (RDF camera: x right, y down)."""
    z = forward / np.linalg.norm(forward)
    x = np.cross(np.asarray(up_hint, np.float64) * -1.0, z)  # right = down x z
    if np.linalg.norm(x) < 1e-9:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


class SyntheticSequence(RGBDSequence):
    def __init__(self, intr: Intrinsics, scene: SyntheticScene,
                 num_frames: int, radius: float = 0.7,
                 angular_step: float = 0.02, noise_depth: float = 0.0,
                 seed: int = 0, trajectory: str = "sweep"):
        self.intr = intr
        self.scene = scene
        self.num_frames = num_frames
        self.radius = radius
        self.angular_step = angular_step
        self.noise_depth = noise_depth
        self.seed = seed
        self.trajectory = trajectory
        self._rays = _camera_rays(intr)
        self._half = np.asarray(scene.half_extent, np.float64)

    def __len__(self) -> int:
        return self.num_frames

    def pose(self, i: int) -> np.ndarray:
        """Smooth orbit inside the box with gentle bobbing + panning.

        trajectory="sweep" (default, the bench scene): the yaw sweeps
        continuously, so long sequences eventually DWELL on a single
        wall — a geometrically degenerate stretch no geometry-only ICP
        (fast_gicp included) can track through (see
        GICPConfig.degeneracy_thresh).  trajectory="corner" oscillates
        the yaw about a box corner so every frame keeps >= 2 walls in
        view: the long-run stability scene (scripts/long_run.py),
        matching how Replica rooms always keep structure in frame."""
        a = self.angular_step * i
        yaw0 = 0.55  # initial yaw so frame 0 already sees a wall corner
        center = np.array([self.radius * np.sin(a),
                           0.2 * np.sin(0.7 * a),
                           self.radius * (np.cos(a) - 1.0) * 0.5])
        if self.trajectory == "corner":
            # oscillate about the +x/+z corner direction (pi/4), never
            # closer than ~0.4 rad to a wall normal -> >= 2 walls visible
            yaw = 0.785 + 0.35 * np.sin(0.9 * a)
        else:
            yaw = yaw0 + a + 0.4 * np.sin(0.5 * a)
        look_dir = np.array([np.sin(yaw),
                             0.15 * np.sin(0.9 * a),
                             np.cos(yaw)])
        c2w = np.eye(4)
        c2w[:3, :3] = _look_rotation(look_dir)
        c2w[:3, 3] = center
        return c2w

    def frame(self, i: int) -> RGBDFrame:
        c2w = self.pose(i)
        dirs_w = self._rays @ c2w[:3, :3].T  # (H, W, 3), z-component scale 1
        origin = c2w[:3, 3]
        zdepth = _ray_box_exit(origin, dirs_w, self._half)  # (H, W)
        hits = origin + zdepth[..., None] * dirs_w
        rgb = (_texture(hits, self.scene.tex_freq) * 255).astype(np.uint8)
        if self.noise_depth > 0.0:
            rng = np.random.default_rng(self.seed + i)
            zdepth = zdepth * (1.0 + self.noise_depth * rng.standard_normal(zdepth.shape))
        raw = (zdepth * self.scene.depth_scale).astype(np.float32)
        return RGBDFrame(rgb=rgb, depth=raw, gt_c2w=c2w)


def synthetic_sequence(width: int = 320, height: int = 240,
                       num_frames: int = 60, noise_depth: float = 0.0,
                       **kw) -> SyntheticSequence:
    scene = SyntheticScene()
    f = 0.58 * width  # ~82 deg horizontal FoV
    intr = Intrinsics(width=width, height=height, fx=f, fy=f,
                      cx=(width - 1) / 2.0, cy=(height - 1) / 2.0,
                      depth_scale=scene.depth_scale, depth_trunc=8.0)
    return SyntheticSequence(intr, scene, num_frames,
                             noise_depth=noise_depth, **kw)
