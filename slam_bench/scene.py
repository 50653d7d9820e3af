"""The benchmark's RGB-D traffic: a textured box room seen by a moving
RGB-D sensor, rendered on the card in PyTorch.

A frozen rewrite of the port's procedural sequence
(gs_icp_slam_torch/datasets/synthetic.py, trajectory "corner"): the same
box, texture, ray/box depth and camera path, with the path's two phase
rates and the sensor's depth noise and quantisation as parameters.  With
`phase_step = s`, `yaw_step = 0.9 s`, `yaw_amp = 0.35`, no noise and no
quantisation it gives that sequence's pixels (slam_bench/tests checks
this at a small size).  Nothing here imports the program.

Depth noise follows the Kinect-v1 axial model of Nguyen, Izadi and
Lovell (3DIMPVT 2012): sigma(z) = 0.0012 + 0.0019 (z - 0.4)^2 metres,
drawn per pixel from a torch.Generator on the card seeded from --seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Camera:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    depth_scale: float


@dataclass(frozen=True)
class Path:
    """The "corner" path: the centre orbits on an ellipse of `radius`
    (phase a = phase_step * i), the view yaws about the +x/+z corner of
    the box (phase b = yaw_step * i) so that two walls stay in view."""

    phase_step: float
    yaw_step: float
    yaw_amp: float = 0.35
    radius: float = 0.7


@dataclass(frozen=True)
class Room:
    half_extent: tuple = (2.0, 1.0, 2.0)
    tex_freq: float = 1.7


def look_rotation(forward: np.ndarray) -> np.ndarray:
    """c2w rotation whose +z is `forward` (x right, y down)."""
    z = forward / np.linalg.norm(forward)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    if np.linalg.norm(x) < 1e-9:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


def pose(path: Path, i: int) -> np.ndarray:
    """(4, 4) float64 camera-to-world pose of frame i."""
    a = path.phase_step * i
    b = path.yaw_step * i
    center = np.array([path.radius * math.sin(a), 0.2 * math.sin(0.7 * a),
                       path.radius * (math.cos(a) - 1.0) * 0.5])
    yaw = 0.785 + path.yaw_amp * math.sin(b)
    look = np.array([math.sin(yaw), 0.15 * math.sin(b), math.cos(yaw)])
    c2w = np.eye(4)
    c2w[:3, :3] = look_rotation(look)
    c2w[:3, 3] = center
    return c2w


def _texture(p: torch.Tensor, freq: float) -> torch.Tensor:
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = (0.5 + 0.28 * torch.sin(freq * (x + 0.7 * z))
         + 0.14 * torch.sin(3.1 * freq * y + 1.0))
    g = (0.5 + 0.28 * torch.sin(freq * (y + 0.9 * x) + 2.1)
         + 0.14 * torch.sin(2.3 * freq * z))
    b = (0.5 + 0.28 * torch.sin(freq * (z + 0.8 * y) + 4.2)
         + 0.14 * torch.sin(2.9 * freq * x + 0.5))
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def kinect_v1_sigma(z: torch.Tensor) -> torch.Tensor:
    return 0.0012 + 0.0019 * (z - 0.4) ** 2


def render_frames(cam: Camera, room: Room, path: Path, n: int, *,
                  noise: str, quantize: bool, seed: int, device,
                  chunk: int = 8):
    """Frames 0..n-1 on `device`, copied to the host: rgb (n, H, W, 3)
    uint8, depth (n, H, W) float32 raw units, gt (n, 4, 4) float64 c2w.
    noise is "none" or "kinect_v1"; quantize rounds raw depth to whole
    units of 1/depth_scale metres, as a sensor's 16-bit image does."""
    if noise not in ("none", "kinect_v1"):
        raise ValueError(f"unknown depth noise model {noise!r}")
    f64 = dict(dtype=torch.float64, device=device)
    u = torch.arange(cam.width, **f64)
    v = torch.arange(cam.height, **f64)
    gv, gu = torch.meshgrid(v, u, indexing="ij")
    rays = torch.stack([(gu - cam.cx) / cam.fx, (gv - cam.cy) / cam.fy,
                        torch.ones_like(gu)], dim=-1)          # (H, W, 3)
    half = torch.tensor(room.half_extent, **f64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    gt = np.stack([pose(path, i) for i in range(n)])
    rgb = np.empty((n, cam.height, cam.width, 3), np.uint8)
    depth = np.empty((n, cam.height, cam.width), np.float32)
    for s in range(0, n, chunk):
        c2w = torch.as_tensor(gt[s:s + chunk], **f64)          # (c, 4, 4)
        dirs = torch.einsum("hwj,cij->chwi", rays, c2w[:, :3, :3])
        origin = c2w[:, None, None, :3, 3]
        t_lo = (-half - origin) / dirs
        t_hi = (half - origin) / dirs
        z = torch.maximum(t_lo, t_hi).amin(-1)                 # (c, H, W)
        hits = origin + z[..., None] * dirs
        col = (_texture(hits, room.tex_freq) * 255).to(torch.uint8)
        if noise == "kinect_v1":
            eps = torch.randn(z.shape, generator=gen, **f64)
            z = z + kinect_v1_sigma(z) * eps
        raw = z * cam.depth_scale
        if quantize:
            raw = torch.round(raw)
        rgb[s:s + chunk] = col.cpu().numpy()
        depth[s:s + chunk] = raw.to(torch.float32).cpu().numpy()
    return rgb, depth, gt
