"""Offline rendering of a saved map along a trajectory (counterpart of
gs_icp_slam_tpu/eval/offline.py) — the reference's render.py (SURVEY
§2.17): load a 3DGS PLY, render every (strided) pose through the port's
rasterizer (kernel K1-fwd on the card), write PNGs.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..io.ply import load_ply
from ..ops.rasterize import rasterize_tiled
from ..utils.se3 import invert_se3


@torch.no_grad()
def render_ply_sequence(ply_path: str, poses_c2w: np.ndarray, out_dir: str,
                        width: int, height: int, fx: float, fy: float,
                        stride: int = 1, bg=(0.0, 0.0, 0.0),
                        visible_cap: int = 1 << 17,
                        tile_cap: int = 256, device="cuda") -> int:
    """Render frames 0, stride, 2*stride, ... of poses_c2w at 16-pixel
    tiles with the principal point at the image centre; writes
    {i:06d}.png, or .npy where PIL cannot write.  Returns the frames
    written."""
    dev = resolve_device(device)
    d = load_ply(ply_path)
    n = len(d["xyz"])
    sh_rest = d["f_rest"].shape[1]
    sh_degree = int(np.sqrt(sh_rest + 1)) - 1

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    xyz = t(d["xyz"])
    quat = t(d["rotation"])
    scale = torch.exp(t(d["log_scaling"]))
    opacity = torch.sigmoid(t(d["opacity_logit"][:, 0]))
    sh = torch.cat([t(d["f_dc"]), t(d["f_rest"])], dim=1)
    live = torch.ones((n,), dtype=torch.bool, device=dev)
    bg = torch.tensor(bg, dtype=torch.float32, device=dev)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0

    count = 0
    os.makedirs(out_dir, exist_ok=True)
    for i in range(0, len(poses_c2w), stride):
        w2c = invert_se3(torch.as_tensor(poses_c2w[i], dtype=torch.float32,
                                         device=dev))
        out = rasterize_tiled(xyz, quat, scale, opacity, sh, w2c, live, bg,
                              fx, fy, cx, cy, sh_degree=sh_degree,
                              width=width, height=height, tile=16,
                              visible_cap=min(visible_cap, n),
                              tile_cap=tile_cap)
        img = np.clip(out.color.cpu().numpy().transpose(1, 2, 0), 0, 1)
        img8 = (img * 255).astype(np.uint8)
        try:
            from PIL import Image
            Image.fromarray(img8).save(
                os.path.join(out_dir, f"{i:06d}.png"))
        except Exception:
            np.save(os.path.join(out_dir, f"{i:06d}.npy"), img8)
        count += 1
    return count
