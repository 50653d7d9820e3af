"""Ablation timing of the PyTorch port's rasterizer on the GPU (the port's
counterpart of scripts/profile_raster.py, at its geometry).

1200x680 view, tile 16 (75 x 43 = 3,225 tiles), 2^18 splats of which the
first 8,192 are live, visible cap V = 2^16, tile span 3, K = 256 per tile;
random splats from a seed.  One line per row, milliseconds per call on the
host clock with the device synchronized before and after each timed loop:

  raster fwd; raster fwd+bwd with an L2 loss; raster fwd+bwd with the full
  mapping loss; the dense compositor K4a (`make_composite`) fwd alone and
  fwd+bwd alone on normal random (T, 16, K) blocks; mapping_loss fwd+bwd
  alone; projection fwd alone and fwd+bwd alone.

Kernel only: the plain PyTorch versions are no yardstick of speed, so there
are no rows for them.  The card's name and power limit come first, and
the last line is one JSON object with every row.

    python scripts/torch_profile_raster.py [--reps 10]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from gs_icp_slam_torch.ops.composite_cuda import make_composite
    from gs_icp_slam_torch.ops.projection import project_gaussians_packed
    from gs_icp_slam_torch.ops.rasterize import rasterize_tiled
    from gs_icp_slam_torch.utils.losses import mapping_loss

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    W, H = 1200, 680
    N = 1 << 18
    V = 1 << 16
    K = 256
    TILE = 16
    ntx, nty = -(-W // TILE), -(-H // TILE)
    T = ntx * nty
    NLIVE = 8192

    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    xyz = t(np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                      rng.uniform(1.5, 8.0, N)], -1))
    quat = t(rng.normal(size=(N, 4)))
    scale = t(rng.uniform(0.005, 0.03, (N, 3)))
    opacity = t(rng.uniform(0.3, 0.95, N))
    sh = t(rng.uniform(-0.5, 0.5, (N, 1, 3)))
    live = torch.zeros(N, dtype=torch.bool, device=dev)
    live[:NLIVE] = True
    w2c = torch.eye(4, device=dev)
    bg = torch.zeros(3, device=dev)
    fx = fy = 600.0
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    gt_img = t(rng.uniform(size=(3, H, W)))
    gt_depth = t(rng.uniform(1, 8, (H, W)))
    rows = {}

    def timeit(name, fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / args.reps * 1e3
        rows[name] = ms
        print(f"{name:42s} {ms:8.2f} ms", flush=True)

    def raster(x, s, o, h):
        return rasterize_tiled(x, quat, s, o, h, w2c, live, bg, fx, fy, cx,
                               cy, sh_degree=0, width=W, height=H, tile=TILE,
                               visible_cap=V, tile_span=3, tile_cap=K)

    def leaves():
        return [p.clone().requires_grad_(True)
                for p in (xyz, scale, opacity, sh)]

    with torch.no_grad():
        timeit("raster fwd", lambda: raster(xyz, scale, opacity, sh))

    def l2grad():
        ps = leaves()
        out = raster(*ps)
        loss = ((out.color - gt_img) ** 2).mean() + 0.1 * out.depth.mean()
        return torch.autograd.grad(loss, ps)

    timeit("raster fwd+bwd L2", l2grad)

    def fullgrad():
        ps = leaves()
        out = raster(*ps)
        loss, _ = mapping_loss(out.color, out.depth, gt_img, gt_depth,
                               lambda_dssim=0.2, depth_weight=0.1,
                               d_max=10.0)
        return torch.autograd.grad(loss, ps)

    timeit("raster fwd+bwd full-loss", fullgrad)

    comp = make_composite(T, ntx, TILE, K)
    attrs = t(rng.normal(size=(T, 16, K)))
    with torch.no_grad():
        timeit("K4a composite fwd alone", lambda: comp(attrs))

    def comp_grad():
        a = attrs.clone().requires_grad_(True)
        return torch.autograd.grad(comp(a).sum(), a)

    timeit("K4a composite fwd+bwd alone", comp_grad)

    img0 = t(rng.uniform(size=(3, H, W)))

    def loss_only_grad():
        img = img0.clone().requires_grad_(True)
        loss, _ = mapping_loss(img, gt_depth, gt_img, gt_depth,
                               lambda_dssim=0.2, depth_weight=0.1,
                               d_max=10.0)
        return torch.autograd.grad(loss, img)

    timeit("mapping_loss fwd+bwd alone", loss_only_grad)

    def project(x, s, o, h):
        return project_gaussians_packed(x, quat, s, o, h, 0, w2c, fx, fy, cx,
                                        cy, W, H, live)

    with torch.no_grad():
        timeit("projection fwd alone",
               lambda: project(xyz, scale, opacity, sh))

    def project_grad():
        ps = leaves()
        attr, _, _ = project(*ps)
        # mean2d and conic scaled as profile_raster.py scales them, + rgb
        loss = (attr[0:2].sum() * 1e-3 + attr[2:5].sum() * 1e-3
                + attr[5:8].sum())
        return torch.autograd.grad(loss, ps, allow_unused=True)

    timeit("projection fwd+bwd alone", project_grad)
    print(json.dumps({"card": card, "reps": args.reps, "tiles": T, "K": K,
                      "ms": rows}), flush=True)


if __name__ == "__main__":
    main()
