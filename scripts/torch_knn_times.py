"""Time the port's exact k-NN (kernel K3) on one NVIDIA GPU.

    python scripts/torch_knn_times.py [--root DIR] [--reps N]

Imports gs_icp_slam_torch from DIR (default: this repository), builds its
kernels there, and times `knn_search_kernel` through CUDA events on the
inputs of chip_smoke.py's K3 phase: the first frame's downsampled cloud of
the synthetic sequence at 1200x680, downsample 10 (8,280 points, k = 20
and k = 4), and a random cube of as many points with 30% of them invalid
(k = 20; the same draws as chip_smoke.py's, from a generator seeded 5),
each searched against itself.  The results are checked against
`knn_plain`.  Beside each, on the same cloud: the time of the tracker's
Morton sort (`ops.gicp.spatial_order`, about 20 small tensor operations,
so the host's pace), and the device time of each kernel of one K3 call
(torch.profiler over 20 calls).  Pointing --root at two trees in turn
(parent, change, change, parent) compares two versions of the kernel in
one session on one card.  Prints the card's name and power limit
(nvidia-smi), then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: K3 runs only on the GPU")
    from gs_icp_slam_torch import cuda_build
    from gs_icp_slam_torch.config import synthetic_config
    from gs_icp_slam_torch.datasets import open_dataset
    from gs_icp_slam_torch.ops import nn_cuda
    from gs_icp_slam_torch.ops.gicp import spatial_order
    from gs_icp_slam_torch.utils.pointcloud import (downsample_pointcloud,
                                                    make_downsample_filter)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cuda_build.build_all()
    dev = torch.device("cuda")
    seq = open_dataset("synthetic", width=1200, height=680, num_frames=1)
    intr = synthetic_config(seq.intr, downsample_rate=10).intr
    filt = make_downsample_filter(intr.width, intr.height, intr.fx, intr.fy,
                                  intr.cx, intr.cy, 10)
    fr = seq[0]
    pc = downsample_pointcloud(filt, torch.from_numpy(fr.depth).to(dev),
                               torch.from_numpy(fr.rgb).to(dev),
                               intr.depth_scale, intr.depth_trunc)
    pts, trk = pc["points"].contiguous(), pc["trackable"].contiguous()
    R = pts.shape[0]
    gen = torch.Generator().manual_seed(5)
    cube = (torch.rand((R, 3), generator=gen) * 4 - 2).to(dev)
    cube_valid = (torch.rand(R, generator=gen) > 0.3).to(dev)

    def time_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    out = {"root": str(Path(args.root).resolve()), "points": R}
    for case, k, cloud, ok in (("frame0", 20, pts, trk),
                               ("frame0", 4, pts, trk),
                               ("cube", 20, cube, cube_valid)):
        i1, d1 = nn_cuda.knn_search_kernel(cloud, cloud, ok, k)
        i0, d0 = nn_cuda.knn_plain(cloud, cloud, ok, k)
        have = d0 < 1e37
        exact = bool(torch.equal(d1, d0) and torch.equal(i1[have], i0[have]))
        ms = time_ms(lambda: nn_cuda.knn_search_kernel(cloud, cloud, ok, k))
        order_ms = time_ms(lambda: spatial_order(cloud.T, ok))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                nn_cuda.knn_search_kernel(cloud, cloud, ok, k)
            torch.cuda.synchronize()
        device_us = {
            e.key.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0]: e.device_time_total / 20
            for e in prof.key_averages() if e.device_time_total > 0}
        out[f"{case}_k{k}"] = dict(ms=ms, exact=exact,
                                   spatial_order_ms=order_ms,
                                   device_us_per_call=device_us)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
