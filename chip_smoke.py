"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from gs_icp_slam_torch/csrc (one nvcc per
   source, all at once) and prints the build time;
2. drives the port's main path through its user entry point: the staged
   SLAMEngine (G-ICP tracking, covariance-shared map building, target
   export, render/eval; no mapping iterations) on the 36-frame synthetic
   sequence at 1200x680, downsample 10, map capacity 2^18, target 2^16,
   visible cap 2^16.  Every kernel's launch count is zeroed just before
   the run and read just after it; each must be > 0.  ATE, Gaussian count
   and mean PSNR are held against the JAX package's values for the same
   run (scripts/port_reference.py on the CPU);
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes, and times kernel, plain version and, where one
   exists, a single PyTorch library call computing the same function
   (CUDA events), beside the least time the card could take (bound);
4. prints a "kernels" JSON line and, as the last line,
   {"ok": true, "device": {...}}.  The card's name and power limit
   (nvidia-smi) is the first line of output.

Any failed check exits non-zero before the last line.  Without a CUDA
device, or without the gs_icp_slam_torch package beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# The JAX SLAMEngine on the same configuration (scripts/port_reference.py,
# JAX on the CPU): quality values, not speeds.
REF_ATE_M = 0.0022180734651930383
REF_NUM_GAUSSIANS = 49680
REF_KF_TOTAL = 6
REF_PSNR_MEAN = 8.240556557973227
# Tolerances: ATE within 0.5 mm and mean PSNR within 0.1 dB (float32 sums
# in another order, and near-tie neighbour picks of the XLA distance form
# the reference takes on the CPU); counts exact (a difference would be a
# different keyframe decision).
TOL_ATE_M = 5e-4
TOL_PSNR_DB = 0.1

WIDTH, HEIGHT, FRAMES = 1200, 680, 36


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes")


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"PyTorch is not installed: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the GPU")
    try:
        from gs_icp_slam_torch import cuda_build
        from gs_icp_slam_torch.config import synthetic_config
        from gs_icp_slam_torch.datasets import InMemorySequence, open_dataset
        from gs_icp_slam_torch.ops import composite_cuda, nn_cuda
        from gs_icp_slam_torch.ops.rasterize import bin_splats
        from gs_icp_slam_torch.slam import SLAMEngine
    except ImportError as e:
        fail(f"the gs_icp_slam_torch package is not beside this script: {e}")

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- 1. build -----------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {len(reports)} sources compiled in {build_s:.1f} s "
          f"({', '.join(sorted(reports)) or 'cached'})", flush=True)
    for name, log in sorted(reports.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- 2. the main path ---------------------------------------------
    # frames made up front: synthesizing one costs ~0.1 s on the host,
    # set-up rather than the engine's time
    seq = InMemorySequence(open_dataset("synthetic", width=WIDTH,
                                        height=HEIGHT, num_frames=FRAMES))
    cfg = synthetic_config(seq.intr, downsample_rate=10, capacity=1 << 18,
                           target_capacity=1 << 16, visible_capacity=1 << 16)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, mapping_iters_per_frame=0, mapping_iters_final=0,
        keyframe_capacity=64))
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    eng = SLAMEngine(seq, cfg, device="cuda")
    res = eng.run(eval_render=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
    psnr_mean = float(res.psnr)
    print(json.dumps({
        "main_path": "SLAMEngine.run", "frames": FRAMES,
        "width": WIDTH, "height": HEIGHT, "fps_tracking": res.fps,
        "wall_s_with_render": wall, "ate_m": res.ate_rmse,
        "num_gaussians": res.num_gaussians, "kf_total": res.kf_total,
        "psnr_mean": psnr_mean, "psnr_min": float(res.per_frame_psnr.min()),
        "vis_cap_dropped": res.vis_cap_dropped,
        "tile_cap_dropped": res.tile_cap_dropped, "launches": launches,
        "tile_cap_K": eng.tile_cap}), flush=True)
    problems = []
    for name, n in launches.items():
        if n <= 0:
            problems.append(f"kernel {name} was not launched by the main path")
    if not np.isfinite(res.poses).all():
        problems.append("non-finite poses")
    if abs(res.ate_rmse - REF_ATE_M) > TOL_ATE_M:
        problems.append(f"ATE {res.ate_rmse} vs reference {REF_ATE_M}")
    if res.num_gaussians != REF_NUM_GAUSSIANS:
        problems.append(f"{res.num_gaussians} Gaussians vs reference "
                        f"{REF_NUM_GAUSSIANS}")
    if res.kf_total != REF_KF_TOTAL:
        problems.append(f"{res.kf_total} keyframes vs reference {REF_KF_TOTAL}")
    if not abs(psnr_mean - REF_PSNR_MEAN) <= TOL_PSNR_DB:
        problems.append(f"PSNR {psnr_mean} vs reference {REF_PSNR_MEAN}")

    # ---- 3. kernels against their plain versions ------------------------
    dev = torch.device("cuda")
    kernels = []
    gen = torch.Generator(device="cpu").manual_seed(0)

    # K2 at tracking shapes: 8,192 queries x 65,536 target slots, ~30% of
    # them invalid (the Gauss-Newton inner loop's call)
    Q, Tp = 8192, 1 << 16
    q = (torch.rand((Q, 3), generator=gen) * 4 - 2).to(dev)
    rT = (torch.rand((3, Tp), generator=gen) * 4 - 2).to(dev).contiguous()
    valid = (torch.rand(Tp, generator=gen) > 0.3).to(dev)
    bias = torch.where(valid, 0.0, 3.4e38).float()[None].contiguous()
    i1, d1 = nn_cuda.nn_search_pre(q, rT, bias)
    i0, d0 = nn_cuda.nn1_plain(q, rT, bias)
    torch.cuda.synchronize()
    err = float((d1 - d0).abs().max())
    n_idx = int((i1 != i0).sum())
    if n_idx or err > 0.0:
        problems.append(f"nn1: {n_idx} indices differ, max |dsqd| {err} "
                        "(tolerance: exact)")
    rv = rT.T[valid].contiguous()
    nv = int(valid.sum())
    b, by = bound(Q * nv * 9.0, Q * 12 + Tp * 16 + Q * 8)
    kernels.append(dict(
        name="nn1", route="cuda", source="gs_icp_slam_torch/csrc/nn1.cu",
        replaces="gs_icp_slam_tpu/ops/nn_pallas.py:32",
        launches=launches["nn1"], max_abs_err=err,
        ms=time_ms(lambda: nn_cuda.nn_search_pre(q, rT, bias)),
        plain_ms=time_ms(lambda: nn_cuda.nn1_plain(q, rT, bias), reps=3,
                         warmup=1),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: torch.cdist(q, rv).min(dim=1), reps=5)))

    # K3 at the frame-0 target's shapes: the first frame's downsampled
    # cloud, k = 20 (covariances) and k = 4 (mean_sq_dist_3nn)
    from gs_icp_slam_torch.utils.pointcloud import (downsample_pointcloud,
                                                    make_downsample_filter)
    intr = cfg.intr
    filt = make_downsample_filter(intr.width, intr.height, intr.fx, intr.fy,
                                  intr.cx, intr.cy, cfg.downsample_rate)
    fr = seq[0]
    pc = downsample_pointcloud(filt, torch.from_numpy(fr.depth).to(dev),
                               torch.from_numpy(fr.rgb).to(dev),
                               intr.depth_scale, intr.depth_trunc)
    pts, trk = pc["points"].contiguous(), pc["trackable"].contiguous()
    R = pts.shape[0]
    ptsv = pts[trk]
    nvr = int(ptsv.shape[0])
    knn = {}
    for k in (20, 4):
        i1, d1 = nn_cuda.knn_search_kernel(pts, pts, trk, k)
        i0, d0 = nn_cuda.knn_plain(pts, pts, trk, k)
        torch.cuda.synchronize()
        have = d0 < 1e37
        err = float((d1 - d0).abs().max())
        n_idx = int((i1 != i0)[have].sum())
        if n_idx or err > 0.0:
            problems.append(f"knn k={k}: {n_idx} indices differ, max |dsqd| "
                            f"{err} (tolerance: exact)")
        b, by = bound(R * nvr * 10.0, R * 12 * 2 + R + R * k * 8)
        knn[k] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: nn_cuda.knn_search_kernel(pts, pts, trk, k)),
            plain_ms=time_ms(lambda: nn_cuda.knn_plain(pts, pts, trk, k),
                             reps=3, warmup=1),
            bound_ms=b, bound_by=by,
            library_ms=time_ms(lambda: torch.cdist(pts, ptsv).topk(
                k, dim=1, largest=False), reps=5))
    # the main path's k = 20 call is the row; k = 4 (mean_sq_dist_3nn)
    # rides along under its own keys
    kernels.append(dict(
        name="knn", route="cuda", source="gs_icp_slam_torch/csrc/knn.cu",
        replaces="gs_icp_slam_tpu/ops/nn_pallas.py:113",
        launches=launches["knn"], **knn[20], queries=R, k=20,
        k4={kk: v for kk, v in knn[4].items()}))

    # K1-fwd on the compositor inputs of a real 1200x680 view of the run's
    # map (frame 18's estimated pose)
    m, rc = eng.gmap, cfg.render
    w2c = torch.linalg.inv(torch.as_tensor(res.poses[18], dtype=torch.float32,
                                           device=dev))
    sh = torch.cat([m.f_dc[:, None, :], m.f_rest], dim=1)
    bn = bin_splats(m.xyz, m.rotation, torch.exp(m.log_scaling),
                    torch.sigmoid(m.opacity_logit[:, 0]), sh, w2c, m.live,
                    intr.fx, intr.fy, (intr.width - 1) / 2.0,
                    (intr.height - 1) / 2.0, sh_degree=cfg.map.sh_degree,
                    width=intr.width, height=intr.height, tile=rc.tile_size,
                    visible_cap=rc.visible_capacity, tile_span=rc.tile_span,
                    tile_cap=eng.tile_cap)
    ntx = -(-intr.width // rc.tile_size)
    cargs = (bn.counts, bn.starts, bn.pair_slot, bn.attr_v, ntx, rc.tile_size)
    o1 = composite_cuda.composite_fwd(*cargs)
    o0 = composite_cuda.composite_fwd_plain(*cargs)
    torch.cuda.synchronize()
    # rgb and transmittance in [0, 1]; depth (sum of w * z, z up to ~3 m)
    # compared relative to its largest value
    err = max(float((o1[:, [0, 1, 2, 4]] - o0[:, [0, 1, 2, 4]]).abs().max()),
              float((o1[:, 3] - o0[:, 3]).abs().max())
              / max(float(o0[:, 3].abs().max()), 1.0))
    if err > 1e-4:
        problems.append(f"composite_fwd: max abs error {err} > 1e-4")
    work = composite_cuda.composite_work(*cargs)
    T = bn.counts.shape[0]
    P = rc.tile_size ** 2
    nbytes = (T * 8 + int(bn.counts.sum()) * 4 + bn.attr_v.numel() * 4
              + T * 8 * P * 4)
    b, by = bound(work * 30.0, nbytes)
    kernels.append(dict(
        name="composite_fwd", route="cuda",
        source="gs_icp_slam_torch/csrc/composite_fwd.cu",
        replaces="gs_icp_slam_tpu/ops/composite_pallas.py:485",
        launches=launches["composite_fwd"], max_abs_err=err,
        ms=time_ms(lambda: composite_cuda.composite_fwd(*cargs)),
        plain_ms=time_ms(lambda: composite_cuda.composite_fwd_plain(*cargs),
                         reps=2, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None,
        pairs_examined=work, splats_visible=int(bn.stats[0]),
        max_count=int(bn.counts.max())))

    if problems:
        for p in problems:
            print(f"FAILED: {p}", file=sys.stderr)
        raise SystemExit(1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
