"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from gs_icp_slam_torch/csrc (one nvcc per
   source, all at once) and prints the build time;
2. drives the port's two paths through their user entry point, the staged
   SLAMEngine, on the 36-frame synthetic sequence at 1200x680, downsample
   10, map capacity 2^18, target 2^16, visible cap 2^16, keyframe store 64:
     A. no mapping iterations: G-ICP tracking, covariance-shared map
        building, target export, render/eval;
     B. bench.py's mapping settings: 2 mapping iterations per frame
        (render a keyframe, SSIM/L1/depth loss, the compositor's backward,
        masked Adam), init opacity 0.5, feature lr 1e-2.
   Every kernel's launch count is zeroed just before each path and read
   just after it; each kernel of the path must be > 0, and K1-bwd must
   run once per opt step of path B.  ATE, Gaussian count, keyframe count
   and mean PSNR are held against the JAX package's values for the same
   runs (scripts/port_reference.py on the CPU);
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

# The JAX SLAMEngine on the same configurations (scripts/port_reference.py,
# JAX on the CPU): quality values, not speeds.  Path A, no mapping:
REF_A = dict(ate_m=0.0022180734651930383, num_gaussians=49680, kf_total=6,
             psnr_mean=8.240556557973227)
# Path B, 2 mapping iterations per frame, init opacity 0.5, feature lr 1e-2
# (scripts/port_reference.py --mapping-iters 2 --init-opacity 0.5
# --feature-lr 1e-2):
REF_B = dict(ate_m=0.0018647520233165142, num_gaussians=49680, kf_total=6,
             psnr_mean=23.574109925164116)
# Tolerances: ATE within 0.5 mm and mean PSNR within 0.1 dB (float32 sums
# in another order, and near-tie neighbour picks of the XLA distance form
# the reference takes on the CPU); counts exact (a difference would be a
# different keyframe decision).
TOL_ATE_M = 5e-4
TOL_PSNR_DB = 0.1
# K1-bwd against its plain version: each attribute row within this share
# of the row's largest |gradient| (pixel sums in another order, by atomics)
TOL_BWD_ROW = 1e-4

WIDTH, HEIGHT, FRAMES = 1200, 680, 36
MAPPING_ITERS = 2


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
        from gs_icp_slam_torch.models import map_params
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

    # ---- 2. the two paths ----------------------------------------------
    # frames made up front: synthesizing one costs ~0.1 s on the host,
    # set-up rather than the engine's time
    seq = InMemorySequence(open_dataset("synthetic", width=WIDTH,
                                        height=HEIGHT, num_frames=FRAMES))
    base = synthetic_config(seq.intr, downsample_rate=10, capacity=1 << 18,
                            target_capacity=1 << 16, visible_capacity=1 << 16)
    cfg_a = base.replace(engine=dataclasses.replace(
        base.engine, mapping_iters_per_frame=0, mapping_iters_final=0,
        keyframe_capacity=64))
    cfg_b = cfg_a.replace(
        engine=dataclasses.replace(cfg_a.engine,
                                   mapping_iters_per_frame=MAPPING_ITERS),
        map=dataclasses.replace(cfg_a.map, init_opacity=0.5),
        opt=dataclasses.replace(cfg_a.opt, feature_lr=1e-2))
    problems = []

    def run_path(name, cfg, ref, kernels_of_path):
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        eng = SLAMEngine(seq, cfg, device="cuda")
        res = eng.run(eval_render=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
        psnr_mean = float(res.psnr)
        print(json.dumps({
            "path": name, "entry": "SLAMEngine.run", "frames": FRAMES,
            "width": WIDTH, "height": HEIGHT,
            "mapping_iters_per_frame": cfg.engine.mapping_iters_per_frame,
            "opt_steps": eng.train_iter, "fps": res.fps,
            "wall_s_with_render": wall, "ate_m": res.ate_rmse,
            "num_gaussians": res.num_gaussians, "kf_total": res.kf_total,
            "psnr_mean": psnr_mean,
            "psnr_min": float(res.per_frame_psnr.min()),
            "vis_cap_dropped": res.vis_cap_dropped,
            "tile_cap_dropped": res.tile_cap_dropped, "launches": launches,
            "tile_cap_K": eng.tile_cap}), flush=True)
        for k in kernels_of_path:
            if launches[k] <= 0:
                problems.append(f"path {name}: kernel {k} was not launched")
        if not np.isfinite(res.poses).all():
            problems.append(f"path {name}: non-finite poses")
        if not abs(res.ate_rmse - ref["ate_m"]) <= TOL_ATE_M:
            problems.append(f"path {name}: ATE {res.ate_rmse} vs reference "
                            f"{ref['ate_m']}")
        for key, got in (("num_gaussians", res.num_gaussians),
                         ("kf_total", res.kf_total)):
            if got != ref[key]:
                problems.append(f"path {name}: {key} {got} vs reference "
                                f"{ref[key]}")
        if not abs(psnr_mean - ref["psnr_mean"]) <= TOL_PSNR_DB:
            problems.append(f"path {name}: PSNR {psnr_mean} vs reference "
                            f"{ref['psnr_mean']}")
        return eng, res, launches

    _, res_a, launches_a = run_path("A", cfg_a, REF_A,
                                    ("nn1", "knn", "composite_fwd"))
    eng, res, launches = run_path("B", cfg_b, REF_B, list(cuda_build.KERNELS))
    if launches["composite_bwd"] != eng.train_iter:
        problems.append(f"composite_bwd launched {launches['composite_bwd']} "
                        f"times for {eng.train_iter} opt steps")

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
        launches=launches["nn1"], launches_path_a=launches_a["nn1"],
        max_abs_err=err,
        ms=time_ms(lambda: nn_cuda.nn_search_pre(q, rT, bias)),
        plain_ms=time_ms(lambda: nn_cuda.nn1_plain(q, rT, bias), reps=3,
                         warmup=1),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: torch.cdist(q, rv).min(dim=1), reps=5)))

    # K3 at the frame-0 target's shapes: the first frame's downsampled
    # cloud, k = 20 (covariances) and k = 4 (mean_sq_dist_3nn)
    from gs_icp_slam_torch.utils.pointcloud import (downsample_pointcloud,
                                                    make_downsample_filter)
    cfg = cfg_b
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
        launches=launches["knn"], launches_path_a=launches_a["knn"],
        **knn[20], queries=R, k=20,
        k4={kk: v for kk, v in knn[4].items()}))

    # K1-fwd on the compositor inputs of a real 1200x680 view of path B's
    # mapped map (frame 18's estimated pose)
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
    o1, nc1 = composite_cuda.composite_fwd(*cargs)
    o0, nc0 = composite_cuda.composite_fwd_plain(*cargs)
    torch.cuda.synchronize()
    if not torch.equal(nc1, nc0):
        problems.append(f"composite_fwd: n_contrib differs at "
                        f"{int((nc1 != nc0).sum())} pixels (tolerance: exact)")
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
        launches=launches["composite_fwd"],
        launches_path_a=launches_a["composite_fwd"], max_abs_err=err,
        ms=time_ms(lambda: composite_cuda.composite_fwd(*cargs)),
        plain_ms=time_ms(lambda: composite_cuda.composite_fwd_plain(*cargs),
                         reps=2, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None,
        pairs_examined=work, splats_visible=int(bn.stats[0]),
        max_count=int(bn.counts.max())))

    # K1-bwd on the compositor inputs and the real gradient of one opt step
    # of path B's map: the newest keyframe's view, the mapping loss's g
    # captured where the autograd Function hands it to the kernel
    captured = {}
    launch_bwd = composite_cuda.composite_bwd

    def record(*a):
        captured["args"] = a
        return launch_bwd(*a)

    kf = eng.kf_count - 1
    composite_cuda.composite_bwd = record
    try:
        eng.prim.opt_step(map_params(m), eng.adam, m.live,
                          eng._to_device(eng.kf_w2c[kf]),
                          eng._to_device(eng.kf_rgb[kf]),
                          eng._to_device(eng.kf_depth[kf]))
    finally:
        composite_cuda.composite_bwd = launch_bwd
    bargs = tuple(a.detach() if torch.is_tensor(a) else a
                  for a in captured["args"])
    d1 = composite_cuda.composite_bwd(*bargs)
    d0 = composite_cuda.composite_bwd_plain(*bargs)
    torch.cuda.synchronize()
    row_scale = d0[:10].abs().amax(1).clamp(min=1e-30)
    row_err = ((d1[:10] - d0[:10]).abs().amax(1) / row_scale).tolist()
    if not max(row_err) <= TOL_BWD_ROW:
        problems.append(f"composite_bwd: row errors {row_err} > "
                        f"{TOL_BWD_ROW} of the row's largest |gradient|")
    walked, blended = composite_cuda.composite_bwd_work(*bargs)
    counts_b, _, _, attr_b, out_b, nc_b = bargs[:6]
    T, P = counts_b.shape[0], out_b.shape[2]
    # each (tile, rank) cell the block walks sends one atomic per attribute
    cells = int(torch.minimum(nc_b.amax(1), counts_b).sum())
    nbytes = (T * 8 + int(counts_b.sum()) * 4 + attr_b.numel() * 4
              + T * P * 4 * (1 + 1 + 5)        # t_final, n_contrib, g 0-4
              + attr_b.numel() * 4             # the gradient written
              + cells * 10 * 8)                # atomics: read + write
    # from the kernel's code: ~12 operations per walked pair (offsets,
    # power, gate), ~45 more per blended pair (exp, alpha, the ten terms)
    b, by = bound(walked * 12.0 + blended * 45.0, nbytes)
    kernels.append(dict(
        name="composite_bwd", route="cuda",
        source="gs_icp_slam_torch/csrc/composite_bwd.cu",
        replaces="gs_icp_slam_tpu/ops/composite_pallas.py:547",
        launches=launches["composite_bwd"],
        launches_path_a=launches_a["composite_bwd"],
        max_abs_err=float((d1 - d0).abs().max()),
        row_err_vs_row_max=row_err,
        ms=time_ms(lambda: composite_cuda.composite_bwd(*bargs)),
        plain_ms=time_ms(lambda: composite_cuda.composite_bwd_plain(*bargs),
                         reps=2, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None, pairs_walked=walked,
        pairs_blended=blended, cells_walked=cells,
        max_n_contrib=int(nc_b.max())))

    if problems:
        for p in problems:
            print(f"FAILED: {p}", file=sys.stderr)
        raise SystemExit(1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
