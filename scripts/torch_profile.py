"""Where the PyTorch port's time goes on the GPU.

Runs the port's staged SLAMEngine on the chip_smoke.py configuration
(1200x680 synthetic, downsample 10, no mapping, frames made up front) and
prints JSON lines:

  * "phases": seconds per engine phase, each timed on the host clock
    between device synchronizations (so the phases add up to the step
    time plus the synchronizations' cost), and the Gauss-Newton iteration
    count;
  * "profile_tracking" and "profile_render": torch.profiler windows over a
    second, unsynchronized run of the tracking frames and of the
    evaluation renders: wall time, device busy time (kernel time summed)
    and its share, kernel launches per frame or view, and the top device
    kernels by time (the full tables, by device and by CPU time, go to
    <out>/<name>_table.txt).

    python scripts/torch_profile.py [--frames 36] [--out output/torch_profile]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--out", default="output/torch_profile")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from gs_icp_slam_torch import cuda_build
    from gs_icp_slam_torch.config import synthetic_config
    from gs_icp_slam_torch.datasets import InMemorySequence, open_dataset
    from gs_icp_slam_torch.slam import SLAMEngine
    from gs_icp_slam_torch.ops import rasterize as raster_mod
    from gs_icp_slam_torch.slam import engine as engine_mod

    cuda_build.build_all()
    seq = InMemorySequence(open_dataset("synthetic", width=1200, height=680,
                                        num_frames=args.frames))
    cfg = synthetic_config(seq.intr, downsample_rate=10, capacity=1 << 18,
                           target_capacity=1 << 16, visible_capacity=1 << 16)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, mapping_iters_per_frame=0, mapping_iters_final=0,
        keyframe_capacity=64))

    # ---- phases: wrap the engine's building blocks with synced timers ----
    spent = collections.defaultdict(float)
    calls = collections.Counter()
    iters = []

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            calls[name] += 1
            if name == "gicp_align":
                iters.append(out[1])
            return out
        return wrapper

    names = ("downsample_pointcloud", "target_from_points", "make_source",
             "gicp_align", "source_correspondences", "add_gaussians",
             "trackable_export", "target_from_gaussians", "rasterize_tiled")
    # inside the rasterizer: binning (projection, compaction, sorts) and
    # the compositor kernel
    raster_names = ("bin_splats", "composite_fwd")
    originals = {n: getattr(engine_mod, n) for n in names}
    originals.update({n: getattr(raster_mod, n) for n in raster_names})
    for n in names:
        setattr(engine_mod, n, timed(n, originals[n]))
    for n in raster_names:
        setattr(raster_mod, n, timed(n, originals[n]))
    try:
        eng = SLAMEngine(seq, cfg, device="cuda")
        eng.step(0, seq[0])  # warm-up: first-call costs (cuSOLVER, caches)
        eng = SLAMEngine(seq, cfg, device="cuda")
        spent.clear()
        calls.clear()
        iters.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(len(seq)):
            eng.step(i, seq[i])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        track = dict(spent)
        spent.clear()
        t0 = time.perf_counter()
        for i in range(len(seq)):
            w2c = torch.linalg.inv(torch.as_tensor(
                eng.poses[i], dtype=torch.float32, device="cuda"))
            eng.render_eval(w2c, seq[i])
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
    finally:
        for n in names:
            setattr(engine_mod, n, originals[n])
        for n in raster_names:
            setattr(raster_mod, n, originals[n])
    print(json.dumps({
        "phases": {"frames": len(seq), "step_s_total": step_s,
                   "tracking_fps_synced": len(seq) / step_s,
                   "per_phase_s": track, "calls": dict(calls),
                   "gn_iterations": iters,
                   "render_eval_s_total": render_s,
                   "render_phase_s": dict(spent)}}), flush=True)

    # ---- profiles: unsynchronized runs of the tracking frames, then of
    # the evaluation renders --------------------------------------------
    eng = SLAMEngine(seq, cfg, device="cuda")
    eng.step(0, seq[0])
    torch.cuda.synchronize()

    def track():
        for i in range(1, len(seq)):
            eng.step(i, seq[i])

    def render():
        for i in range(len(seq)):
            w2c = torch.linalg.inv(torch.as_tensor(
                eng.poses[i], dtype=torch.float32, device="cuda"))
            eng.render_eval(w2c, seq[i])

    os.makedirs(args.out, exist_ok=True)
    for name, fn, n_units in (("profile_tracking", track, len(seq) - 1),
                              ("profile_render", render, len(seq))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(prof, name, wall, n_units, args.out)


def report(prof, name: str, wall: float, n_units: int, out: str) -> None:
    """Print one profiler window's device busy share, launches per unit
    (frame or view) and top device kernels; write the full table."""
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.device_time_total for e in kernels)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.device_time_total
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({name: {
        "units": n_units, "wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernel_launches_per_unit": len(kernels) / n_units,
        "top_kernels_ms": {k[:80]: [v[0] / 1e3, v[1]] for k, v in top}}}),
        flush=True)
    with open(os.path.join(out, f"{name}_table.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
        f.write("\n\nby CPU time:\n")
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=40))


if __name__ == "__main__":
    main()
