"""Where the PyTorch port's time goes on the GPU.

Runs the port's staged SLAMEngine on a chip_smoke.py configuration
(1200x680 synthetic, downsample 10, frames made up front; by default path
B: 2 mapping iterations per frame, init opacity 0.5, feature lr 1e-2;
--mapping-iters 0 gives path A) and prints JSON lines:

  * "phases": seconds per engine phase, each timed on the host clock
    between device synchronizations (so the phases add up to the step
    time plus the synchronizations' cost), the Gauss-Newton iteration
    count, and the opt step's own phases: bin_splats (projection,
    compaction, sorts), K1-fwd, the loss, the backward (K1-bwd inside it,
    also reported alone) and Adam;
  * "profile_tracking", "profile_opt_step" and "profile_render":
    torch.profiler windows over unsynchronized runs of the tracking
    frames, of opt steps and of the evaluation renders: wall time, device
    busy time (kernel time summed) and its share, kernel launches per
    frame, opt step or view, and the top device kernels by time (the full
    tables, by device and by CPU time, go to <out>/<name>_table.txt).

    python scripts/torch_profile.py [--frames 36] [--mapping-iters 2]
        [--out output/torch_profile]
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

OPT_STEPS = 20  # opt steps in the profiled opt-step window


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--mapping-iters", type=int, default=2)
    ap.add_argument("--out", default="output/torch_profile")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from gs_icp_slam_torch import cuda_build
    from gs_icp_slam_torch.config import synthetic_config
    from gs_icp_slam_torch.datasets import InMemorySequence, open_dataset
    from gs_icp_slam_torch.models import map_params
    from gs_icp_slam_torch.ops import composite_cuda
    from gs_icp_slam_torch.ops import rasterize as raster_mod
    from gs_icp_slam_torch.slam import SLAMEngine
    from gs_icp_slam_torch.slam import engine as engine_mod
    from gs_icp_slam_torch.slam import fused as fused_mod

    cuda_build.build_all()
    seq = InMemorySequence(open_dataset("synthetic", width=1200, height=680,
                                        num_frames=args.frames))
    cfg = synthetic_config(seq.intr, downsample_rate=10, capacity=1 << 18,
                           target_capacity=1 << 16, visible_capacity=1 << 16)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, mapping_iters_per_frame=args.mapping_iters,
        mapping_iters_final=0, keyframe_capacity=64))
    if args.mapping_iters:
        cfg = cfg.replace(map=dataclasses.replace(cfg.map, init_opacity=0.5),
                          opt=dataclasses.replace(cfg.opt, feature_lr=1e-2))
    card = torch.cuda.get_device_name(0)

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

    # (module, attribute, phase name): the engine's stages; inside the
    # rasterizer, binning and the compositor; inside the opt step, the
    # loss, the backward, K1-bwd (inside the backward) and Adam
    patches = [(engine_mod, n, n) for n in (
        "downsample_pointcloud", "target_from_points", "make_source",
        "gicp_align", "source_correspondences", "add_gaussians",
        "trackable_export", "target_from_gaussians")]
    patches += [(raster_mod, "bin_splats", "bin_splats"),
                (raster_mod, "composite", "composite_fwd (K1-fwd)"),
                (fused_mod, "mapping_loss", "loss"),
                (fused_mod, "adam_step", "adam"),
                (torch.autograd, "grad", "backward"),
                (composite_cuda, "composite_bwd", "composite_bwd (K1-bwd)")]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]

    def new_engine():
        eng = SLAMEngine(seq, cfg, device="cuda")
        eng.prim = eng.prim._replace(
            opt_step=timed("opt_step", eng.prim.opt_step),
            raster=timed("rasterize_tiled", eng.prim.raster))
        return eng

    for mod, attr, name in patches:
        setattr(mod, attr, timed(name, getattr(mod, attr)))
    try:
        new_engine().step(0, seq[0])  # warm-up: first-call costs
        eng = new_engine()
        spent.clear()
        calls.clear()
        iters.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(len(seq)):
            eng.step(i, seq[i])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        track, track_calls = dict(spent), dict(calls)
        spent.clear()
        calls.clear()
        t0 = time.perf_counter()
        for i in range(len(seq)):
            w2c = torch.linalg.inv(torch.as_tensor(
                eng.poses[i], dtype=torch.float32, device="cuda"))
            eng.render_eval(w2c, seq[i])
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    print(json.dumps({"phases": {
        "device": card, "frames": len(seq),
        "mapping_iters_per_frame": args.mapping_iters,
        "opt_steps": eng.train_iter, "step_s_total": step_s,
        "fps_synced": len(seq) / step_s, "per_phase_s": track,
        "calls": track_calls, "gn_iterations": iters,
        "render_eval_s_total": render_s,
        "render_phase_s": dict(spent)}}), flush=True)

    # ---- profiles: unsynchronized runs of the tracking frames, of opt
    # steps on the finished map, and of the evaluation renders -----------
    eng = SLAMEngine(seq, cfg, device="cuda")
    eng.step(0, seq[0])
    torch.cuda.synchronize()

    def track():
        for i in range(1, len(seq)):
            eng.step(i, seq[i])

    def opt_steps():
        params, adam = map_params(eng.gmap), eng.adam
        for n in range(OPT_STEPS):
            i = n % eng.kf_count
            params, adam, _, _ = eng.prim.opt_step(
                params, adam, eng.gmap.live, eng._to_device(eng.kf_w2c[i]),
                eng._to_device(eng.kf_rgb[i]),
                eng._to_device(eng.kf_depth[i]))

    def render():
        for i in range(len(seq)):
            w2c = torch.linalg.inv(torch.as_tensor(
                eng.poses[i], dtype=torch.float32, device="cuda"))
            eng.render_eval(w2c, seq[i])

    os.makedirs(args.out, exist_ok=True)
    windows = [("profile_tracking", track, len(seq) - 1),
               ("profile_opt_step", opt_steps, OPT_STEPS),
               ("profile_render", render, len(seq))]
    if not args.mapping_iters:
        del windows[1]
    for name, fn, n_units in windows:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(prof, name, wall, n_units, args.out)


def report(prof, name: str, wall: float, n_units: int, out: str) -> None:
    """Print one profiler window's device busy share, launches per unit
    (frame, opt step or view) and top device kernels; write the full
    table."""
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
