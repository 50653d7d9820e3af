"""The port's bench: bench.py's whole run through gs_icp_slam_torch.

    python -m gs_icp_slam_torch.bench

prints ONE JSON line with bench.py's keys: the SLAM system's FPS at
Replica-like load on one GPU (`value`, frames/s; `vs_baseline` = fps / 30,
the reference's throttled tracking rate), `fps_live`, PSNR and SSIM before
and after a refine capped at the timed segment's wall time, ATE, the
Gaussian count and the cap drops (`lpips` null: no pretrained weights).

The run is bench.py's (bench.py:63-186), step by step: the procedural
synthetic sequence at 1200x680, downsample 10, 36 frames; map capacity
2^18, target 2^16, visible cap 2^16, keyframe store 64; 2 mapping
iterations per frame at init opacity 0.5 and feature lr 1e-2.  6 warm-up
frames on the buckets of an empty map; one stable bucket pair for the rest,
picked from the map's size plus four keyframes; warm-ups of `step`,
`step_chunk` and `refine` on copies of the state; 30 timed frames through
`step_chunk` in chunks of 6; `fps_live` from the same frames, one `step`
each, on a copy; then every frame rendered at its estimated pose for PSNR
and SSIM, the refine, and every frame again.  The knobs are bench.py's:
GS_BENCH_ITERS, GS_BENCH_KC, GS_BENCH_INIT_OPACITY, GS_BENCH_FLR,
GS_BENCH_STAGE, GS_BENCH_TILE (with GS_BENCH_K and GS_BENCH_SPAN),
GS_BENCH_CHUNK and GS_BENCH_REFINE_S.

Where the port differs from the JAX package, and what the bench does:
  * the random draws belong to the engine, not to the state
    (slam/fused.py), so a step on a copy would move the stream the timed
    segment then reads.  The fps_live loop replays the timed segment's
    draws from the position the segment started at, and the position the
    segment ended at is restored afterwards.  The compile warm-ups run on
    the engine's own step (so its caches are warm when the clock starts)
    but draw from a stream of their own (`BenchDraws`): a recording
    (RecordedDraws) holds the main run's draws only, and the refine
    warm-up asks for 64 keyframe indices where the recording's next draws
    belong to other frames;
  * the host counters are not device values, so reading one waits for
    nothing: the clock is read after torch.cuda.synchronize().
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from .config import synthetic_config
from .datasets import open_dataset
from .eval.ate import ate_rmse
from .models import map_params
from .slam.fused import REFINE_CHUNK, FusedEngine, TorchDraws, to_chw
from .slam.state import copy_state, init_state
from .utils.losses import ssim
from .utils.se3 import invert_se3

WARMUP, TIMED = 6, 30
WIDTH, HEIGHT = 1200, 680


def bench_config(intr, env=os.environ):
    """bench.py's configuration (bench.py:65-98) with its GS_BENCH_* knobs
    read from env."""
    cfg = synthetic_config(intr, downsample_rate=10, capacity=1 << 18,
                           target_capacity=1 << 16, visible_capacity=1 << 16)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, mapping_iters_per_frame=int(env.get("GS_BENCH_ITERS",
                                                        "2")),
        keyframe_capacity=int(env.get("GS_BENCH_KC", "64"))))
    cfg = cfg.replace(map=dataclasses.replace(
        cfg.map, init_opacity=float(env.get("GS_BENCH_INIT_OPACITY", "0.5"))))
    cfg = cfg.replace(opt=dataclasses.replace(
        cfg.opt, feature_lr=float(env.get("GS_BENCH_FLR", "1e-2"))))
    stage = int(env.get("GS_BENCH_STAGE", "0"))
    if stage:
        cfg = cfg.replace(opt=dataclasses.replace(cfg.opt,
                                                  training_stage=stage))
    tile = int(env.get("GS_BENCH_TILE", "0"))
    if tile:
        cfg = cfg.replace(render=dataclasses.replace(
            cfg.render, tile_size=tile,
            max_per_tile=int(env.get("GS_BENCH_K", "256")),
            tile_span=int(env.get("GS_BENCH_SPAN", "2"))))
    return cfg


# tests/test_stress.py's scenarios: its _run keywords
STRESS = {
    "depth_noise": dict(noise_depth=0.01),
    "rotation_heavy": dict(angular_step=0.08),
    "sparse_smooth": dict(num_frames=16, width=320, height=240,
                          downsample=10, iters_final=0),
    "kf_overflow": dict(num_frames=14, keyframe_capacity=4,
                        keyframe_th=0.999, iters_final=40),
}


def stress_config(synthetic_config, open_dataset, num_frames=12,
                  noise_depth=0.0, angular_step=0.02, keyframe_capacity=16,
                  keyframe_th=None, iters_final=60, width=96, height=72,
                  downsample=4):
    """tests/test_stress.py's _run configuration: (sequence, config),
    built by the factories given (this package's, or the JAX package's
    for its reference runs)."""
    seq = open_dataset("synthetic", width=width, height=height,
                       num_frames=num_frames, noise_depth=noise_depth,
                       angular_step=angular_step)
    cfg = synthetic_config(seq.intr, downsample_rate=downsample,
                           capacity=1 << 14, target_capacity=1 << 12,
                           visible_capacity=1 << 12)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, mapping_iters_per_frame=2,
        mapping_iters_final=iters_final,
        keyframe_capacity=keyframe_capacity))
    if keyframe_th is not None:
        cfg = cfg.replace(kf=dataclasses.replace(cfg.kf,
                                                 keyframe_th=keyframe_th))
    return seq, cfg


class BenchDraws:
    """The engine's draw source in the bench: the run's own stream
    (`main`), or, while `warming`, a TorchDraws stream of the compile
    warm-ups' own.  position/restore are the main stream's."""

    def __init__(self, main):
        self.main, self.warm, self.warming = main, TorchDraws(0), False

    def __call__(self, maxval: int) -> int:
        return (self.warm if self.warming else self.main)(maxval)

    def position(self):
        return self.main.position()

    def restore(self, pos) -> None:
        self.main.restore(pos)


class BenchRun(NamedTuple):
    fields: dict      # bench.py's JSON keys, unrounded
    pre_refine: dict  # the run as tracking ends: ATE, PSNR and SSIM (mean,
                      # min, per frame), counts, cap drops, poses


def run_bench(draws=None, device="cuda", width: int = WIDTH,
              height: int = HEIGHT, warmup: int = WARMUP,
              timed: int = TIMED, env=os.environ) -> BenchRun:
    """bench.py's run on the port.  `draws`: the engine's draw source
    (default TorchDraws(0)); the sizes default to bench.py's."""
    seq = open_dataset("synthetic", width=width, height=height,
                       num_frames=warmup + timed)
    cfg = bench_config(seq.intr, env)
    src = BenchDraws(TorchDraws(0) if draws is None else draws)
    eng = FusedEngine(seq, cfg, device=device, draws=src)
    dev, fused, draws = eng.device, eng.fused, src.main

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    n = warmup + timed
    frames = [seq[i] for i in range(n)]  # preloaded, as bench.py does
    depths = [torch.from_numpy(np.asarray(f.depth)).to(dev) for f in frames]
    rgbs = [to_chw(f.rgb, dev) for f in frames]
    state = init_state(cfg, n, np.asarray(frames[0].gt_c2w, np.float32), dev)

    nb, tb = eng._pick_buckets(0)
    for i in range(warmup):
        state = fused.step(state, depths[i], rgbs[i], False, nb, tb)
    # one stable bucket pair for the rest of the run, with a margin of four
    # keyframes (bench.py:110-119)
    nb, tb = eng._pick_buckets(state.gmap.n + 4 * eng.filt.num_points)

    chunk = int(env.get("GS_BENCH_CHUNK", "6"))
    if timed % chunk:
        raise ValueError(f"GS_BENCH_CHUNK {chunk} does not divide the "
                         f"{timed} timed frames")
    chunks = [(torch.stack(depths[i:i + chunk]),
               torch.stack(rgbs[i:i + chunk]),
               [j == n - 1 for j in range(i, i + chunk)])
              for i in range(warmup, n, chunk)]
    # warm-ups on copies (bench.py:121-146), on a draw stream of their own
    src.warming = True
    fused.step(copy_state(state), depths[warmup - 1], rgbs[warmup - 1],
               False, nb, tb)
    fused.step_chunk(copy_state(state), *chunks[0], nb, tb)
    fused.refine(copy_state(state), nb)
    sync()
    src.warming = False

    state_live = copy_state(state)
    start = draws.position()
    t0 = time.perf_counter()
    for ch in chunks:
        state = fused.step_chunk(state, *ch, nb, tb)
    sync()
    elapsed = time.perf_counter() - t0
    end = draws.position()

    # fps_live: the same frames one step each, on the copy, from the draws
    # the timed segment started at
    draws.restore(start)
    t0 = time.perf_counter()
    for i in range(warmup, n):
        state_live = fused.step(state_live, depths[i], rgbs[i], i == n - 1,
                                nb, tb)
    sync()
    fps_live = timed / (time.perf_counter() - t0)
    draws.restore(end)
    del state_live

    poses = state.poses.cpu().numpy().astype(np.float64)
    gt = np.stack([np.asarray(f.gt_c2w, np.float64) for f in frames])
    ate = float(ate_rmse(gt, poses))

    def psnr_ssim(st):
        """Per-frame PSNR and SSIM of every frame at its estimated pose
        (bench.py:155-172)."""
        params = map_params(st.gmap)
        vals, svals = [], []
        with torch.no_grad():
            for i in range(n):
                w2c = invert_se3(torch.as_tensor(poses[i], dtype=torch.float32,
                                                 device=dev))
                img, p = fused.render_eval(params, st.gmap.live, w2c,
                                           rgbs[i], depths[i])
                vals.append(float(p))
                svals.append(float(ssim(img, rgbs[i].float() / 255.0)[1]))
        return vals, svals

    psnr_raw, ssim_raw = psnr_ssim(state)
    pre = dict(
        ate_rmse_m=ate, psnr_pre_refine_db=float(np.mean(psnr_raw)),
        psnr_pre_refine_min_db=float(np.min(psnr_raw)),
        ssim_pre_refine=float(np.mean(ssim_raw)),
        num_gaussians=state.gmap.num_live, kf_total=state.kf_total,
        kf_count=state.kf_count,
        vis_cap_dropped=int(state.stat_vis_dropped),
        tile_cap_dropped=int(state.stat_pair_dropped),
        per_frame_psnr=psnr_raw, per_frame_ssim=ssim_raw, poses=poses,
        buckets=(nb, tb))

    # the refine, capped at the timed segment's wall time unless
    # GS_BENCH_REFINE_S replaces the cap (bench.py:174-185)
    refine_env = env.get("GS_BENCH_REFINE_S")
    budget_s = float(refine_env) if refine_env is not None else elapsed
    refine_iters = 0
    t1 = time.perf_counter()
    while time.perf_counter() - t1 < budget_s:
        state = fused.refine(state, nb)
        sync()
        refine_iters += REFINE_CHUNK
    refine_s = time.perf_counter() - t1
    psnr_ref, ssim_ref = psnr_ssim(state)

    fps = timed / elapsed
    fields = {
        "metric": "slam_system_fps_replica_load_1chip",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / 30.0,
        "fps_live": fps_live,
        "psnr_db": float(np.mean(psnr_ref)),
        "psnr_min_db": float(np.min(psnr_ref)),
        "ssim": float(np.mean(ssim_ref)),
        "ssim_pre_refine": pre["ssim_pre_refine"],
        "lpips": None,
        "psnr_pre_refine_db": pre["psnr_pre_refine_db"],
        "psnr_pre_refine_min_db": pre["psnr_pre_refine_min_db"],
        "ate_rmse_m": ate,
        "refine_iters": refine_iters,
        "refine_s": refine_s,
        "refine_wall_cap_s": budget_s,
        "num_gaussians": state.gmap.num_live,
        "vis_cap_dropped": int(state.stat_vis_dropped),
        "tile_cap_dropped": int(state.stat_pair_dropped),
    }
    return BenchRun(fields=fields, pre_refine=pre)


# bench.py's rounding of each key it rounds
_DIGITS = {"value": 3, "vs_baseline": 4, "fps_live": 3, "psnr_db": 2,
           "psnr_min_db": 2, "ssim": 4, "ssim_pre_refine": 4,
           "psnr_pre_refine_db": 2, "psnr_pre_refine_min_db": 2,
           "ate_rmse_m": 6, "refine_s": 2, "refine_wall_cap_s": 2}


def bench_line(fields: dict) -> dict:
    """bench.py's JSON object: its keys in its order, rounded as it
    rounds them."""
    return {k: round(v, _DIGITS[k]) if k in _DIGITS else v
            for k, v in fields.items()}


def main():
    print(json.dumps(bench_line(run_bench().fields)), flush=True)


if __name__ == "__main__":
    main()
