"""Reference quality values for the PyTorch port's chip smoke run.

Runs the JAX `SLAMEngine` (tracking, keyframe insertion with covariance
sharing, target export, mapping iterations, render/eval) on the CPU at a
configuration `chip_smoke.py` drives the port with, and prints one JSON
line: ATE, Gaussian count, keyframe count and per-frame PSNR.  These are
quality numbers, not speeds: `chip_smoke.py` holds the port's run on the
GPU against them (PERF.md lists the values).

Path A (no mapping; the defaults) and path B (bench.py's mapping
settings):

    JAX_PLATFORMS=cpu python scripts/port_reference.py
    JAX_PLATFORMS=cpu python scripts/port_reference.py \
        --mapping-iters 2 --init-opacity 0.5 --feature-lr 1e-2

Path C runs the JAX `FusedEngine` on bench.py's scenario instead (2
mapping iterations per frame, init opacity 0.5, feature lr 1e-2,
keyframe store 64, fps_cap None):

    JAX_PLATFORMS=cpu python scripts/port_reference.py --fused

and also prints the engine's random draws as [maxval, value] pairs in the
order the step takes them (a reservoir victim on every keyframe store,
then one keyframe index per mapping iteration), plus the 64 draws one
`refine` call would take next.  The draws are re-derived from the
engine's PRNGKey(seed) chain and the per-frame keyframe counters, and the
script checks that the chain ends at the key the engine's state holds.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=680)
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--mapping-iters", type=int, default=0,
                    help="mapping iterations per frame")
    ap.add_argument("--init-opacity", type=float, default=None,
                    help="MapConfig.init_opacity (default: the config's)")
    ap.add_argument("--feature-lr", type=float, default=None,
                    help="OptConfig.feature_lr (default: the config's)")
    ap.add_argument("--fused", action="store_true",
                    help="path C: the JAX FusedEngine on bench.py's scenario")
    args = ap.parse_args()
    if args.fused:
        return fused_reference(args)

    import numpy as np

    from gs_icp_slam_tpu.config import synthetic_config
    from gs_icp_slam_tpu.datasets import open_dataset
    from gs_icp_slam_tpu.slam import SLAMEngine

    seq = open_dataset("synthetic", width=args.width, height=args.height,
                       num_frames=args.frames)
    cfg = synthetic_config(seq.intr, downsample_rate=10, capacity=1 << 18,
                           target_capacity=1 << 16,
                           visible_capacity=1 << 16)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, mapping_iters_per_frame=args.mapping_iters,
        mapping_iters_final=0, keyframe_capacity=64))
    if args.init_opacity is not None:
        cfg = cfg.replace(map=dataclasses.replace(
            cfg.map, init_opacity=args.init_opacity))
    if args.feature_lr is not None:
        cfg = cfg.replace(opt=dataclasses.replace(
            cfg.opt, feature_lr=args.feature_lr))
    res = SLAMEngine(seq, cfg).run(eval_render=True)
    print(json.dumps({
        "width": args.width, "height": args.height, "frames": args.frames,
        "mapping_iters_per_frame": args.mapping_iters,
        "init_opacity": cfg.map.init_opacity,
        "feature_lr": cfg.opt.feature_lr,
        "ate_m": res.ate_rmse, "num_gaussians": res.num_gaussians,
        "kf_total": res.kf_total,
        "psnr_mean": res.psnr, "psnr_min": float(np.min(res.per_frame_psnr)),
        "per_frame_psnr": [float(x) for x in res.per_frame_psnr],
        "vis_cap_dropped": res.vis_cap_dropped,
        "tile_cap_dropped": res.tile_cap_dropped,
    }))


def fused_reference(args):
    import numpy as np

    import jax
    import jax.numpy as jnp

    from gs_icp_slam_tpu.config import synthetic_config
    from gs_icp_slam_tpu.datasets import open_dataset
    from gs_icp_slam_tpu.slam import FusedEngine
    from gs_icp_slam_tpu.slam.fused import REFINE_CHUNK

    seed = 0
    seq = open_dataset("synthetic", width=args.width, height=args.height,
                       num_frames=args.frames)
    cfg = synthetic_config(seq.intr, downsample_rate=10, capacity=1 << 18,
                           target_capacity=1 << 16,
                           visible_capacity=1 << 16)
    iters = 2 if args.mapping_iters == 0 else args.mapping_iters
    kc = 64
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, mapping_iters_per_frame=iters, mapping_iters_final=0,
        keyframe_capacity=kc, fps_cap=None))
    cfg = cfg.replace(map=dataclasses.replace(
        cfg.map, init_opacity=0.5 if args.init_opacity is None
        else args.init_opacity))
    cfg = cfg.replace(opt=dataclasses.replace(
        cfg.opt, feature_lr=1e-2 if args.feature_lr is None
        else args.feature_lr))
    eng = FusedEngine(seq, cfg, seed=seed)

    # record the keyframe counters after every frame (host reads only;
    # the step itself is the engine's)
    counters = []
    step = eng.fused.step

    def recording_step(state, *a):
        state = step(state, *a)
        counters.append((int(jax.device_get(state.kf_total)),
                         int(jax.device_get(state.kf_count))))
        return state

    eng.fused = eng.fused._replace(step=recording_step)
    res = eng.run(eval_render=True)

    # re-derive the draws: one split + randint per draw, in step order
    key = jax.random.PRNGKey(seed)

    def draw(maxval):
        nonlocal key
        key, sub = jax.random.split(key)
        return [int(maxval), int(jax.random.randint(
            sub, (), 0, jnp.int32(maxval)))]

    draws, total = [], 0
    for kf_total, kf_count in counters:
        if kf_total > total:
            draws.append(draw(kc))
        total = kf_total
        for _ in range(iters):
            draws.append(draw(max(kf_count, 1)))
    end_key = np.asarray(jax.device_get(eng.state.rng))
    assert np.array_equal(np.asarray(key), end_key), (key, end_key)
    refine_draws = [draw(max(counters[-1][1], 1))
                    for _ in range(REFINE_CHUNK)]
    print(json.dumps({
        "engine": "FusedEngine", "width": args.width, "height": args.height,
        "frames": args.frames, "mapping_iters_per_frame": iters,
        "keyframe_capacity": kc, "init_opacity": cfg.map.init_opacity,
        "feature_lr": cfg.opt.feature_lr, "seed": seed,
        "ate_m": res.ate_rmse, "num_gaussians": res.num_gaussians,
        "kf_total": res.kf_total, "kf_count": res.kf_stored,
        "psnr_mean": res.psnr, "psnr_min": float(np.min(res.per_frame_psnr)),
        "per_frame_psnr": [float(x) for x in res.per_frame_psnr],
        "vis_cap_dropped": res.vis_cap_dropped,
        "tile_cap_dropped": res.tile_cap_dropped,
        "draws": draws, "refine_draws": refine_draws,
    }))


if __name__ == "__main__":
    main()
