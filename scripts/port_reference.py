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
With `--evaluate` it then runs `FusedEngine.evaluate` on the finished
run, with LPIPS-alex on the random weights `make_random_weights(path,
seed=0)` writes, and prints the per-frame PSNR, SSIM and LPIPS.

bench.py's flow (6 frames on the bucket of an empty map, then 30 on one
stable bucket, every frame rendered for PSNR and SSIM before any refine)
at a training stage, with its draws:

    JAX_PLATFORMS=cpu python scripts/port_reference.py --bench-stage 2
    JAX_PLATFORMS=cpu python scripts/port_reference.py --bench-stage 1 \
        --max-per-tile 1024

(`--frames` is the whole sequence: 6 warm-up frames, the rest timed.)
Its timed frames go through `step` one frame at a time (the function
`step_chunk` scans), so that the keyframe counters of every frame, and
with them the draws, can be read; the compile warm-ups on copies, the
`fps_live` loop and the refine leave the run's state alone in bench.py
and are skipped.  At stages 1/2 the XLA path composites each tile's
4,096 list slots; `composite_chunk` 16 (tiles per lax.map step; tiles
are composited independently, and the port has no such knob) keeps its
buffers near 2 GB.  `--max-per-tile 1024` cuts the slots where no run is
that long (see `bench_reference`): at stage 1 and 600x340 it gave the
4,096-slot run's values bit for bit.

The four scenarios of tests/test_stress.py, with their draws (the
refine calls of `mapping_iters_final` included; the XLA compositor takes
every tile in one step, see `one_chunk`):

    JAX_PLATFORMS=cpu python scripts/port_reference.py --stress all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the stress table and configuration are the port's (JAX-free), given the
# JAX package's factories here
from gs_icp_slam_torch.bench import STRESS, stress_config  # noqa: E402


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
    ap.add_argument("--evaluate", action="store_true",
                    help="with --fused: FusedEngine.evaluate afterwards, "
                         "LPIPS on random alex weights")
    ap.add_argument("--bench-stage", type=int, default=None,
                    help="bench.py's flow at this training stage")
    ap.add_argument("--max-per-tile", type=int, default=None,
                    help="with --bench-stage: RenderConfig.max_per_tile "
                         "(default: the config's 4,096); the run stops if "
                         "a tile's list overflows it")
    ap.add_argument("--stress", default=None,
                    choices=sorted(STRESS) + ["all"],
                    help="a scenario of tests/test_stress.py")
    args = ap.parse_args()
    if args.fused:
        return fused_reference(args)
    if args.bench_stage is not None:
        return bench_reference(args)
    if args.stress is not None:
        for name in sorted(STRESS) if args.stress == "all" else [args.stress]:
            stress_reference(name)
        return

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

    from gs_icp_slam_tpu.config import synthetic_config
    from gs_icp_slam_tpu.datasets import open_dataset
    from gs_icp_slam_tpu.slam import FusedEngine

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
    counters = []
    counting_step(eng, counters)
    res = eng.run(eval_render=True)

    draws, refine_draws = derive_draws(seed, counters, iters, kc,
                                       eng.state.rng)
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
    }), flush=True)
    if args.evaluate:
        evaluate_reference(eng)


def derive_draws(seed, counters, iters, kc, end_key, refine_chunks=0):
    """The [maxval, value] draws of a FusedEngine run: per frame, a
    reservoir victim if the frame stored a keyframe, then one keyframe
    index per mapping iteration; then `refine_chunks` refine calls of
    REFINE_CHUNK draws each.  Re-derived from PRNGKey(seed) by one split
    and randint per draw, and checked against the key the state ends
    with.  Returns (the run's draws, the REFINE_CHUNK draws one more
    refine call would take)."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from gs_icp_slam_tpu.slam.fused import REFINE_CHUNK

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
    last = max(counters[-1][1], 1)
    draws += [draw(last) for _ in range(refine_chunks * REFINE_CHUNK)]
    end = np.asarray(jax.device_get(end_key))
    assert np.array_equal(np.asarray(key), end), (key, end)
    return draws, [draw(last) for _ in range(REFINE_CHUNK)]


def counting_step(eng, counters):
    """Wrap eng.fused.step so that it appends (kf_total, kf_count) after
    every frame (host reads only; the step itself is the engine's)."""
    import jax

    step = eng.fused.step

    def recording_step(state, *a):
        state = step(state, *a)
        counters.append((int(jax.device_get(state.kf_total)),
                         int(jax.device_get(state.kf_count))))
        return state

    eng.fused = eng.fused._replace(step=recording_step)


def evaluate_reference(eng):
    """FusedEngine.evaluate on the finished run, LPIPS-alex on the random
    weights make_random_weights(path, seed=0) writes."""
    import tempfile

    from gs_icp_slam_tpu.eval.lpips import make_random_weights

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "lpips_random_alex.npz")
        make_random_weights(path, seed=0, net="alex")
        os.environ["GS_LPIPS_WEIGHTS"] = path
        try:
            m = eng.evaluate(eval_stride=1)
        finally:
            del os.environ["GS_LPIPS_WEIGHTS"]
    print(json.dumps({
        "entry": "FusedEngine.evaluate", "eval_stride": 1,
        "lpips_weights": "make_random_weights(seed=0, net='alex')",
        "psnr": m.psnr, "ssim": m.ssim, "lpips": m.lpips,
        "per_frame_psnr": [float(x) for x in m.per_frame_psnr],
        "per_frame_ssim": [float(x) for x in m.per_frame_ssim],
        "per_frame_lpips": [float(x) for x in m.per_frame_lpips],
    }), flush=True)


def bench_reference(args):
    """bench.py's flow (bench.py:63-186) up to the pre-refine metrics.

    With --max-per-tile K the stage's opt view lists at most K pairs a
    tile instead of 4,096.  Each tile's sorted run does not depend on K,
    and a list slot past the run holds a zero-opacity splat, so while no
    run exceeds K (checked after every frame) the composite adds up the
    same pairs; only the padded slots it never needed are gone.  At
    stage 1 on bench.py's frame that cuts the XLA compositor's work, which
    takes all K slots of every pixel, about 4x."""
    import time

    import numpy as np

    import jax
    import jax.numpy as jnp

    from gs_icp_slam_tpu.config import synthetic_config
    from gs_icp_slam_tpu.datasets import open_dataset
    from gs_icp_slam_tpu.eval.ate import ate_rmse
    from gs_icp_slam_tpu.models import map_params
    from gs_icp_slam_tpu.slam import FusedEngine
    from gs_icp_slam_tpu.slam.fused import to_chw
    from gs_icp_slam_tpu.slam.state import init_state
    from gs_icp_slam_tpu.utils.losses import ssim as ssim_fn
    from gs_icp_slam_tpu.utils.se3 import invert_se3

    warmup, seed, iters, kc = 6, 0, 2, 64
    timed = args.frames - warmup
    stage = args.bench_stage
    seq = open_dataset("synthetic", width=args.width, height=args.height,
                       num_frames=warmup + timed)
    cfg = synthetic_config(seq.intr, downsample_rate=10, capacity=1 << 18,
                           target_capacity=1 << 16,
                           visible_capacity=1 << 16)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, mapping_iters_per_frame=iters, keyframe_capacity=kc))
    cfg = cfg.replace(map=dataclasses.replace(cfg.map, init_opacity=0.5))
    cfg = cfg.replace(opt=dataclasses.replace(cfg.opt, feature_lr=1e-2,
                                              training_stage=stage))
    if stage:
        cfg = cfg.replace(render=dataclasses.replace(cfg.render,
                                                     composite_chunk=16))
    if args.max_per_tile is not None:
        cfg = cfg.replace(render=dataclasses.replace(
            cfg.render, max_per_tile=args.max_per_tile))
    eng = FusedEngine(seq, cfg, seed=seed)
    counters = []
    counting_step(eng, counters)

    def no_overflow(state):
        dropped = int(jax.device_get(state.stat_pair_dropped))
        if dropped:
            sys.exit(f"{dropped} pairs dropped at max_per_tile "
                     f"{cfg.render.max_per_tile}: rerun with a larger one")

    n = warmup + timed
    frames = [seq[i] for i in range(n)]
    depths = [jnp.asarray(f.depth) for f in frames]
    rgbs = [to_chw(f.rgb) for f in frames]
    pose0 = np.asarray(frames[0].gt_c2w, np.float32)
    state = eng.fused.pin_state(init_state(cfg, n, pose0, seed))
    t0 = time.time()
    nb, tb = eng._pick_buckets(0)
    buckets = [[nb, tb]]
    for i in range(warmup):
        state = eng.fused.step(state, depths[i], rgbs[i], jnp.bool_(False),
                               nb, tb)
        print(f"frame {i} {time.time() - t0:.0f} s", file=sys.stderr,
              flush=True)
        no_overflow(state)
    n_now = int(jax.device_get(state.gmap.n))
    nb, tb = eng._pick_buckets(n_now + 4 * eng.filt.num_points)
    buckets.append([nb, tb])
    for i in range(warmup, n):
        state = eng.fused.step(state, depths[i], rgbs[i],
                               jnp.bool_(i == n - 1), nb, tb)
        print(f"frame {i} {time.time() - t0:.0f} s", file=sys.stderr,
              flush=True)
        no_overflow(state)
    draws, refine_draws = derive_draws(seed, counters, iters, kc, state.rng)

    poses = np.asarray(jax.device_get(state.poses), np.float64)
    gt = np.stack([np.asarray(f.gt_c2w, np.float64) for f in frames])

    @jax.jit
    def ssim_of(img, rgb_u8):
        _, s = ssim_fn(img, rgb_u8.astype(jnp.float32) / 255.0)
        return s

    params = map_params(state.gmap)
    psnrs, ssims = [], []
    for i in range(n):
        w2c = invert_se3(jnp.asarray(poses[i], jnp.float32))
        img, p = eng.fused.render_eval(params, state.gmap.live, w2c,
                                       rgbs[i], depths[i])
        psnrs.append(float(jax.device_get(p)))
        ssims.append(float(jax.device_get(ssim_of(img, rgbs[i]))))
    print(json.dumps({
        "flow": "bench.py", "training_stage": stage, "width": args.width,
        "height": args.height, "frames": n, "seed": seed,
        "max_per_tile": cfg.render.max_per_tile, "buckets": buckets,
        "ate_rmse_m": float(ate_rmse(gt, poses)),
        "psnr_pre_refine_db": float(np.mean(psnrs)),
        "psnr_pre_refine_min_db": float(np.min(psnrs)),
        "ssim_pre_refine": float(np.mean(ssims)),
        "num_gaussians": int(jax.device_get(state.gmap.num_live)),
        "kf_total": int(jax.device_get(state.kf_total)),
        "kf_count": int(jax.device_get(state.kf_count)),
        "vis_cap_dropped": int(jax.device_get(state.stat_vis_dropped)),
        "tile_cap_dropped": int(jax.device_get(state.stat_pair_dropped)),
        "per_frame_psnr": psnrs, "per_frame_ssim": ssims,
        "draws": draws, "refine_draws": refine_draws,
    }), flush=True)


def one_chunk(cfg):
    """The config with every tile in one lax.map step of the XLA
    compositor (composite_chunk = the tile count, no padded tiles: at the
    default 64 the 9 tiles of a 96x72 frame are padded to 64, each
    composited at the full K).  The port has no such knob; tiles are
    composited independently either way."""
    t = cfg.render.tile_size
    tiles = -(-cfg.intr.width // t) * -(-cfg.intr.height // t)
    return cfg.replace(render=dataclasses.replace(cfg.render,
                                                  composite_chunk=tiles))


def stress_reference(name):
    """One stress scenario through the JAX FusedEngine, eval_stride 4."""
    import numpy as np

    import jax

    from gs_icp_slam_tpu.config import synthetic_config
    from gs_icp_slam_tpu.datasets import open_dataset
    from gs_icp_slam_tpu.slam import FusedEngine
    from gs_icp_slam_tpu.slam.fused import REFINE_CHUNK

    seq, cfg = stress_config(synthetic_config, open_dataset, **STRESS[name])
    eng = FusedEngine(seq, one_chunk(cfg), seed=0)
    counters = []
    counting_step(eng, counters)
    res = eng.run(eval_render=True, eval_stride=4)
    iters_final = cfg.engine.mapping_iters_final
    draws, refine_draws = derive_draws(
        0, counters, cfg.engine.mapping_iters_per_frame,
        cfg.engine.keyframe_capacity, eng.state.rng,
        refine_chunks=-(-iters_final // REFINE_CHUNK))
    kf_rgb = np.asarray(jax.device_get(eng.state.kf_rgb))
    print(json.dumps({
        "scenario": name, **STRESS[name], "ate_m": res.ate_rmse,
        "psnr_mean": res.psnr, "num_gaussians": res.num_gaussians,
        "kf_total": res.kf_total, "kf_count": res.kf_stored,
        "vis_cap_dropped": res.vis_cap_dropped,
        "tile_cap_dropped": res.tile_cap_dropped,
        "kf_slots_textured": int((kf_rgb.reshape(kf_rgb.shape[0], -1)
                                  .std(axis=1) > 0).sum()),
        "per_frame_psnr": [float(x) for x in res.per_frame_psnr],
        "draws": draws,
    }), flush=True)


if __name__ == "__main__":
    main()
