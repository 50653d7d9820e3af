"""The rank programs of tests/test_torch_parallel.py.

`start` starts one process per rank (multiprocessing's spawn method), each
joins a gloo group through a file store under the test's directory with a
120 s limit, runs one scenario of this module on the CPU and saves what it
computed (torch.save) for the test to compare; every process is joined
under a time limit by `join`, so a hung rendezvous fails the test.  This module
imports torch and the port only: the children never import JAX.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os

import numpy as np
import torch
import torch.distributed as dist

JOIN_S = 120


def start(scenario: str, world: int, out_dir: str, args: dict):
    """Start `scenario` on `world` ranks (join with `join`)."""
    store = os.path.join(out_dir, f"{scenario}.store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(scenario, r, world, store, out_dir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return scenario, procs, out_dir


def join(started, timeout_s: float = 300.0) -> list:
    """Wait for the ranks of `start` (killing those still running after
    timeout_s); returns each rank's result."""
    scenario, procs, out_dir = started
    for p in procs:
        p.join(timeout_s)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"{scenario}: ranks {hung} did not finish in {timeout_s} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * len(procs), f"{scenario}: exit codes {codes}"
    return [torch.load(os.path.join(out_dir, f"{scenario}-{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def _rank_main(scenario, rank, world, store, out_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=JOIN_S))
    try:
        from gs_icp_slam_torch.parallel import make_mesh
        out = SCENARIOS[scenario](make_mesh("cpu"), out_dir, **args)
        torch.save(out, os.path.join(out_dir, f"{scenario}-{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ shared configurations ---

def tiny_cfg(mode: str, cap: int = 1024):
    """tests/test_parallel.py's 64x48 configuration."""
    from gs_icp_slam_torch.config import synthetic_config
    from gs_icp_slam_torch.utils.camera import Intrinsics

    w, h = 64, 48
    intr = Intrinsics(width=w, height=h, fx=60.0, fy=60.0, cx=(w - 1) / 2,
                      cy=(h - 1) / 2, depth_scale=1000.0, depth_trunc=8.0)
    cfg = synthetic_config(intr, capacity=cap, target_capacity=256,
                           visible_capacity=256)
    return cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                  parallel_mode=mode))


def engine_cfg(mode: str):
    """tests/test_parallel.py's engine configuration (96x72, downsample
    4, capacity 2^13, 2 mapping iterations a frame), with no final
    refinement (64 iterations, ~16 s a run on one CPU thread), 8-pixel
    tiles (short runs for the CPU's plain compositor, which walks a
    tile's run one rank at a time) and K <= 256."""
    from gs_icp_slam_torch.config import synthetic_config
    from gs_icp_slam_torch.datasets import open_dataset

    seq = open_dataset("synthetic", width=96, height=72, num_frames=10)
    cfg = synthetic_config(seq.intr, downsample_rate=4, capacity=1 << 13,
                           target_capacity=1 << 11, visible_capacity=1 << 11)
    return seq, cfg.replace(
        engine=dataclasses.replace(
            cfg.engine, mapping_iters_per_frame=2, mapping_iters_final=0,
            keyframe_capacity=16, parallel_mode=mode),
        render=dataclasses.replace(cfg.render, tile_size=8,
                                   max_per_tile=256))


class NewestDraws:
    """Draws that pick the same keyframe however many are taken: always
    maxval - 1 (the newest stored slot until the store evicts)."""

    def __call__(self, maxval: int) -> int:
        return maxval - 1


def _map_arrays(gmap) -> dict:
    return {f: getattr(gmap, f).clone() for f in gmap._fields if f != "n"}


# ------------------------------------------------------------ scenarios ---

def world2(mesh, out_dir, map_np, batch_np):
    """Everything the world-size-2 tests read: the batched steps
    (opt_steps), the layout, the fused steps' collectives and the engine
    runs (engines)."""
    out = opt_steps(mesh, map_np, batch_np)
    out["engines"] = engines(mesh, out_dir)
    return out


def opt_steps(mesh, map_np, batch_np):
    """opt_step_batched in dp and fsdp and make_parallel_opt_step on the
    64x48 map and keyframe batch (numpy inputs from the test), each with
    the bytes of its collectives; the layout after place_state in both
    modes; the collectives of three dp fused steps."""
    from gs_icp_slam_torch import convert
    from gs_icp_slam_torch.models import adam_init, map_params
    from gs_icp_slam_torch.parallel import (make_parallel_opt_step,
                                            place_state, shard_map_state,
                                            state_shardings)
    from gs_icp_slam_torch.parallel.sharded import gather_map
    from gs_icp_slam_torch.slam.fused import make_mapping_primitives
    from gs_icp_slam_torch.slam.state import init_state

    gmap = convert.map_from_numpy(map_np, device="cpu")
    w2c_b, rgb_b, depth_b = (torch.from_numpy(a) for a in batch_np)
    out = {}
    for mode in ("dp", "fsdp", "standalone"):
        cfg = tiny_cfg("fsdp" if mode == "standalone" else mode)
        params, adam, live = map_params(gmap), adam_init(map_params(gmap)), \
            gmap.live
        if mode != "dp":
            params, adam, live = shard_map_state(mesh, params, adam, live)
        mesh.audit = []
        if mode == "standalone":
            p, a, loss = make_parallel_opt_step(mesh, cfg).step(
                params, adam, live, w2c_b, rgb_b, depth_b)
        else:
            prim = make_mapping_primitives(cfg, "cpu", mesh)
            p, a, loss, _ = prim.opt_step_batched(params, adam, live, w2c_b,
                                                  rgb_b, depth_b)
        audit, mesh.audit = mesh.audit, None
        if mode != "dp":
            m = gather_map(gmap._replace(**p), mesh)
            p = map_params(m)
            a = a._replace(m={k: mesh.all_gather(v) for k, v in a.m.items()})
        out[mode] = dict(params=p, adam_m=a.m, adam_step=a.step,
                         loss=float(loss), audit=audit)

    cfg = tiny_cfg("fsdp")
    layout = {}
    for mode in ("dp", "fsdp"):
        st = place_state(init_state(cfg, 4, np.eye(4, dtype=np.float32),
                                    "cpu"), mesh, mode=mode)
        shapes = {"gmap." + f: tuple(getattr(st.gmap, f).shape)
                  for f in st.gmap._fields if f != "n"}
        shapes.update({f"adam.m.{k}": tuple(v.shape)
                       for k, v in st.adam.m.items()})
        shapes.update({f"target.{f}": tuple(getattr(st.target, f).shape)
                       for f in ("points", "valid")})
        shapes.update({f: tuple(getattr(st, f).shape)
                       for f in ("poses", "kf_rgb", "kf_depth")})
        layout[mode] = dict(shapes=shapes, n=st.gmap.n,
                            shardings=state_shardings(mode=mode))
    out["layout"] = layout
    out["fused_audit"] = fused_step_audit(mesh)
    return out


def fused_step_audit(mesh, iters: int = 2, frames: int = 3):
    """The collectives of `frames` dp fused steps (frame 0, then tracked
    frames) on the 64x48 synthetic sequence."""
    from gs_icp_slam_torch.datasets import open_dataset
    from gs_icp_slam_torch.parallel import place_state
    from gs_icp_slam_torch.slam.fused import make_fused_step, to_chw
    from gs_icp_slam_torch.slam.state import init_state
    from gs_icp_slam_torch.utils.pointcloud import make_downsample_filter

    cfg = tiny_cfg("dp")
    seq = open_dataset("synthetic", width=64, height=48, num_frames=frames)
    cfg = cfg.replace(intr=seq.intr, engine=dataclasses.replace(
        cfg.engine, mapping_iters_per_frame=iters, keyframe_capacity=4))
    intr = cfg.intr
    filt = make_downsample_filter(intr.width, intr.height, intr.fx, intr.fy,
                                  intr.cx, intr.cy, cfg.downsample_rate)
    fused = make_fused_step(cfg, filt, NewestDraws(), "cpu", mesh)
    state = place_state(init_state(cfg, frames, seq[0].gt_c2w, "cpu"), mesh,
                        mode="dp")
    mesh.audit = []
    for i in range(frames):
        fr = seq[i]
        state = fused.step(state, torch.from_numpy(fr.depth),
                           to_chw(fr.rgb, "cpu"), i == frames - 1)
    audit, mesh.audit = mesh.audit, None
    return dict(audit=audit, opt_steps=state.train_iter,
                kf_total=state.kf_total)


def engines(mesh, out_dir):
    """FusedEngine runs on the engine configuration with TorchDraws(0):
    each mode's result, whole map and replicated fields; the fsdp run
    autosaves every 4 frames, and a new engine resumes from the last
    save (frame 8)."""
    from gs_icp_slam_torch.parallel.sharded import gather_state
    from gs_icp_slam_torch.slam import FusedEngine

    out = {}
    ck = os.path.join(out_dir, "auto.npz")
    for mode in ("dp", "fsdp"):
        seq, cfg = engine_cfg(mode)
        eng = FusedEngine(seq, cfg, device="cpu", mesh=mesh)
        kw = {}
        if mode == "fsdp":
            kw = dict(checkpoint_every=4, checkpoint_path=ck)
        res = eng.run(eval_render=True, eval_stride=4, **kw)
        whole = gather_state(eng.state, mesh, eng.mode)
        out[mode] = dict(
            poses=res.poses, ate=res.ate_rmse, psnr=res.psnr,
            num_gaussians=res.num_gaussians, kf_total=res.kf_total,
            kf_stored=res.kf_stored, vis=res.vis_cap_dropped,
            tile=res.tile_cap_dropped, gmap=_map_arrays(whole.gmap),
            n=whole.gmap.n, target=whole.target.points.clone(),
            kf_w2c=whole.kf_w2c.clone(), kf_rgb=whole.kf_rgb.clone(),
            kf_depth=whole.kf_depth.clone(), local_rows=eng.state.gmap
            .capacity, ply_rows=eng.save_ply(os.path.join(
                out_dir, f"{mode}-{mesh.rank}.ply")))
    seq, cfg = engine_cfg("fsdp")
    eng = FusedEngine(seq, cfg, device="cpu", mesh=mesh)
    res = eng.run(eval_render=False, resume_from=ck)
    whole = gather_state(eng.state, mesh, eng.mode)
    out["resumed"] = dict(poses=res.poses, gmap=_map_arrays(whole.gmap),
                          train_iter=eng.state.train_iter)
    return out


def world1(mesh):
    """The engine configuration with NewestDraws: FusedEngine without a
    mesh, then with a world-1 mesh in dp and in fsdp."""
    from gs_icp_slam_torch.slam import FusedEngine

    out = {}
    for mode in (None, "dp", "fsdp"):
        seq, cfg = engine_cfg(mode or "auto")
        eng = FusedEngine(seq, cfg, device="cpu", draws=NewestDraws(),
                          mesh=None if mode is None else mesh)
        res = eng.run(eval_render=True, eval_stride=4)
        out[mode or "none"] = dict(
            poses=res.poses, psnr=res.per_frame_psnr,
            counts=(res.num_gaussians, res.kf_total, res.kf_stored),
            gmap=_map_arrays(eng.state.gmap), n=eng.state.gmap.n,
            adam_m=dict(eng.state.adam.m), target=eng.state.target.points,
            train_iter=eng.state.train_iter)
    return out


SCENARIOS = {"world2": world2}
