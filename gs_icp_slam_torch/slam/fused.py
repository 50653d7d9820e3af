"""The fused per-frame SLAM step and its engine (counterpart of
gs_icp_slam_tpu/slam/fused.py): `MappingPrimitives`, `make_fused_step`
(`step`, `step_chunk`, `refine`, `render_eval`) and `FusedEngine`.

Per frame, as in the JAX step (fused.py:511-647):
  preprocess ................. the downsampled, unprojected frame
  frame 0 .................... exact 20-NN target covariances (kernel K3),
                               first Gaussians, first keyframe
  later frames ............... grid k-NN source covariances; the adaptive
                               constant-position / constant-velocity seed;
                               G-ICP (kernel K2 per Gauss-Newton iteration);
                               overlap ratio from the last linearization's
                               correspondences; tracking and mapping
                               keyframe decisions; overlap dedup and
                               insertion; target export on tracking
                               keyframes (covariance sharing)
  keyframe store ............. reservoir eviction once full
  mapping iterations ......... newest keyframe first, then uniform picks;
                               pruning every prune_interval; one opt step
                               each (render K1-fwd, loss, K1-bwd, Adam)

The JAX step is one XLA program; here it is eager PyTorch with the control
flow on the host: keyframe decisions, the Gauss-Newton loop's convergence
test and the insertion count are synced scalars (chip_smoke.py counts the
syncs per frame).  On a card without a mesh the single-view opt step, which
has no sync, runs as one CUDA graph per capacity bucket (`OptGraph`),
captured on the bucket's first step and replayed after; the CPU and mesh
paths run it eagerly.  Left behind as TPU mechanics: layout pins, the
gutted-state lax.cond, lax.scan against compile time and donation.

With a mesh (parallel.make_mesh), the step and engine run on every rank of
a torch.distributed group, as the JAX step runs under a device mesh: each
mapping iteration draws W keyframe indices after its usual draw, sets the
first to the usual pick, and rank r renders keyframe r through
`opt_step_batched` (parallel/mapping.py: dp or fsdp, cfg.engine.
parallel_mode).  In fsdp the map is split along capacity
(parallel/sharded.py): the prune stays on the shard, an insert writes the
rank's part of its slots, the target export gathers the ranks' candidate
lists, and `render_eval` gathers the map first.  Every rank's draw source
must be identical; tracking, keyframe decisions and every other field are
computed alike on every rank.  A mesh run uses no buckets, and `refine`
ignores its bucket (JAX's mesh jits do the same).

Capacity buckets are kept as semantics.  The engine picks (n_bucket,
t_bucket) from the map's size every BUCKET_SYNC frames; mapping, the
prune, Adam and the target export see the map's first n_bucket slots, and
tracking the target's first t_bucket.  Splats inserted past the bucket
between two picks wait for the next pick, as in JAX.  Each bucket is a
view of the live prefix (nothing to recompile).

Random draws come from one small object the engine passes in: a callable
`draws(maxval) -> int` uniform in [0, maxval).  The step calls it where
the JAX step draws, the draws JAX throws away included: a keyframe index
on every mapping iteration (fused.py:400-404) and a reservoir victim on
every keyframe store (fused.py:489-491).  `TorchDraws` (a torch.Generator
seeded from `seed`) is the default; `RecordedDraws` replays a recorded
sequence, such as the JAX engine's.  The JAX state carries its PRNG key,
so a step on a copy of the state leaves the original's draws alone; here
the stream belongs to the engine, so a caller that steps a copy
(`state.copy_state`) saves `draws.position()` first and `restore`s it
afterwards.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..config import SLAMConfig
from ..models import (AdamState, GaussianMap, add_gaussians, adam_step,
                      inv_bias_corrections, map_lr_tree, map_params,
                      prune_large_and_transparent, trackable_export,
                      trackable_mask, with_params)
from ..ops.gicp import (GICPTarget, gicp_align, make_source,
                        target_from_gaussians, target_from_points)
from ..ops.rasterize import rasterize_tiled, tile_capacity
from ..parallel.mapping import batched_opt_step, gather_params
from ..parallel.sharded import (add_gaussians_sharded, choose_mode,
                                gather_map, gather_state, num_live,
                                place_state, shard_rows,
                                trackable_export_sharded)
from ..utils.losses import mapping_loss
from ..utils.pointcloud import DownsampleFilter
from ..utils.quat import quat_multiply, rotmat_to_quat
from ..utils.se3 import invert_se3, transform_points
from .state import SLAMState, init_state

REFINE_CHUNK = 64  # post-run refinement iterations per refine() call


class MappingPrimitives(NamedTuple):
    raster: Callable     # partial of rasterize_tiled at the cfg geometry
    opt_loss: Callable   # (params, live, w2c, rgb_u8, depth_raw)
                         #   -> (loss, stats)
    opt_step: Callable   # (params, adam, live, w2c, rgb_u8, depth_raw[,
                         #  inv_bc]) -> (params, adam, loss, stats)
    opt_step_batched: Callable | None  # the mesh step, one keyframe per
                         # rank (None without a mesh)
    sh_concat: Callable  # params -> (C, (sh+1)^2, 3) SH coefficients


def _downsample_gt(gt_img, gt_depth, sdiv: int):
    """Ground truth at 1/sdiv resolution for training stages 1/2 (the
    reference pre-computed pyramids, shared_objs.py:146-155): RGB (3, H, W)
    by the area mean of sdiv x sdiv blocks, depth (H, W) by the nearest
    sample (INTER_NEAREST, shared_objs.py:152-153), which keeps exact zeros
    and with them the depth-validity mask; both cropped to whole blocks."""
    if sdiv == 1:
        return gt_img, gt_depth
    sh_px, sw = gt_depth.shape[0] // sdiv, gt_depth.shape[1] // sdiv
    img = gt_img[:, :sh_px * sdiv, :sw * sdiv].reshape(
        3, sh_px, sdiv, sw, sdiv).mean(dim=(2, 4))
    dep = gt_depth[:sh_px * sdiv:sdiv, :sw * sdiv:sdiv]
    return img, dep


def make_mapping_primitives(cfg: SLAMConfig, device="cuda", mesh=None,
                            n_cap: int | None = None) -> MappingPrimitives:
    """Build the single-keyframe mapping step for a config on one device.

    With `mesh`: also `opt_step_batched`, the mapping step of the mode
    cfg.engine.parallel_mode resolves to (parallel/mapping.py
    batched_opt_step): (params, adam, live, w2c_b, rgb_b, depth_b) with a
    batch of mesh.size keyframes, rank r rendering keyframe r; the whole
    map in dp, the rank's shard in fsdp.

    `n_cap`: the capacity bucket the step will see (the fused engine's
    buckets) — caps the per-view visible budget V, and with it the
    per-tile capacity K, so that they track the map's scale.

    Training stages 1/2 optimise at half/quarter resolution (the
    reference's render_3 resolution switch, gaussian_renderer/__init__.py:
    237-242): `opt_step` renders at width//sdiv x height//sdiv, sdiv =
    2*stage, with the scaled focal lengths and centres, the full visible
    capacity and K = max_per_tile, against the downsampled ground truth;
    `raster` (evaluation) stays at full resolution."""
    intr, rc = cfg.intr, cfg.render
    lrs = map_lr_tree(cfg.opt)
    bg = torch.tensor(rc.bg_color, dtype=torch.float32,
                      device=resolve_device(device))
    fx, fy = intr.fx, intr.fy
    rcx, rcy = (intr.width - 1) / 2.0, (intr.height - 1) / 2.0
    v_cap = rc.visible_capacity if n_cap is None else min(
        rc.visible_capacity, n_cap)
    raster = partial(
        rasterize_tiled, sh_degree=cfg.map.sh_degree, width=intr.width,
        height=intr.height, tile=rc.tile_size, visible_cap=v_cap,
        tile_span=rc.tile_span,
        tile_cap=tile_capacity(intr.width, intr.height, rc.tile_size,
                               rc.tile_span, v_cap, rc.max_per_tile))
    stage = cfg.opt.training_stage
    sdiv = 2 * stage if stage > 0 else 1
    if stage > 0:
        sw, sh_px = intr.width // sdiv, intr.height // sdiv
        raster_opt = partial(
            rasterize_tiled, sh_degree=cfg.map.sh_degree, width=sw,
            height=sh_px, tile=rc.tile_size,
            visible_cap=rc.visible_capacity, tile_span=rc.tile_span,
            tile_cap=rc.max_per_tile)
        ofx, ofy = fx / sdiv, fy / sdiv
        ocx, ocy = (sw - 1) / 2.0, (sh_px - 1) / 2.0
    else:
        raster_opt = raster
        ofx, ofy, ocx, ocy = fx, fy, rcx, rcy

    def sh_concat(params):
        return torch.cat([params["f_dc"][:, None, :], params["f_rest"]], 1)

    def opt_loss(params, live, w2c, rgb_u8, depth_raw):
        # rgb_u8 is channel-first (3, H, W) uint8
        gt_img = rgb_u8.to(torch.float32) / 255.0
        gt_depth = depth_raw / intr.depth_scale
        gt_img, gt_depth = _downsample_gt(gt_img, gt_depth, sdiv)
        out = raster_opt(params["xyz"], params["rotation"],
                         torch.exp(params["log_scaling"]),
                         torch.sigmoid(params["opacity_logit"][:, 0]),
                         sh_concat(params), w2c, live, bg, ofx, ofy, ocx,
                         ocy)
        loss, _ = mapping_loss(out.color, out.depth, gt_img, gt_depth,
                               lambda_dssim=cfg.opt.lambda_dssim,
                               depth_weight=cfg.opt.depth_loss_weight,
                               d_max=cfg.opt.depth_d_max)
        return loss, out.stats

    def opt_step(params, adam, live, w2c, rgb_u8, depth_raw, inv_bc=None):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss, stats = opt_loss(leaves, live, w2c, rgb_u8, depth_raw)
        got = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
        grads = {k: torch.zeros_like(p) if d is None else d
                 for (k, p), d in zip(params.items(), got)}
        params, adam = adam_step(params, grads, adam, lrs, live,
                                 b1=cfg.opt.adam_b1, b2=cfg.opt.adam_b2,
                                 eps=cfg.opt.adam_eps, inv_bc=inv_bc)
        return params, adam, loss.detach(), stats

    opt_step_batched = None
    if mesh is not None:
        mode = choose_mode(cfg.map.capacity, cfg.map.sh_degree,
                           cfg.engine.parallel_mode)
        opt_step_batched = batched_opt_step(mesh, mode, opt_loss, lrs,
                                            cfg.opt)
    return MappingPrimitives(raster=raster, opt_loss=opt_loss,
                             opt_step=opt_step,
                             opt_step_batched=opt_step_batched,
                             sh_concat=sh_concat)


class OptGraph:
    """One capacity bucket's single-view opt step (`opt_step`: K1-fwd
    after projection, compaction and binning, the loss, the gradient with
    K1-bwd, the masked Adam update) as a CUDA graph, captured once and
    replayed for every later opt step in the bucket.

    A graph reads and writes fixed addresses, while the engine builds a
    fresh state each episode and callers step copies of states, so the
    graph owns its working set: the bucket's parameters, Adam moments and
    live mask, one keyframe's w2c, RGB and depth, and the reciprocals of
    Adam's bias corrections as two 0-d tensors (written with fill_, which
    passes the value as a kernel argument: no upload, no sync).  `load`
    copies a state's bucket slice in, `step` one keyframe and the step's
    bias corrections, `store` the slice back out.  The bucket's first
    step runs eagerly on a side stream, which fills the per-device
    constant caches and the allocator so that the capture makes no
    host-to-device copy; the graph is captured after it, into a memory
    pool of its own (buckets rise within an episode and start small again
    in the next, so no shared pool sees its graphs replayed in capture
    order).  `counters` counts captures, replays and the eager steps."""

    def __init__(self, prim: MappingPrimitives, gmap: GaussianMap,
                 state: SLAMState, opt_cfg, counters: dict):
        self.prim = prim
        self.betas = (opt_cfg.adam_b1, opt_cfg.adam_b2)
        self.counters = counters
        self.params = {k: torch.empty_like(p)
                       for k, p in map_params(gmap).items()}
        self.m = {k: torch.empty_like(p) for k, p in self.params.items()}
        self.v = {k: torch.empty_like(p) for k, p in self.params.items()}
        self.live = torch.empty_like(gmap.live)
        self.w2c = torch.empty_like(state.kf_w2c[0])
        self.rgb = torch.empty_like(state.kf_rgb[0])
        self.depth = torch.empty_like(state.kf_depth[0])
        self.inv_bc = tuple(torch.empty((), dtype=torch.float32,
                                        device=self.live.device)
                            for _ in range(2))
        self.graph = None
        self.stats = None  # the graph's stats output

    def load(self, gmap: GaussianMap, adam: AdamState):
        """Copy a state's bucket slice in; returns the map and Adam state
        to step, on the graph's buffers."""
        for k, p in map_params(gmap).items():
            self.params[k].copy_(p)
            self.m[k].copy_(adam.m[k])
            self.v[k].copy_(adam.v[k])
        self.live.copy_(gmap.live)
        return (with_params(gmap, self.params)._replace(live=self.live),
                AdamState(m=self.m, v=self.v, step=adam.step))

    def store(self, gmap: GaussianMap, adam: AdamState) -> None:
        """Copy the buffers back into a state's bucket slice, in place."""
        for k, p in map_params(gmap).items():
            p.copy_(self.params[k])
            adam.m[k].copy_(self.m[k])
            adam.v[k].copy_(self.v[k])
        gmap.live.copy_(self.live)

    def step(self, gmap: GaussianMap, adam: AdamState, w2c, rgb_u8,
             depth_raw):
        """One opt step of the map and Adam state that `load` returned
        (its live mask possibly pruned since): (gmap, adam, stats)."""
        if gmap.live is not self.live:
            self.live.copy_(gmap.live)
        self.w2c.copy_(w2c)
        self.rgb.copy_(rgb_u8)
        self.depth.copy_(depth_raw)
        t = adam.step + 1
        for buf, x in zip(self.inv_bc, inv_bias_corrections(t, *self.betas)):
            buf.fill_(x)
        if self.graph is None:
            stats = self._capture()
        else:
            self.graph.replay()
            self.counters["replays"] += 1
            stats = self.stats
        return gmap._replace(live=self.live), adam._replace(step=t), stats

    def _body(self):
        params, adam, _, stats = self.prim.opt_step(
            self.params, AdamState(m=self.m, v=self.v, step=0), self.live,
            self.w2c, self.rgb, self.depth, inv_bc=self.inv_bc)
        for k, p in self.params.items():
            p.copy_(params[k])
            self.m[k].copy_(adam.m[k])
            self.v[k].copy_(adam.v[k])
        return stats

    def _capture(self):
        dev = self.live.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            stats = self._body()  # this step, eagerly
        main.wait_stream(side)
        self.counters["eager_opt_steps"] += 1
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.stats = self._body()
        self.graph = graph
        self.counters["captures"] += 1
        return stats


# ------------------------------------------------------------ draws ------

class TorchDraws:
    """Uniform integer draws from a CPU torch.Generator seeded from seed
    (host-side: a draw costs no device sync)."""

    def __init__(self, seed: int = 0):
        self.gen = torch.Generator().manual_seed(seed)

    def __call__(self, maxval: int) -> int:
        return int(torch.randint(maxval, (), generator=self.gen))

    def position(self) -> torch.Tensor:
        """Where the stream stands: the generator's state."""
        return self.gen.get_state()

    def restore(self, pos: torch.Tensor) -> None:
        self.gen.set_state(pos)


class RecordedDraws:
    """Replays a recorded sequence of [maxval, value] pairs, in order.
    Raises if the step asks for another maxval than was recorded (the run
    has taken another keyframe decision) or, unless a source `then` is
    given to continue from, for more draws than there are."""

    def __init__(self, pairs, then=None):
        self.pairs = [(int(m), int(v)) for m, v in pairs]
        self.used = 0
        self.then = then

    def __call__(self, maxval: int) -> int:
        if self.used >= len(self.pairs):
            if self.then is None:
                raise RuntimeError(f"draw {self.used}: the recording has "
                                   f"only {len(self.pairs)} draws")
            self.used += 1
            return self.then(maxval)
        m, v = self.pairs[self.used]
        if m != maxval:
            raise RuntimeError(f"draw {self.used}: maxval {maxval}, the "
                               f"recording has {m}")
        self.used += 1
        return v

    def position(self):
        """Where the stream stands: the draws taken (and the position of
        the source it continues from)."""
        return (self.used,
                None if self.then is None else self.then.position())

    def restore(self, pos) -> None:
        self.used = pos[0]
        if self.then is not None:
            self.then.restore(pos[1])


# ------------------------------------------------------------ the step ---

class FusedStep(NamedTuple):
    step: Callable         # (state, depth, rgb_chw, is_last[, nb, tb])
                           #   -> state
    step_chunk: Callable   # (state, depth (C,H,W), rgb (C,3,H,W),
                           #  is_last (C,)[, nb, tb]) -> state
    render_eval: Callable  # (params, live, w2c, rgb_chw, depth)
                           #   -> (img, psnr)
    refine: Callable       # (state[, nb]) -> state: REFINE_CHUNK mapping
                           # iterations
    counters: dict         # captures, replays, eager_opt_steps: how the
                           # opt steps ran (OptGraph); insert_dropped,
                           # export_dropped: rows the map's and the
                           # target's capacity left out


def to_chw(rgb_hwc, device="cuda") -> torch.Tensor:
    """Host (H, W, 3) uint8 -> channel-first (3, H, W) on the device (every
    step input takes channel-first images, as in the JAX package)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(rgb_hwc).transpose(2, 0, 1))).to(resolve_device(device))


def _slice_map(m: GaussianMap, nb):
    if nb is None or nb >= m.capacity:
        return m
    return GaussianMap(**{f: (m.n if f == "n" else getattr(m, f)[:nb])
                          for f in m._fields})


def _write_prefix(full: torch.Tensor, part: torch.Tensor) -> None:
    dst = full[:part.shape[0]]
    if dst.data_ptr() != part.data_ptr():
        dst.copy_(part)


def _unslice_map(full: GaussianMap, part: GaussianMap, nb) -> GaussianMap:
    """Write the bucket's slots back into the full-capacity map (in place:
    the state owns the full tensors)."""
    if nb is None or nb >= full.capacity:
        return part
    for f in full._fields:
        if f != "n":
            _write_prefix(getattr(full, f), getattr(part, f))
    return full._replace(n=part.n)


def _slice_adam(a: AdamState, nb) -> AdamState:
    if nb is None:
        return a
    return AdamState(m={k: v[:nb] for k, v in a.m.items()},
                     v={k: v[:nb] for k, v in a.v.items()}, step=a.step)


def _unslice_adam(full: AdamState, part: AdamState, nb) -> AdamState:
    if nb is None:
        return part
    for k in full.m:
        _write_prefix(full.m[k], part.m[k])
        _write_prefix(full.v[k], part.v[k])
    return full._replace(step=part.step)


def _slice_target(t: GICPTarget, tb) -> GICPTarget:
    if tb is None or tb >= t.capacity:
        return t
    # the 1-NN kernel takes contiguous rows: one small copy per frame
    # (K2 skips the order's entries past the slice)
    return GICPTarget(points=t.points[:, :tb].contiguous(),
                      cov6=t.cov6[:, :tb].contiguous(), valid=t.valid[:tb],
                      nn_bias=t.nn_bias[:, :tb].contiguous(),
                      nn_order=t.nn_order)


def make_fused_step(cfg: SLAMConfig, filt: DownsampleFilter, draws,
                    device="cuda", mesh=None) -> FusedStep:
    """Build the fused frame step for one device, or with `mesh` for this
    rank of the mesh (on mesh.device; the state is the rank-local one,
    parallel.place_state).  `draws(maxval) -> int` is the source of the
    step's random draws (see the module docstring)."""
    dev = resolve_device(device) if mesh is None else mesh.device
    mode = None if mesh is None else choose_mode(
        cfg.map.capacity, cfg.map.sh_degree, cfg.engine.parallel_mode)
    sharded = mode == "fsdp"
    shards = mesh.size if sharded else 1  # a map holds capacity x shards
    intr = cfg.intr
    gicp_cfg = cfg.gicp
    tc = cfg.engine.target_capacity
    kc = cfg.engine.keyframe_capacity

    flat_idxs = torch.as_tensor(filt.flat_idxs, dtype=torch.long, device=dev)
    x_pre = torch.as_tensor(filt.x_pre, device=dev)
    y_pre = torch.as_tensor(filt.y_pre, device=dev)

    prims: dict = {}

    def get_prim(n_cap=None) -> MappingPrimitives:
        if n_cap not in prims:
            prims[n_cap] = make_mapping_primitives(cfg, dev, mesh,
                                                   n_cap=n_cap)
        return prims[n_cap]

    prim = get_prim()
    # the opt step runs as a CUDA graph per bucket on a card without a
    # mesh; on the CPU, and with a mesh (collectives), eagerly
    graphed = mesh is None and dev.type == "cuda"
    graphs: dict = {}
    counters = {"captures": 0, "replays": 0, "eager_opt_steps": 0,
                "insert_dropped": 0, "export_dropped": 0}
    bg = torch.tensor(cfg.render.bg_color, dtype=torch.float32, device=dev)
    fx, fy = intr.fx, intr.fy
    rcx, rcy = (intr.width - 1) / 2.0, (intr.height - 1) / 2.0

    def get_graph(n_bucket, gmap: GaussianMap, state: SLAMState) -> OptGraph:
        key = (n_bucket, gmap.capacity)
        if key not in graphs:
            graphs[key] = OptGraph(get_prim(n_bucket), gmap, state, cfg.opt,
                                   counters)
        return graphs[key]

    def mapping_iters(state: SLAMState, n_iters: int, n_bucket=None):
        gmap_full = state.gmap
        gmap = _slice_map(gmap_full, n_bucket)
        adam = _slice_adam(state.adam, n_bucket)
        prim_b = get_prim(n_bucket)
        graph = get_graph(n_bucket, gmap, state) if graphed else None
        # the map and Adam state the iterations step: the graph's buffers,
        # or the slice itself (replaced step by step)
        work, work_adam = ((gmap, adam) if graph is None
                           else graph.load(gmap, adam))
        vis_drop, pair_drop = state.stat_vis_dropped, state.stat_pair_dropped
        for it in range(n_iters):
            rand_idx = draws(max(state.kf_count, 1))
            idx = (state.new_kf if it == 0 and state.new_kf >= 0
                   else rand_idx)
            state.train_iter += 1
            if state.train_iter % cfg.map.prune_interval == 0:
                work = prune_large_and_transparent(
                    work, cfg.map.prune_min_opacity, cfg.map.prune_extent)
            if mesh is not None:
                # one keyframe per rank: the first takes the usual pick
                # (newest, then uniform), the others uniform draws
                idxs = [draws(max(state.kf_count, 1))
                        for _ in range(mesh.size)]
                idxs[0] = idx
            if state.kf_count == 0:
                continue  # frame 0 has no stored keyframe yet
            if graph is not None:
                work, work_adam, stats = graph.step(
                    work, work_adam, state.kf_w2c[idx], state.kf_rgb[idx],
                    state.kf_depth[idx])
            else:
                counters["eager_opt_steps"] += 1
                if mesh is None:
                    params, work_adam, _, stats = prim_b.opt_step(
                        map_params(work), work_adam, work.live,
                        state.kf_w2c[idx], state.kf_rgb[idx],
                        state.kf_depth[idx])
                else:
                    params, work_adam, _, stats = prim_b.opt_step_batched(
                        map_params(work), work_adam, work.live,
                        state.kf_w2c[idxs], state.kf_rgb[idxs],
                        state.kf_depth[idxs])
                work = with_params(work, params)
            vis_drop = torch.maximum(vis_drop, stats[1])
            pair_drop = torch.maximum(pair_drop, stats[2])
        if graph is None:
            state.gmap = _unslice_map(gmap_full, work, n_bucket)
            state.adam = _unslice_adam(state.adam, work_adam, n_bucket)
        else:
            graph.store(gmap, adam)
            state.adam = state.adam._replace(step=work_adam.step)
        state.new_kf = -1
        state.stat_vis_dropped, state.stat_pair_dropped = vis_drop, pair_drop
        return state

    def store_keyframe(state: SLAMState) -> None:
        """Pick a slot (uniform reservoir eviction once full) and update
        the counters; the caller writes the keyframe itself.  The victim is
        drawn on every store, as in JAX."""
        victim = draws(kc)
        state.new_kf = state.kf_count if state.kf_count < kc else victim
        state.kf_count = min(state.kf_count + 1, kc)
        state.kf_total += 1

    # the keyframe path's insert and target export are profiler spans;
    # each syncs on its row count, so its wall time holds its device work
    # up to that point.  Rows left out for want of capacity are counted
    # with one more sync, and only where there can be any: at a full map,
    # and where the export reads more used slots than the target has rows
    # (splats past the bucket wait for the next pick and are not counted)
    @torch.profiler.record_function("fused.insert")
    def insert(m: GaussianMap, points, colors, quats, scales, z, trackable,
               valid, init_opacity: float) -> GaussianMap:
        args = (points, colors, quats, scales, z, trackable, valid)
        if sharded:
            out = add_gaussians_sharded(m, mesh, *args,
                                        init_opacity=init_opacity)
        else:
            out = add_gaussians(m, *args, init_opacity=init_opacity)
        cap = m.capacity * shards
        if out.n == cap:
            counters["insert_dropped"] += int(valid.sum()) - (cap - m.n)
        return out

    @torch.profiler.record_function("fused.export")
    def export_target(gmap: GaussianMap, n_bucket=None) -> GICPTarget:
        th = cfg.map.trackable_opacity_th
        out_cap = tc if n_bucket is None else min(tc, n_bucket)
        if sharded:
            pts, rots, scales, valid = trackable_export_sharded(
                gmap, mesh, th, out_cap)
        else:
            gmap = _slice_map(gmap, n_bucket)
            pts, rots, scales, valid = trackable_export(gmap, th, out_cap)
        if min(gmap.n, gmap.capacity * shards) > out_cap:
            count = trackable_mask(gmap, th).sum().reshape(1)
            if sharded:
                mesh.all_reduce(count)
            counters["export_dropped"] += max(int(count) - out_cap, 0)
        return target_from_gaussians(pts, rots, scales, valid, gicp_cfg,
                                     capacity=tc)

    def first_frame(state, points, colors, z, valid, trackable):
        pose0 = state.poses[0]
        pts_w = transform_points(pose0, points)
        target, quat, scales = target_from_points(pts_w, trackable, gicp_cfg,
                                                  capacity=tc)
        state.gmap = insert(state.gmap, pts_w, colors, quat, scales, z,
                            trackable, valid,
                            init_opacity=cfg.map.init_opacity)
        state.target = target
        state.last_ratio = 0.0
        store_keyframe(state)
        state.frame_idx = 1
        state.from_last_kf = 0

    def track_frame(state, points, colors, z, valid, trackable, is_last,
                    t_bucket, n_bucket):
        source = make_source(points, valid, gicp_cfg, trackable=trackable,
                             grid=(filt.gh, filt.gw))
        fi = state.frame_idx
        prev = state.poses[fi - 1]
        init_T2 = None
        if gicp_cfg.motion_model in ("constant_velocity", "adaptive"):
            # extrapolate the last relative motion, T_{k-1} T_{k-2}^-1
            # T_{k-1}; constant position on frame 1
            prev2 = state.poses[max(fi - 2, 0)]
            cv = (prev @ invert_se3(prev2)) @ prev if fi >= 2 else prev
            if gicp_cfg.motion_model == "adaptive":
                init_T, init_T2 = prev, cv
            else:
                init_T = cv
        else:
            init_T = prev
        # the last linearization's correspondences feed the overlap test
        T, _, _, sqd = gicp_align(source, _slice_target(state.target,
                                                        t_bucket),
                                  init_T, gicp_cfg, init_T2=init_T2)
        pts_w = transform_points(T, source.points)
        n_track = source.valid.sum()
        overlap = (source.valid & (sqd < cfg.kf.overlapped_th)).sum()
        ratio = overlap / torch.clamp(n_track, min=1)
        rots_w = quat_multiply(rotmat_to_quat(T[:3, :3])[None], source.quat)

        tracking_kf = bool(is_last) or bool(ratio < cfg.kf.keyframe_th)
        from_last = 0 if tracking_kf else state.from_last_kf + 1
        mapping_kf = (not tracking_kf
                      and from_last % cfg.kf.keyframe_freq == 0)
        if tracking_kf or mapping_kf:
            # overlap dedup restricts the trackable mask on tracking
            # keyframes (mp_Tracker.py:266-275); all valid points insert
            new_trackable = (trackable & (sqd > cfg.kf.overlapped_th2)
                             if tracking_kf else trackable)
            insert_ok = valid
            if cfg.kf.insert_dedup_sqd > 0.0:
                insert_ok = insert_ok & (sqd > cfg.kf.insert_dedup_sqd)
            state.gmap = insert(state.gmap, pts_w, colors, rots_w,
                                source.scales, z, new_trackable, insert_ok,
                                init_opacity=cfg.map.init_opacity)
            store_keyframe(state)
        state.last_ratio = ratio
        if tracking_kf:
            # covariance sharing, map -> tracker (mp_Tracker.py:286-288)
            state.target = export_target(state.gmap, n_bucket)
        state.poses[fi] = T
        state.frame_idx = fi + 1
        state.from_last_kf = from_last

    def step(state: SLAMState, depth_raw, rgb_u8, is_last, n_bucket=None,
             t_bucket=None) -> SLAMState:
        """One frame: depth_raw (H, W) raw units, rgb_u8 (3, H, W) uint8,
        both on the state's device; is_last a host bool.  Updates the
        state in place and returns it."""
        # preprocess (mp_Tracker.py:415-431)
        z = depth_raw.reshape(-1)[flat_idxs].to(torch.float32) \
            / intr.depth_scale
        colors = (rgb_u8.reshape(3, -1)[:, flat_idxs].T.to(torch.float32)
                  / 255.0)
        points = torch.stack([x_pre * z, y_pre * z, z], dim=-1)
        valid = z != 0.0
        trackable = valid & (z <= intr.depth_trunc)

        total_before = state.kf_total
        if state.frame_idx == 0:
            first_frame(state, points, colors, z, valid, trackable)
        else:
            track_frame(state, points, colors, z, valid, trackable, is_last,
                        t_bucket, n_bucket)
        if state.kf_total > total_before:
            slot = state.new_kf
            state.kf_w2c[slot] = invert_se3(state.poses[state.frame_idx - 1])
            state.kf_rgb[slot] = rgb_u8
            state.kf_depth[slot] = depth_raw
        return mapping_iters(state, cfg.engine.mapping_iters_per_frame,
                             n_bucket)

    def step_chunk(state, depth_c, rgb_c, is_last_c, n_bucket=None,
                   t_bucket=None) -> SLAMState:
        for d, r, il in zip(depth_c, rgb_c, is_last_c):
            state = step(state, d, r, bool(il), n_bucket, t_bucket)
        return state

    def refine(state: SLAMState, n_bucket=None) -> SLAMState:
        """Post-run map refinement (the reference mapper free-runs after
        the tracker ends, mp_Mapper.py:154): REFINE_CHUNK iterations.  A
        mesh step ignores the bucket."""
        return mapping_iters(state, REFINE_CHUNK,
                             n_bucket if mesh is None else None)

    @torch.no_grad()
    def render_eval(params, live, w2c, rgb_u8, depth_raw):
        """The render of a view and its masked PSNR.  In fsdp a shard's
        params and live are gathered first (a collective); the whole map
        renders as it is."""
        if sharded and live.shape[0] < cfg.map.capacity:
            params, live = gather_params(mesh, params, live)
        gt_img = rgb_u8.to(torch.float32) / 255.0  # (3, H, W) input
        gt_depth = depth_raw / intr.depth_scale
        out = prim.raster(params["xyz"], params["rotation"],
                          torch.exp(params["log_scaling"]),
                          torch.sigmoid(params["opacity_logit"][:, 0]),
                          prim.sh_concat(params), w2c, live, bg, fx, fy, rcx,
                          rcy)
        mask = (gt_depth > 0.0)[None]
        mse = torch.sum(((out.color - gt_img) * mask) ** 2) / torch.clamp(
            mask.sum() * 3.0, min=1.0)
        return out.color, -10.0 * torch.log10(torch.clamp(mse, min=1e-12))

    return FusedStep(step=step, step_chunk=step_chunk,
                     render_eval=render_eval, refine=refine,
                     counters=counters)


# ------------------------------------------------------------ engine -----

class FusedEngine:
    """The engine of bench.py's path: one fused step per frame, capacity
    buckets, the reservoir keyframe store and post-run refinement.

    With `mesh` (parallel.make_mesh; the same call on every rank, with
    identical draw sources), each rank runs the engine on mesh.device: the
    map is whole (dp) or split along capacity (fsdp) per
    cfg.engine.parallel_mode, each mapping iteration optimizes mesh.size
    keyframes, and no buckets are used.  `state` is then the rank-local
    state.  The autosave, `save_checkpoint` and `save_ply` gather the state
    on every rank and only rank 0 writes; a resume loads the file on every
    rank and places it; `evaluate`, the eval renders and the viewers read
    the gathered map (only rank 0 writes evaluate's dump).  The ranks agree
    once per run on whether any passed a viewer, and then all gather the
    map for it each frame."""

    # how often the engine re-picks the capacity buckets from the map's
    # size.  Outgrowing a bucket between picks is soft: inserts land in
    # the full-capacity state; splats past the bucket wait <= BUCKET_SYNC
    # frames before mapping sees them, and the tracker's target is cut to
    # its bucket (the export puts valid slots first).
    BUCKET_SYNC = 8
    MIN_BUCKET = 1 << 14

    def __init__(self, dataset, cfg: SLAMConfig, seed: int = 0,
                 device="cuda", draws=None, mesh=None):
        """`draws`: the source of the step's random draws; by default a
        TorchDraws seeded from `seed`.  `mesh`: run as this rank of a
        mesh (on mesh.device); raises without an initialized process
        group, and unless the map capacity divides by the mesh size."""
        import torch.distributed as dist

        from ..utils.pointcloud import make_downsample_filter

        self.mesh = mesh
        self.mode = None
        if mesh is not None:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError("FusedEngine(mesh=) needs an initialized "
                                   "process group (parallel.init_distributed"
                                   " or a group passed to make_mesh)")
            shard_rows(mesh, cfg.map.capacity)  # raises unless it divides
            self.mode = choose_mode(cfg.map.capacity, cfg.map.sh_degree,
                                    cfg.engine.parallel_mode)
            device = mesh.device
        self.device = resolve_device(device)
        self.dataset = dataset
        self.cfg = cfg
        intr = cfg.intr
        self.filt = make_downsample_filter(
            intr.width, intr.height, intr.fx, intr.fy, intr.cx, intr.cy,
            cfg.downsample_rate)
        self.seed = seed
        self.draws = TorchDraws(seed) if draws is None else draws
        self.fused = make_fused_step(cfg, self.filt, self.draws, self.device,
                                     mesh)
        self.state: SLAMState | None = None

    @staticmethod
    def _pow2(x: int) -> int:
        return 1 << max(int(x) - 1, 1).bit_length()

    def _pick_buckets(self, n_now: int):
        """(n_bucket, t_bucket) covering n_now plus a two-keyframe insert
        margin (the target: one keyframe); None = full capacity.  A mesh
        run keeps the whole map (and whole shards)."""
        if self.mesh is not None:
            return None, None
        margin = 2 * self.filt.num_points
        cap = self.cfg.map.capacity
        nb = max(self._pow2(n_now + margin), self.MIN_BUCKET)
        n_bucket = None if nb >= cap else nb
        tc = self.cfg.engine.target_capacity
        tb = max(self._pow2(n_now + self.filt.num_points), 4096)
        t_bucket = None if tb >= tc else tb
        return n_bucket, t_bucket

    def _finalize(self, iters: int, n_bucket=None):
        for _ in range(-(-iters // REFINE_CHUNK) if iters > 0 else 0):
            self.state = self.fused.refine(self.state, n_bucket)

    def _frame(self, i: int):
        return self._on_device(self.dataset[i])

    def _on_device(self, fr):
        return (torch.from_numpy(np.asarray(fr.depth)).to(self.device),
                to_chw(fr.rgb, self.device))

    def _whole(self, state: SLAMState) -> SLAMState:
        """The whole state (a collective in fsdp: every rank calls it)."""
        if self.mesh is None:
            return state
        return gather_state(state, self.mesh, self.mode)

    def _whole_map(self, m: GaussianMap) -> GaussianMap:
        if self.mesh is None:
            return m
        return gather_map(m, self.mesh, self.mode)

    def _writes(self) -> bool:
        """Whether this process writes files: rank 0 of a mesh."""
        return self.mesh is None or self.mesh.rank == 0

    def run(self, eval_render: bool = True, eval_stride: int = 1,
            progress: bool = False, viewer=None, net_gui=None,
            checkpoint_every: int = 0, checkpoint_path: str = "",
            resume_from: str = ""):
        """checkpoint_every/checkpoint_path: periodic full-state autosave
        every N frames, with the draw source's position and the capacity
        buckets in use (a crash loses at most N frames, not the run).
        resume_from: continue a run from such a checkpoint (or the JAX
        package's) — frames before its frame_idx are skipped, and the
        draws and buckets continue from the saved ones where the file holds
        them (else the buckets are re-picked from the map's size, as in
        JAX).  viewer: a RerunLogger-like object (log_frame every frame;
        log_points and log_render on each new keyframe); net_gui: a
        NetworkGUI polled once a frame.  The live modes and the throttle
        step one frame at a time."""
        from ..eval.ate import ate_rmse
        from .engine import SLAMResult

        dataset, cfg = self.dataset, self.cfg
        n = len(dataset)
        buckets = None
        if resume_from:
            from ..io.checkpoint import load_fused_state, saved_buckets
            state = load_fused_state(resume_from, self.device, self.draws)
            if state.poses.shape[0] != n:
                raise ValueError("checkpoint was written for a different "
                                 "sequence length")
            buckets = saved_buckets(resume_from)
        else:
            f0 = dataset[0]
            pose0 = np.asarray(
                f0.gt_c2w if f0.gt_c2w is not None else np.eye(4),
                np.float32)
            state = init_state(cfg, n, pose0, self.device)
        mesh = self.mesh
        if mesh is not None:
            state = place_state(state, mesh, mode=self.mode)
            buckets = None
        if checkpoint_every and not checkpoint_path:
            raise ValueError("checkpoint_every needs a checkpoint_path")
        fps_cap = cfg.engine.fps_cap
        n_bucket, t_bucket = buckets or self._pick_buckets(state.gmap.n)
        chunk = cfg.engine.frames_per_dispatch
        live_view = viewer is not None or net_gui is not None
        if mesh is not None:
            # every rank gathers the map for a viewer that any rank has
            flag = torch.tensor([int(live_view)], device=self.device)
            live_view = bool(mesh.all_reduce(flag, op="max"))
        if live_view or fps_cap:
            chunk = 1  # live modes need per-frame results
        viewer_kf_total = -1
        t0 = time.perf_counter()
        i = state.frame_idx
        while i < n:
            if checkpoint_every and i > 0 and i % checkpoint_every < chunk:
                # periodic autosave (a device -> host copy of the whole
                # state; imported here so that a test can patch it)
                from ..io.checkpoint import save_fused_state
                whole = self._whole(state)
                if self._writes():
                    save_fused_state(whole, checkpoint_path, self.draws,
                                     (n_bucket, t_bucket))
            if i % self.BUCKET_SYNC < chunk and i > 0:
                n_bucket, t_bucket = self._pick_buckets(state.gmap.n)
            if chunk > 1 and i + chunk <= n:
                frs = [self._frame(j) for j in range(i, i + chunk)]
                state = self.fused.step_chunk(
                    state, torch.stack([d for d, _ in frs]),
                    torch.stack([r for _, r in frs]),
                    [j == n - 1 for j in range(i, i + chunk)],
                    n_bucket, t_bucket)
                i += chunk
                continue
            fr = dataset[i]
            depth, rgb = self._on_device(fr)
            state = self.fused.step(state, depth, rgb, i == n - 1, n_bucket,
                                    t_bucket)
            gmap = self._whole_map(state.gmap) if live_view else state.gmap
            if net_gui is not None:
                # serve a pending SIBR remote-viewer request against the
                # current map (reference run_viewer, mp_Mapper.py:272-294)
                from ..viz.network_gui import make_map_render_fn
                net_gui.poll(make_map_render_fn(
                    map_params(gmap), gmap.live, cfg.map.sh_degree,
                    cfg.render.bg_color))
            if viewer is not None:
                # the pose of frame i (a device sync: viewer mode trades
                # FPS for live output, like the reference's streaming)
                pose_i = state.poses[i]
                viewer.log_frame(i, pose_i.cpu().numpy(), fr.rgb, fr.depth)
                if state.kf_total != viewer_kf_total:
                    # a keyframe: the trackable map points
                    # (mp_Tracker.py:186-189) and the mapper's render of
                    # this view (mp_Mapper.py:250-257)
                    viewer_kf_total = state.kf_total
                    tg = state.target
                    viewer.log_points(i, tg.points.T[tg.valid].cpu().numpy())
                    img, _ = self.fused.render_eval(
                        map_params(gmap), gmap.live, invert_se3(pose_i), rgb,
                        depth)
                    viewer.log_render(i, img.cpu().numpy())
            if fps_cap:
                # throttle to fps_cap on average (mp_Tracker.py:323-324)
                target = t0 + (i + 1) / fps_cap
                now = time.perf_counter()
                if now < target:
                    time.sleep(target - now)
            if progress and i % 50 == 0:
                print(f"frame {i}/{n}")
            i += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        fps = n / (time.perf_counter() - t0)

        self.state = state
        self._finalize(cfg.engine.mapping_iters_final, n_bucket)
        state = self.state

        poses = state.poses.cpu().numpy().astype(np.float64)
        gt = dataset.gt_poses
        ate = None
        if gt.ndim == 3:  # every frame carries a ground-truth pose
            ate = ate_rmse(gt, poses)
        else:
            gt = None

        psnr_mean = None
        per_frame = None
        if eval_render:
            gmap = self._whole_map(state.gmap)
            params = map_params(gmap)
            vals = []
            for i in range(0, n, eval_stride):
                depth, rgb = self._frame(i)
                w2c = invert_se3(torch.as_tensor(poses[i], dtype=torch.float32,
                                                 device=self.device))
                _, p = self.fused.render_eval(params, gmap.live, w2c, rgb,
                                              depth)
                vals.append(float(p))
            per_frame = np.asarray(vals)
            psnr_mean = float(per_frame.mean())

        num_gaussians = (state.gmap.num_live if mesh is None
                         else num_live(state.gmap, mesh, self.mode))
        return SLAMResult(
            poses=poses, gt_poses=gt, ate_rmse=ate, fps=fps,
            num_gaussians=num_gaussians, psnr=psnr_mean,
            per_frame_psnr=per_frame, kf_total=state.kf_total,
            kf_stored=state.kf_count,
            vis_cap_dropped=int(state.stat_vis_dropped),
            tile_cap_dropped=int(state.stat_pair_dropped))

    # -------------------------------------------------------------- extras
    def evaluate(self, eval_stride: int = 1, poses=None, dump_dir=None):
        """Full-sequence PSNR/SSIM/LPIPS at the final map and poses
        (reference calc_2d_metric, mp_Mapper.py:335-420); LPIPS where
        weights are available (eval/lpips.py)."""
        from ..eval.image_metrics import evaluate_sequence

        assert self.state is not None, "run() first"
        state = self.state
        gmap = self._whole_map(state.gmap)
        params = map_params(gmap)
        if poses is None:
            poses = state.poses.cpu().numpy().astype(np.float64)

        def render_frame(i):
            depth, rgb = self._frame(i)
            w2c = invert_se3(torch.tensor(poses[i], dtype=torch.float32,
                                          device=self.device))
            img, _ = self.fused.render_eval(params, gmap.live, w2c, rgb,
                                            depth)
            return img

        return evaluate_sequence(render_frame, self.dataset,
                                 len(self.dataset), stride=eval_stride,
                                 depth_scale=self.cfg.intr.depth_scale,
                                 dump_dir=dump_dir if self._writes() else None)

    def save_ply(self, path: str) -> int:
        """Export the live map in the 3DGS-ecosystem PLY layout
        (gaussian_model.py:619-636); returns the rows written."""
        from ..io.ply import save_ply as _save

        assert self.state is not None, "run() first"
        m = self._whole_map(self.state.gmap)
        if not self._writes():
            return int(m.live.sum())
        return _save(path, m.xyz, m.f_dc, m.f_rest, m.opacity_logit,
                     m.log_scaling, m.rotation, mask=m.live)

    def save_checkpoint(self, path: str) -> None:
        """Write the full fused SLAMState and the draw source's position
        as a resumable npz."""
        from ..io.checkpoint import save_fused_state

        assert self.state is not None, "run() first"
        whole = self._whole(self.state)
        if self._writes():
            save_fused_state(whole, path, self.draws)

    def load_checkpoint(self, path: str) -> None:
        """Read a fused SLAMState (either package's npz) onto the engine's
        device; the draws continue from its position where it holds one."""
        from ..io.checkpoint import load_fused_state

        state = load_fused_state(path, self.device, self.draws)
        if self.mesh is not None:
            state = place_state(state, self.mesh, mode=self.mode)
        self.state = state
