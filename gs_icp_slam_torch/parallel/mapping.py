"""Multi-device map optimization on torch.distributed (counterpart of
gs_icp_slam_tpu/parallel/mapping.py): the mesh, the sharded map and the
keyframe-parallel mapping steps.

A `Mesh` is one axis of ranks over a process group: its size, this
process's rank, the group, the device the rank computes on and the
group's backend.  Its collectives (all_reduce, all_gather,
reduce_scatter) are the only ones the port calls, each on the tensor
where it lives, so that a caller can audit their bytes (`mesh.audit`, a
list of (op, elements, bytes) of each result) and time them
(`mesh.timings`, op -> [ms]: the host clock around a call on a synced
card, the ranks aligned by a barrier first).  Both are off (None) unless
a caller sets them.

`batched_opt_step` is the mapping iteration of both modes, where JAX
inserts the collectives from a shard_map:
  dp    each rank renders its keyframe on its whole map; the gradients
        go through ONE all-reduce (a flat buffer of exactly the parameter
        bytes), divided by W; the loss is all-reduced, the stats
        max-reduced; Adam runs on the whole map;
  fsdp  the parameter shards and `live` are all-gathered; each rank
        renders its keyframe; the gradients are reduce-scattered back to
        the shards (divided by W); masked Adam runs on the shard.
One iteration is W reference-mapper iterations at 1/W the weight each
(the mean loss over the batch).  `make_parallel_opt_step` is the
standalone fsdp step (JAX's make_parallel_opt_step: full caps, full
resolution).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from .. import resolve_device
from ..config import SLAMConfig
from ..models import AdamState, adam_step, map_lr_tree
from ..ops.rasterize import rasterize_tiled
from ..utils.losses import mapping_loss
from .sharded import _rows, adam_rows, shard_rows


@dataclass
class Mesh:
    size: int
    rank: int
    group: object              # the process group (None: the default one)
    device: torch.device
    backend: str
    audit: list | None = None     # (op, elements, bytes) of each result
    timings: dict | None = None   # op -> [ms] of each collective

    def _run(self, op: str, fn, result: torch.Tensor) -> torch.Tensor:
        timed = self.timings is not None and result.is_cuda
        if timed:
            # the ranks enter together, so that the time is the
            # collective's and not a wait for a slower rank
            torch.cuda.synchronize(result.device)
            dist.barrier(group=self.group)
            t0 = time.perf_counter()
        fn()
        if timed:
            torch.cuda.synchronize(result.device)
            self.timings.setdefault(op, []).append(
                (time.perf_counter() - t0) * 1e3)
        if self.audit is not None:
            self.audit.append((op, result.numel(),
                               result.numel() * result.element_size()))
        return result

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place over the ranks: "sum" or "max"."""
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        return self._run("all_reduce",
                         lambda: dist.all_reduce(x, rop, group=self.group), x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' x concatenated along dim 0, in rank order."""
        src = x.contiguous()
        raw = src.view(torch.uint8) if src.dtype == torch.bool else src
        out = torch.empty((self.size * raw.shape[0],) + tuple(raw.shape[1:]),
                          dtype=raw.dtype, device=raw.device)
        self._run("all_gather", lambda: dist.all_gather_into_tensor(
            out, raw, group=self.group), out)
        return out.view(torch.bool) if src.dtype == torch.bool else out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of x, rank r's 1/W of it along dim 0."""
        out = torch.empty((x.shape[0] // self.size,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        return self._run("reduce_scatter",
                         lambda: dist.reduce_scatter_tensor(
                             out, x.contiguous(), group=self.group), out)


def make_mesh(device="cuda", group=None) -> Mesh:
    """A 1-D mesh over a process group (the default one when `group` is
    None) that is already initialized (parallel.launch.init_distributed,
    or a group the caller made).  "cuda" without an index is the current
    CUDA device."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(gs_icp_slam_torch.parallel.init_distributed)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(size=dist.get_world_size(group), rank=dist.get_rank(group),
                group=group, device=dev, backend=str(dist.get_backend(group)))


def shard_map_state(mesh: Mesh, params: dict, adam: AdamState,
                    live: torch.Tensor):
    """The rank's rows of whole map parameters, Adam moments and live mask
    (Adam's step stays whole)."""
    lo, hi = shard_rows(mesh, live.shape[0])
    return ({k: _rows(v, lo, hi) for k, v in params.items()},
            adam_rows(adam, lo, hi), _rows(live, lo, hi))


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: dict) -> dict:
    out, at = {}, 0
    for k, t in like.items():
        out[k] = flat[at:at + t.numel()].reshape(t.shape)
        at += t.numel()
    return out


def gather_params(mesh: Mesh, params: dict, live: torch.Tensor):
    """The whole parameters and live mask from the ranks' shards: one
    gather of the shards' parameters as one flat buffer, one of live."""
    W = mesh.size
    whole = mesh.all_gather(_flat(params.values())).reshape(W, -1)
    out, at = {}, 0
    for k, p in params.items():
        n = p.numel()
        out[k] = whole[:, at:at + n].reshape((W * p.shape[0],)
                                             + tuple(p.shape[1:]))
        at += n
    return out, mesh.all_gather(live)


def batched_opt_step(mesh: Mesh, mode: str, opt_loss: Callable, lrs: dict,
                     opt_cfg) -> Callable:
    """The mapping iteration of a mode (module docstring):
    step(params, adam, live, w2c_b (W,4,4), rgb_b (W,3,H,W), depth_b
    (W,H,W)) -> (params, adam, loss, stats); rank r renders keyframe r
    of the batch.  params/adam/live are the whole map in dp and the
    rank's shard in fsdp."""
    W, r = mesh.size, mesh.rank

    def step(params, adam, live, w2c_b, rgb_b, depth_b):
        if mode == "fsdp":
            full, live_f = gather_params(mesh, params, live)
        else:
            full, live_f = params, live
        leaves = {k: p.detach().requires_grad_(True) for k, p in full.items()}
        loss, stats = opt_loss(leaves, live_f, w2c_b[r], rgb_b[r], depth_b[r])
        got = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(full.items(), got)}
        if mode == "fsdp":
            # rank q's rows of every parameter, contiguous: the layout
            # reduce_scatter hands out by rank
            buf = torch.cat([g.reshape(W, -1) for g in grads.values()], 1)
            grads = _unflat(mesh.reduce_scatter(buf.reshape(-1)) / W, params)
        else:
            grads = _unflat(mesh.all_reduce(_flat(grads.values())) / W,
                            params)
        loss = mesh.all_reduce(loss.detach().reshape(1).clone())[0] / W
        stats = mesh.all_reduce(stats.clone(), op="max")
        params, adam = adam_step(params, grads, adam, lrs, live,
                                 b1=opt_cfg.adam_b1, b2=opt_cfg.adam_b2,
                                 eps=opt_cfg.adam_eps)
        return params, adam, loss, stats

    return step


class ParallelMappingStep(NamedTuple):
    step: Callable  # (params, adam, live, w2c_b, rgb_b (B,3,H,W), depth_b)
                    #   -> (params, adam, loss); shards in, shards out
    mesh: Mesh
    batch: int      # keyframes consumed per call (= mesh size)


def make_parallel_opt_step(mesh: Mesh, cfg: SLAMConfig) -> ParallelMappingStep:
    """The standalone fsdp mapping step for a config: the map's shards
    (shard_map_state) in and out, one keyframe per rank, the mean loss
    over the batch, at the full visible cap and K = max_per_tile."""
    intr, rc = cfg.intr, cfg.render
    bg = torch.tensor(rc.bg_color, dtype=torch.float32, device=mesh.device)
    raster = partial(
        rasterize_tiled, sh_degree=cfg.map.sh_degree, width=intr.width,
        height=intr.height, tile=rc.tile_size,
        visible_cap=rc.visible_capacity, tile_span=rc.tile_span,
        tile_cap=rc.max_per_tile)
    rcx, rcy = (intr.width - 1) / 2.0, (intr.height - 1) / 2.0

    def render_loss(p, live, w2c, rgb_u8, depth_raw):
        # rgb_u8 is channel-first (3, H, W) uint8
        gt_img = rgb_u8.to(torch.float32) / 255.0
        gt_depth = depth_raw / intr.depth_scale
        sh = torch.cat([p["f_dc"][:, None, :], p["f_rest"]], 1)
        out = raster(p["xyz"], p["rotation"], torch.exp(p["log_scaling"]),
                     torch.sigmoid(p["opacity_logit"][:, 0]), sh, w2c, live,
                     bg, intr.fx, intr.fy, rcx, rcy)
        loss, _ = mapping_loss(out.color, out.depth, gt_img, gt_depth,
                               lambda_dssim=cfg.opt.lambda_dssim,
                               depth_weight=cfg.opt.depth_loss_weight,
                               d_max=cfg.opt.depth_d_max)
        return loss, out.stats

    batched = batched_opt_step(mesh, "fsdp", render_loss,
                               map_lr_tree(cfg.opt), cfg.opt)

    def step(params, adam, live, w2c_b, rgb_b, depth_b):
        params, adam, loss, _ = batched(params, adam, live, w2c_b, rgb_b,
                                        depth_b)
        return params, adam, loss

    return ParallelMappingStep(step=step, mesh=mesh, batch=mesh.size)
