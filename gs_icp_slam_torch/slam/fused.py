"""The mapping step's building blocks (counterpart of the part of
gs_icp_slam_tpu/slam/fused.py that both engines share:
`MappingPrimitives` and `make_mapping_primitives`).

One opt step renders a stored keyframe, takes the masked L1 + SSIM + depth
loss, backpropagates through the compositor (kernel K1-bwd) and the
projection, and applies masked per-group Adam.  Ported for
training_stage 0 without a device mesh; the fused per-frame step, its
engine, training stages 1/2 and the multi-device `opt_step_batched`
arrive with the fused-engine slice.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import torch

from .. import resolve_device
from ..config import SLAMConfig
from ..models import adam_step, map_lr_tree
from ..ops.rasterize import rasterize_tiled, tile_capacity
from ..utils.losses import mapping_loss


class MappingPrimitives(NamedTuple):
    raster: Callable     # partial of rasterize_tiled at the cfg geometry
    opt_loss: Callable   # (params, live, w2c, rgb_u8, depth_raw)
                         #   -> (loss, stats)
    opt_step: Callable   # (params, adam, live, w2c, rgb_u8, depth_raw)
                         #   -> (params, adam, loss, stats)
    sh_concat: Callable  # params -> (C, (sh+1)^2, 3) SH coefficients


def make_mapping_primitives(cfg: SLAMConfig,
                            device="cuda") -> MappingPrimitives:
    """Build the single-keyframe mapping step for a config (training
    stage 0; other stages raise NotImplementedError) on one device."""
    if cfg.opt.training_stage != 0:
        raise NotImplementedError(
            "training_stage > 0 arrives with the fused-engine slice")
    intr, rc = cfg.intr, cfg.render
    lrs = map_lr_tree(cfg.opt)
    bg = torch.tensor(rc.bg_color, dtype=torch.float32,
                      device=resolve_device(device))
    fx, fy = intr.fx, intr.fy
    rcx, rcy = (intr.width - 1) / 2.0, (intr.height - 1) / 2.0
    raster = partial(
        rasterize_tiled, sh_degree=cfg.map.sh_degree, width=intr.width,
        height=intr.height, tile=rc.tile_size,
        visible_cap=rc.visible_capacity, tile_span=rc.tile_span,
        tile_cap=tile_capacity(intr.width, intr.height, rc.tile_size,
                               rc.tile_span, rc.visible_capacity,
                               rc.max_per_tile))

    def sh_concat(params):
        return torch.cat([params["f_dc"][:, None, :], params["f_rest"]], 1)

    def opt_loss(params, live, w2c, rgb_u8, depth_raw):
        # rgb_u8 is channel-first (3, H, W) uint8
        gt_img = rgb_u8.to(torch.float32) / 255.0
        gt_depth = depth_raw / intr.depth_scale
        out = raster(params["xyz"], params["rotation"],
                     torch.exp(params["log_scaling"]),
                     torch.sigmoid(params["opacity_logit"][:, 0]),
                     sh_concat(params), w2c, live, bg, fx, fy, rcx, rcy)
        loss, _ = mapping_loss(out.color, out.depth, gt_img, gt_depth,
                               lambda_dssim=cfg.opt.lambda_dssim,
                               depth_weight=cfg.opt.depth_loss_weight,
                               d_max=cfg.opt.depth_d_max)
        return loss, out.stats

    def opt_step(params, adam, live, w2c, rgb_u8, depth_raw):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss, stats = opt_loss(leaves, live, w2c, rgb_u8, depth_raw)
        got = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
        grads = {k: torch.zeros_like(p) if d is None else d
                 for (k, p), d in zip(params.items(), got)}
        params, adam = adam_step(params, grads, adam, lrs, live,
                                 b1=cfg.opt.adam_b1, b2=cfg.opt.adam_b2,
                                 eps=cfg.opt.adam_eps)
        return params, adam, loss.detach(), stats

    return MappingPrimitives(raster=raster, opt_loss=opt_loss,
                             opt_step=opt_step, sh_concat=sh_concat)
