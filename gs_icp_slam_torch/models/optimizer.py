"""Masked per-group Adam over the map parameters (counterpart of
gs_icp_slam_tpu/models/optimizer.py).

The reference's one torch.optim.Adam with six parameter groups
(scene/gaussian_model.py:222-236) is kept as explicit state: first and
second moments per parameter and one global step.  `torch.optim.Adam` has
no per-slot mask; here masked slots (dead or unallocated) keep their
parameters AND moments, as if they were not in the optimizer at all.  The
update is out of place, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AdamState(NamedTuple):
    m: dict   # first moments, same keys as the params
    v: dict   # second moments
    step: int


def adam_init(params: dict) -> AdamState:
    return AdamState(m={k: torch.zeros_like(p) for k, p in params.items()},
                     v={k: torch.zeros_like(p) for k, p in params.items()},
                     step=0)


def map_lr_tree(opt_cfg) -> dict:
    """Learning rate per map parameter (gaussian_model.py:222-231): xyz
    position_lr * spatial_lr_scale, f_rest feature_lr / 20; constant (the
    reference's schedule never engages, mp_Mapper.py:135)."""
    return dict(
        xyz=opt_cfg.position_lr * opt_cfg.spatial_lr_scale,
        f_dc=opt_cfg.feature_lr,
        f_rest=opt_cfg.feature_lr / 20.0,
        opacity_logit=opt_cfg.opacity_lr,
        log_scaling=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
    )


def adam_step(params: dict, grads: dict, state: AdamState, lrs: dict,
              update_mask: torch.Tensor, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-15):
    """One Adam step over every parameter, masked by the per-slot
    update_mask (C,) bool.  Returns (new params, new AdamState)."""
    t = state.step + 1
    # float32 bias corrections, computed as the JAX step computes them,
    # on the host: they reach the update as scalars, not uploaded tensors
    # (on the card, division by a host scalar is a multiply by its
    # reciprocal, within an ulp of the division)
    one, t32 = np.float32(1.0), np.float32(t)
    bc1 = float(one - np.float32(b1) ** t32)
    bc2 = float(one - np.float32(b2) ** t32)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g, m, v = grads[k], state.m[k], state.v[k]
        mask = update_mask.reshape((-1,) + (1,) * (p.dim() - 1))
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * (g * g)
        step = lrs[k] * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        new_p[k] = torch.where(mask, p - step, p)
        new_m[k] = torch.where(mask, m_new, m)
        new_v[k] = torch.where(mask, v_new, v)
    return new_p, AdamState(m=new_m, v=new_v, step=t)
