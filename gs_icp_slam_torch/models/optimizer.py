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


def bias_corrections(t: int, b1: float, b2: float) -> tuple[float, float]:
    """Adam's float32 bias corrections 1 - b1^t and 1 - b2^t, computed as
    the JAX step computes them, on the host."""
    one, t32 = np.float32(1.0), np.float32(t)
    return (float(one - np.float32(b1) ** t32),
            float(one - np.float32(b2) ** t32))


def inv_bias_corrections(t: int, b1: float, b2: float) -> tuple[float, float]:
    """The float32 reciprocals of bias_corrections(t): on the card,
    division by a host scalar is a multiply by its float32 reciprocal, so
    multiplying by these gives adam_step's bits."""
    one = np.float32(1.0)
    return tuple(float(one / np.float32(bc))
                 for bc in bias_corrections(t, b1, b2))


def adam_step(params: dict, grads: dict, state: AdamState, lrs: dict,
              update_mask: torch.Tensor, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-15, inv_bc=None):
    """One Adam step over every parameter, masked by the per-slot
    update_mask (C,) bool.  Returns (new params, new AdamState).

    The bias corrections reach the update as host scalars, not uploaded
    tensors.  `inv_bc`: in their place, their reciprocals
    (inv_bias_corrections) as two 0-d float32 tensors on the device, which
    a captured CUDA graph reads at each replay (slam/fused.py OptGraph)."""
    t = state.step + 1
    bc1, bc2 = bias_corrections(t, b1, b2)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g, m, v = grads[k], state.m[k], state.v[k]
        mask = update_mask.reshape((-1,) + (1,) * (p.dim() - 1))
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * (g * g)
        if inv_bc is None:
            m_hat, v_hat = m_new / bc1, v_new / bc2
        else:
            m_hat, v_hat = m_new * inv_bc[0], v_new * inv_bc[1]
        step = lrs[k] * m_hat / (torch.sqrt(v_hat) + eps)
        new_p[k] = torch.where(mask, p - step, p)
        new_m[k] = torch.where(mask, m_new, m)
        new_v[k] = torch.where(mask, v_new, v)
    return new_p, AdamState(m=new_m, v=new_v, step=t)
