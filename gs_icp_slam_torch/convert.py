"""Carry state across from the JAX package, given as numpy arrays.

The port never imports JAX: a caller turns the JAX objects into numpy
(`np.asarray` of each field, `dataclasses.asdict` of a config) and these
functions build the port's counterparts, so both packages can be fed the
same map, target, engine state and configuration.  Like every entry
point, the tensors land on the GPU unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .config import (EngineConfig, GICPConfig, KeyframeConfig, MapConfig,
                     OptConfig, RenderConfig, SLAMConfig)
from .models.gaussian_map import GaussianMap
from .models.optimizer import AdamState
from .ops.gicp import GICPTarget
from .utils.camera import Intrinsics


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype,
                           device=resolve_device(device))


def map_from_numpy(d: dict, device="cuda") -> GaussianMap:
    """GaussianMap from a dict of numpy arrays keyed by the field names
    (xyz, f_dc, f_rest, log_scaling, rotation, opacity_logit, trackable,
    live, n)."""
    f32 = torch.float32
    return GaussianMap(
        xyz=_t(d["xyz"], device, f32), f_dc=_t(d["f_dc"], device, f32),
        f_rest=_t(d["f_rest"], device, f32),
        log_scaling=_t(d["log_scaling"], device, f32),
        rotation=_t(d["rotation"], device, f32),
        opacity_logit=_t(d["opacity_logit"], device, f32),
        trackable=_t(d["trackable"], device, torch.bool),
        live=_t(d["live"], device, torch.bool), n=int(np.asarray(d["n"])))


def adam_from_numpy(d: dict, device="cuda") -> AdamState:
    """AdamState from {"m": {param: array}, "v": {param: array}, "step":
    int}, the JAX AdamState's moments and step as numpy."""
    f32 = torch.float32
    return AdamState(m={k: _t(a, device, f32) for k, a in d["m"].items()},
                     v={k: _t(a, device, f32) for k, a in d["v"].items()},
                     step=int(np.asarray(d["step"])))


def target_from_numpy(d: dict, device="cuda") -> GICPTarget:
    """GICPTarget from a dict of numpy arrays (points (3, T), cov6 (6, T),
    valid (T,), nn_bias (1, T))."""
    f32 = torch.float32
    return GICPTarget(points=_t(d["points"], device, f32),
                      cov6=_t(d["cov6"], device, f32),
                      valid=_t(d["valid"], device, torch.bool),
                      nn_bias=_t(d["nn_bias"], device, f32))


def config_from_dict(d: dict) -> SLAMConfig:
    """SLAMConfig from `dataclasses.asdict` of the JAX package's config."""
    return SLAMConfig(
        intr=Intrinsics(**d["intr"]), dataset_type=d["dataset_type"],
        downsample_rate=d["downsample_rate"], gicp=GICPConfig(**d["gicp"]),
        opt=OptConfig(**d["opt"]), map=MapConfig(**d["map"]),
        kf=KeyframeConfig(**d["kf"]), engine=EngineConfig(**d["engine"]),
        render=RenderConfig(**{**d["render"],
                               "bg_color": tuple(d["render"]["bg_color"])}))


def _fields(x) -> dict:
    return x if isinstance(x, dict) else x._asdict()


def state_from_numpy(s, device="cuda"):
    """The fused engine's SLAMState from the JAX package's SLAMState as
    numpy (`jax.device_get(state)`: a NamedTuple, or a dict keyed by its
    field names, with gmap, adam and target nested the same way).  The
    JAX state's PRNG key is not carried over: the port's step takes its
    draws from the draw source its engine is given."""
    from .slam.state import SLAMState

    d = _fields(s)
    adam = _fields(d["adam"])
    dev = resolve_device(device)
    i64 = torch.int64
    return SLAMState(
        gmap=map_from_numpy(_fields(d["gmap"]), dev),
        adam=adam_from_numpy({"m": dict(adam["m"]), "v": dict(adam["v"]),
                              "step": adam["step"]}, dev),
        target=target_from_numpy(_fields(d["target"]), dev),
        poses=_t(d["poses"], dev, torch.float32),
        kf_w2c=_t(d["kf_w2c"], dev, torch.float32),
        kf_rgb=_t(d["kf_rgb"], dev, torch.uint8),
        kf_depth=_t(d["kf_depth"], dev, torch.float32),
        frame_idx=int(np.asarray(d["frame_idx"])),
        kf_count=int(np.asarray(d["kf_count"])),
        kf_total=int(np.asarray(d["kf_total"])),
        new_kf=int(np.asarray(d["new_kf"])),
        from_last_kf=int(np.asarray(d["from_last_kf"])),
        train_iter=int(np.asarray(d["train_iter"])),
        last_ratio=float(np.asarray(d["last_ratio"])),
        stat_vis_dropped=_t(d["stat_vis_dropped"], dev, i64),
        stat_pair_dropped=_t(d["stat_pair_dropped"], dev, i64))
