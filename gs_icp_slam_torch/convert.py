"""Carry state across from the JAX package, given as numpy arrays.

The port never imports JAX: a caller turns the JAX objects into numpy
(`np.asarray` of each field, `dataclasses.asdict` of a config) and these
functions build the port's counterparts, so both packages can be fed the
same map, target and configuration.  Like every entry point, the tensors
land on the GPU unless the caller asks for the CPU.
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
