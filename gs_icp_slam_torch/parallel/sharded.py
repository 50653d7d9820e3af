"""The layout of the fused SLAM state over a mesh of ranks (counterpart of
gs_icp_slam_tpu/parallel/sharded.py).

Two modes, as in the JAX package:
  dp    every rank holds the whole map; a mapping iteration renders one
        keyframe per rank and all-reduces the gradients (one array-sized
        collective per iteration);
  fsdp  each rank holds rows [r C/W, (r+1) C/W) of the map's parameters,
        Adam's moments and the per-slot masks (`trackable`, `live`); a
        mapping iteration all-gathers the parameter shards, renders the
        rank's keyframe, reduce-scatters the gradients and runs masked
        Adam on the shard.
Everything else (the G-ICP target, the keyframe store, the pose history,
the counters) is whole on every rank in both modes.  Every rank builds the
initial state identically, so placing it needs no broadcast.

The rest of the fused step on a sharded map: pruning is elementwise and
stays on the shard; an insert at slots [n, n+P) writes the part that falls
in the rank's rows (`add_gaussians_sharded`); the target export gathers the
ranks' candidate lists in rank order (`trackable_export_sharded`), which
is the global stable order.  `gather_map` / `gather_state` give the whole
map back (checkpoints, evaluation, the viewers), as JAX's device_get does.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models import AdamState, GaussianMap
from ..models.gaussian_map import _gicp_log_scales, trackable_mask
from ..utils.sh import rgb_to_sh

MAP_AXIS = "map"

_PARAM_FIELDS = ("xyz", "f_dc", "f_rest", "log_scaling", "rotation",
                 "opacity_logit")
# the map's per-slot fields split along capacity in fsdp
_SHARDED_MAP_FIELDS = _PARAM_FIELDS + ("trackable", "live")

# "auto" mode keeps the map whole on every rank (dp) until params + both
# Adam moments exceed this per-rank budget; beyond it the map is split
# along capacity (fsdp).  ~170 B a splat at sh_degree 0: the switch lies
# near 6M splats.
DP_MAX_BYTES = 1 << 30


def _map_bytes(capacity: int, sh_degree: int) -> int:
    coeffs = (sh_degree + 1) ** 2
    per = (3 + 3 + 3 * max(coeffs - 1, 0) + 3 + 4 + 1) * 4
    return capacity * per * 3  # params + Adam m + Adam v


def choose_mode(capacity: int, sh_degree: int = 0,
                requested: str = "auto") -> str:
    """Resolve cfg.engine.parallel_mode: 'dp' | 'fsdp'."""
    if requested in ("dp", "fsdp"):
        return requested
    return "dp" if _map_bytes(capacity, sh_degree) <= DP_MAX_BYTES \
        else "fsdp"


def state_shardings(mode: str = "fsdp") -> dict:
    """For each tensor field of a SLAMState, by its path ("gmap.xyz",
    "adam.m.xyz", "target.points", "kf_rgb", ...), MAP_AXIS where it is
    split along capacity (rows [r C/W, (r+1) C/W) on rank r) or None
    (whole on every rank)."""
    from ..ops.gicp import GICPTarget
    from ..slam.state import SLAMState

    split = MAP_AXIS if mode == "fsdp" else None
    layout = {f"gmap.{f}": (split if f in _SHARDED_MAP_FIELDS else None)
              for f in GaussianMap._fields}
    for part in ("m", "v"):
        layout.update({f"adam.{part}.{f}": split for f in _PARAM_FIELDS})
    layout["adam.step"] = None
    layout.update({f"target.{f}": None for f in GICPTarget._fields})
    layout.update({f.name: None for f in dataclasses.fields(SLAMState)
                   if f.name not in ("gmap", "adam", "target")})
    return layout


def shard_rows(mesh, capacity: int) -> tuple[int, int]:
    """The global slots [lo, hi) that rank mesh.rank holds of a map of
    `capacity` slots."""
    if capacity % mesh.size:
        raise ValueError(f"map capacity {capacity} not divisible by mesh "
                         f"size {mesh.size}")
    per = capacity // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def _rows(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return x[lo:hi].clone()  # the rank owns its rows, not a view


def adam_rows(a: AdamState, lo: int, hi: int) -> AdamState:
    """Rows [lo, hi) of Adam's moments (the step stays whole)."""
    return AdamState(m={k: _rows(v, lo, hi) for k, v in a.m.items()},
                     v={k: _rows(v, lo, hi) for k, v in a.v.items()},
                     step=a.step)


def place_state(state, mesh, mode: str = "fsdp"):
    """The rank-local state of a whole SLAMState that every rank built
    identically: in fsdp the rank's rows of the map and Adam's moments
    (state_shardings), in dp the state itself."""
    if mode == "dp":
        return state
    lo, hi = shard_rows(mesh, state.gmap.capacity)
    gmap = state.gmap._replace(**{f: _rows(getattr(state.gmap, f), lo, hi)
                                  for f in _SHARDED_MAP_FIELDS})
    return dataclasses.replace(state, gmap=gmap,
                               adam=adam_rows(state.adam, lo, hi))


def gather_map(m: GaussianMap, mesh, mode: str = "fsdp") -> GaussianMap:
    """The whole map on every rank (a collective: every rank calls it)."""
    if mode == "dp":
        return m
    return m._replace(**{f: mesh.all_gather(getattr(m, f))
                         for f in _SHARDED_MAP_FIELDS})


def gather_state(state, mesh, mode: str = "fsdp"):
    """The whole SLAMState on every rank (a collective)."""
    if mode == "dp":
        return state
    a = state.adam
    adam = AdamState(m={k: mesh.all_gather(v) for k, v in a.m.items()},
                     v={k: mesh.all_gather(v) for k, v in a.v.items()},
                     step=a.step)
    return dataclasses.replace(state, gmap=gather_map(state.gmap, mesh),
                               adam=adam)


def num_live(m: GaussianMap, mesh, mode: str = "fsdp") -> int:
    """The live splats of the whole map (a collective in fsdp)."""
    count = m.live.sum().reshape(1)
    if mode == "fsdp":
        mesh.all_reduce(count)
    return int(count)


def add_gaussians_sharded(m: GaussianMap, mesh, points, colors, quats,
                          scales, z_vals, trackable, valid,
                          init_opacity: float = 0.1) -> GaussianMap:
    """models.add_gaussians on a capacity shard: the valid rows go to the
    global slots [n, n + P) in order, as there, and this rank writes those
    that fall in its rows.  m.n is the global count."""
    per = m.capacity
    lo, hi = mesh.rank * per, (mesh.rank + 1) * per
    C = per * mesh.size
    sel = torch.nonzero(valid).squeeze(1)
    count = int(sel.shape[0])
    room = max(min(count, C - m.n), 0)
    a, b = max(m.n, lo), min(m.n + room, hi)
    if a < b:
        sel = sel[a - m.n:b - m.n]
        dst = slice(a - lo, b - lo)
        m.xyz[dst] = points[sel]
        m.f_dc[dst] = rgb_to_sh(colors[sel])
        m.log_scaling[dst] = _gicp_log_scales(scales[sel], z_vals[sel])
        m.rotation[dst] = quats[sel]
        m.opacity_logit[dst] = math.log(init_opacity / (1.0 - init_opacity))
        m.trackable[dst] = trackable[sel]
        m.live[dst] = True
        if m.f_rest.shape[1] > 0:
            m.f_rest[dst] = 0.0
    return m._replace(n=min(m.n + count, C))


def trackable_export_sharded(m: GaussianMap, mesh, opacity_th: float,
                             out_capacity: int):
    """models.trackable_export on a capacity shard, the same arrays on
    every rank.  Each rank orders its rows as the export does (its
    candidates first, then the rest, each in slot order) and keeps L =
    min(out_capacity, rows) of them; the ranks gather those lists and
    their candidate counts, and the candidates in rank order followed by
    the other rows in rank order, cut at out_capacity, are the global
    stable order's first out_capacity rows (a list cut at L rows is cut
    past that point)."""
    mask = trackable_mask(m, opacity_th)
    L = min(out_capacity, m.capacity)
    order = torch.argsort((~mask).to(torch.int8), stable=True)[:L]
    rows = torch.cat([m.xyz[order], m.rotation_normalized[order],
                      m.scaling[order]], dim=1)                   # (L, 10)
    counts = mesh.all_gather(mask.sum().reshape(1)).tolist()
    lists = mesh.all_gather(rows).reshape(mesh.size, L, 10)
    head = [lists[r, :c] for r, c in enumerate(counts)]
    tail = [lists[r, c:] for r, c in enumerate(counts)]
    rows = torch.cat(head + tail)[:out_capacity]
    valid = torch.arange(rows.shape[0], device=rows.device) < sum(counts)
    return rows[:, :3], rows[:, 3:7], rows[:, 7:10], valid
