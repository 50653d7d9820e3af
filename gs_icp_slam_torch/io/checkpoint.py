"""Mid-run checkpoint / resume of the full SLAM state (counterpart of
gs_icp_slam_tpu/io/checkpoint.py, with its npz key layout).

One flat npz holds:

  map parameters + live/trackable masks + slot count
  Adam moments + step
  pose history
  keyframe store (poses + RGB-D) + counters

`save_fused_state` / `load_fused_state` write and read the fused engine's
SLAMState under JAX's keys (`gmap.*`, `adam.m.*`, `adam.v.*`, `adam.step`,
`target.*`, `s.*`), with JAX's dtypes: the port's host-int counters are
written as 0-d int32 arrays and read back as ints, the cap-drop statistics
as int32 and read back as int64 tensors.  A field missing from a file gets
the zero default of the JAX loader, so a JAX checkpoint loads here.

The JAX state carries its PRNG key (`s.rng`); the port's draws belong to
the engine (slam/fused.py), so a port checkpoint holds the draw source's
position under keys of its own (`draws.*`: a TorchDraws generator state as
uint8, a RecordedDraws count and the position of the source it continues
from) and writes no `s.rng`.  JAX's loader requires `s.rng`, so it cannot
read a port checkpoint; the port reads JAX's, and keeps the engine's draw
source where the file holds no position.

`save_checkpoint(engine, path)` / `load_checkpoint(engine, path)` operate
on a staged SLAMEngine in place, with JAX's keys, the keyframe-choice
generator's PCG64 state included (as (hi, lo) uint64 pairs), so a run can
resume exactly where it stopped.

The engine's autosave also records the capacity buckets it is running
with (`engine.n_bucket`, `engine.t_bucket`, -1 for none), and a resume
takes them: the uninterrupted run keeps the buckets it picked up to
BUCKET_SYNC - 1 frames before the save, and a bucket that a cap then
binds on (the visible cap, the tile lists, the tracking target's slice)
changes the results.  A file without them (JAX's) re-picks the buckets
from the map's size, as the JAX engine does.

The G-ICP target's K2 order (`nn_order`, which JAX's target lacks) is not
written: the loaders rebuild it from the target's points, as every target
is built (ops/gicp.py spatial_order).
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import (adam_from_numpy, map_from_numpy, state_from_numpy,
                       target_from_numpy)
from ..models import GaussianMap
from ..ops.gicp import GICPTarget, spatial_order

# the GICPTarget fields JAX's target has
_TARGET_FIELDS = ("points", "cov6", "valid", "nn_bias")
# SLAMState fields stored as 0-d int32 arrays, as in the JAX state
_INT32_FIELDS = ("frame_idx", "kf_count", "kf_total", "new_kf",
                 "from_last_kf", "train_iter", "stat_vis_dropped",
                 "stat_pair_dropped")
_ARRAY_FIELDS = ("poses", "kf_w2c", "kf_rgb", "kf_depth")


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _map_arrays(m: GaussianMap, prefix: str) -> dict:
    return {f"{prefix}.{f}": (np.asarray(m.n, np.int32) if f == "n"
                              else _host(getattr(m, f)))
            for f in GaussianMap._fields}


def _adam_arrays(a) -> dict:
    arrays = {f"adam.m.{k}": _host(v) for k, v in a.m.items()}
    arrays.update({f"adam.v.{k}": _host(v) for k, v in a.v.items()})
    arrays["adam.step"] = np.asarray(a.step, np.int32)
    return arrays


def _adam_numpy(z) -> dict:
    keys = [k[len("adam.m."):] for k in z.files if k.startswith("adam.m.")]
    return {"m": {k: z[f"adam.m.{k}"] for k in keys},
            "v": {k: z[f"adam.v.{k}"] for k in keys}, "step": z["adam.step"]}


def _with_order(t: GICPTarget) -> GICPTarget:
    return t._replace(nn_order=spatial_order(t.points, t.valid))


def _position_arrays(pos, prefix: str = "draws") -> dict:
    """A draw source's position as arrays: a generator state (uint8
    tensor), or a RecordedDraws (count, position of its continuation)."""
    if torch.is_tensor(pos):
        return {f"{prefix}.state": pos.numpy()}
    used, then = pos
    out = {f"{prefix}.used": np.asarray(used, np.int64)}
    if then is not None:
        out.update(_position_arrays(then, prefix + ".then"))
    return out


def _position_from(z, prefix: str = "draws"):
    """The position `_position_arrays` wrote, or None."""
    if f"{prefix}.state" in z.files:
        return torch.from_numpy(z[f"{prefix}.state"].copy())
    if f"{prefix}.used" in z.files:
        return (int(z[f"{prefix}.used"]), _position_from(z, prefix + ".then"))
    return None


def save_fused_state(state, path: str, draws=None, buckets=None) -> None:
    """Write a FusedEngine SLAMState as npz under JAX's keys; with `draws`,
    also the draw source's position (`draws.position()`), and with
    `buckets`, the engine's (n_bucket, t_bucket)."""
    arrays = _map_arrays(state.gmap, "gmap")
    arrays.update(_adam_arrays(state.adam))
    for f in _TARGET_FIELDS:
        arrays[f"target.{f}"] = _host(getattr(state.target, f))
    for f in _ARRAY_FIELDS:
        arrays[f"s.{f}"] = _host(getattr(state, f))
    for f in _INT32_FIELDS:
        arrays[f"s.{f}"] = np.asarray(int(getattr(state, f)), np.int32)
    arrays["s.last_ratio"] = np.asarray(float(state.last_ratio), np.float32)
    if draws is not None:
        arrays.update(_position_arrays(draws.position()))
    if buckets is not None:
        for name, b in zip(("n_bucket", "t_bucket"), buckets):
            arrays[f"engine.{name}"] = np.asarray(-1 if b is None else b,
                                                  np.int64)
    np.savez_compressed(path, **arrays)


def load_fused_state(path: str, device="cuda", draws=None):
    """Read a fused SLAMState (written by either package) onto `device`.
    With `draws`, restore its position from the file where it holds one
    (a port checkpoint); a JAX checkpoint holds none and leaves `draws`
    as it is."""
    with np.load(path, allow_pickle=False) as z:
        rest = {}
        for f in _ARRAY_FIELDS + _INT32_FIELDS + ("last_ratio",):
            key = f"s.{f}"
            # field added after the checkpoint was written: zero default
            rest[f] = z[key] if key in z.files else np.int32(0)
        state = state_from_numpy(dict(
            gmap={f: z[f"gmap.{f}"] for f in GaussianMap._fields},
            adam=_adam_numpy(z),
            target={f: z[f"target.{f}"] for f in _TARGET_FIELDS}, **rest),
            device=device)
        pos = _position_from(z)
    state.target = _with_order(state.target)
    if draws is not None and pos is not None:
        draws.restore(pos)
    return state


def saved_buckets(path: str):
    """The (n_bucket, t_bucket) an autosave recorded (None for full
    capacity), or None where the file has none."""
    with np.load(path, allow_pickle=False) as z:
        if "engine.n_bucket" not in z.files:
            return None
        return tuple(None if int(z[f"engine.{k}"]) < 0
                     else int(z[f"engine.{k}"])
                     for k in ("n_bucket", "t_bucket"))


def save_checkpoint(engine, path: str) -> None:
    """Write a staged SLAMEngine's state (JAX's keys)."""
    arrays = _map_arrays(engine.gmap, "map")
    arrays.update(_adam_arrays(engine.adam))
    arrays["poses"] = (np.stack(engine.poses) if engine.poses
                       else np.zeros((0, 4, 4)))
    arrays["kf.w2c"] = engine.kf_w2c[:engine.kf_count]
    arrays["kf.rgb"] = engine.kf_rgb[:engine.kf_count]
    arrays["kf.depth"] = engine.kf_depth[:engine.kf_count]
    arrays["kf.new"] = np.asarray(engine.new_keyframes, np.int64)
    arrays["counters"] = np.asarray(
        [engine.kf_count, engine.from_last_kf, engine.train_iter], np.int64)
    if engine.target is not None:
        for f in _TARGET_FIELDS:
            arrays[f"target.{f}"] = _host(getattr(engine.target, f))
    # keyframe-choice RNG state, so resumed mapping iterations replay
    # exactly; PCG64 state/inc are 128-bit -> stored as (hi, lo) uint64
    st = engine.rng.bit_generator.state

    def split128(x):
        return np.asarray([x >> 64, x & ((1 << 64) - 1)], np.uint64)

    arrays["rng.state"] = split128(st["state"]["state"])
    arrays["rng.inc"] = split128(st["state"]["inc"])
    np.savez_compressed(path, **arrays)


def load_checkpoint(engine, path: str) -> None:
    """Restore a staged SLAMEngine in place from `save_checkpoint`'s file
    (or the JAX package's)."""
    dev = engine.device
    with np.load(path, allow_pickle=False) as z:
        engine.gmap = map_from_numpy({f: z[f"map.{f}"]
                                      for f in GaussianMap._fields}, dev)
        engine.adam = adam_from_numpy(_adam_numpy(z), dev)
        engine.poses = [p for p in z["poses"]]
        kf_count, from_last, train_iter = z["counters"].tolist()
        engine.kf_count = int(kf_count)
        engine.from_last_kf = int(from_last)
        engine.train_iter = int(train_iter)
        engine.kf_w2c[:engine.kf_count] = z["kf.w2c"]
        engine.kf_rgb[:engine.kf_count] = z["kf.rgb"]
        engine.kf_depth[:engine.kf_count] = z["kf.depth"]
        engine.new_keyframes = z["kf.new"].tolist()
        if "target.points" in z.files:
            engine.target = _with_order(target_from_numpy(
                {f: z[f"target.{f}"] for f in _TARGET_FIELDS}, dev))
        if "rng.state" in z.files:
            def join128(a):
                return (int(a[0]) << 64) | int(a[1])

            st = engine.rng.bit_generator.state
            st["state"]["state"] = join128(z["rng.state"])
            st["state"]["inc"] = join128(z["rng.inc"])
            engine.rng.bit_generator.state = st
