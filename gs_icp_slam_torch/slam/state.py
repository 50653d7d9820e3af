"""The fused engine's SLAM state: everything the per-frame step touches
(counterpart of gs_icp_slam_tpu/slam/state.py).

Tensors live on one explicit device: the Gaussian map and its Adam
moments, the G-ICP target, the pose history and the keyframe store
(poses, channel-first uint8 RGB and raw depth).  The counters that steer
the step's control flow (frame index, keyframe counts, the pending new
keyframe, the training iteration) are host integers, as the map's `n` and
Adam's `step` already are, so deciding on them costs no device sync.  The
cap-drop statistics stay on the device (a running maximum, read once at
the end of a run).  The JAX state's PRNG key has no counterpart here: the
step takes its random draws from the draw source its engine passes in
(slam/fused.py), so a step on a `copy_state` copy moves the engine's draw
stream unless the caller restores its position.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import resolve_device
from ..models import AdamState, GaussianMap, adam_init, empty_map, map_params
from ..ops.gicp import GICPTarget, empty_target


@dataclass
class SLAMState:
    gmap: GaussianMap
    adam: AdamState
    target: GICPTarget           # fixed capacity (Tc)
    poses: torch.Tensor          # (F, 4, 4) float32 c2w history
    kf_w2c: torch.Tensor         # (Kc, 4, 4) float32
    kf_rgb: torch.Tensor         # (Kc, 3, H, W) uint8, channel-first
    kf_depth: torch.Tensor       # (Kc, H, W) float32 raw units
    frame_idx: int = 0           # frames processed so far
    kf_count: int = 0            # occupied keyframe slots
    kf_total: int = 0            # keyframes ever selected (> kf_count once
                                 # the reservoir store has evicted)
    new_kf: int = -1             # pending new keyframe slot or -1
    from_last_kf: int = 0
    train_iter: int = 0
    last_ratio: torch.Tensor | float = 1.0  # overlap ratio (diagnostics)
    stat_vis_dropped: torch.Tensor | None = None   # () int64 running max
    stat_pair_dropped: torch.Tensor | None = None  # () int64 running max


def init_state(cfg, num_frames: int, pose0: np.ndarray,
               device="cuda") -> SLAMState:
    """An empty state for a run of num_frames frames starting at pose0."""
    dev = resolve_device(device)
    intr = cfg.intr
    kc = cfg.engine.keyframe_capacity
    gmap = empty_map(cfg.map.capacity, cfg.map.sh_degree, dev)
    poses = torch.as_tensor(np.asarray(pose0, np.float32), device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return SLAMState(
        gmap=gmap,
        adam=adam_init(map_params(gmap)),
        target=empty_target(cfg.engine.target_capacity, dev),
        poses=poses[None].repeat(num_frames, 1, 1),
        kf_w2c=torch.zeros((kc, 4, 4), dtype=torch.float32, device=dev),
        kf_rgb=torch.zeros((kc, 3, intr.height, intr.width),
                           dtype=torch.uint8, device=dev),
        kf_depth=torch.zeros((kc, intr.height, intr.width),
                             dtype=torch.float32, device=dev),
        stat_vis_dropped=zero.clone(),
        stat_pair_dropped=zero.clone(),
    )


def copy_state(state: SLAMState) -> SLAMState:
    """A copy of the state that a step can run on without touching the
    original: every tensor cloned (the Gaussian map, Adam's moments, the
    target, the pose history and keyframe store, the statistics), the host
    counters copied.  bench.py's copy_state: its warm-ups and its fps_live
    run step copies.  The draw stream is the engine's, not the state's:
    save `engine.draws.position()` before stepping a copy and restore it
    afterwards (slam/fused.py)."""
    def clone(x):
        if torch.is_tensor(x):
            return x.clone()
        if isinstance(x, tuple):  # GaussianMap, AdamState, GICPTarget
            return type(x)(*(clone(v) for v in x))
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        return x

    return SLAMState(**{f.name: clone(getattr(state, f.name))
                        for f in fields(state)})
