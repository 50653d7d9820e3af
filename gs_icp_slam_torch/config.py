"""Configuration dataclasses (counterpart of gs_icp_slam_tpu/config.py).

Same classes, field names and defaults as the JAX package, so a config
converts field for field (`convert.config_from_dict`).  The comments there
carry the measurements behind each default; they are not repeated here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from .utils.camera import Intrinsics


@dataclass(frozen=True)
class GICPConfig:
    """G-ICP registration parameters (pygicp defaults + the reference CLI)."""

    max_correspondence_distance: float = 0.02
    knn_max_distance: float = 99999.0
    k_neighbors: int = 20
    max_iterations: int = 64
    transformation_epsilon: float = 5e-4
    rotation_epsilon: float = 2e-3
    plane_eps: float = 1e-3
    lm_init_lambda: float = 1e-9
    # "grid": k-NN inside an image-space window of the pixel-grid source
    # cloud; "exact": brute force over all pairs (kernel K3)
    source_knn: str = "grid"
    grid_knn_span: int = 0  # 0 = auto (ops.knn.resolve_grid_span)
    # "constant_position" | "constant_velocity" | "adaptive": the
    # Gauss-Newton seed (ops.gicp.gicp_align)
    motion_model: str = "adaptive"
    adaptive_trigger_deg: float = 2.0
    # Zhang-Kaess solution remapping threshold; 0 disables
    degeneracy_thresh: float = 3e-3


@dataclass(frozen=True)
class OptConfig:
    """3DGS optimizer hyperparameters (the mapping iterations')."""

    position_lr: float = 1.6e-6
    spatial_lr_scale: float = 2.5
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    lambda_dssim: float = 0.2
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-15
    depth_loss_weight: float = 0.1
    depth_d_max: float = 10.0
    training_stage: int = 0


@dataclass(frozen=True)
class MapConfig:
    """Gaussian map capacities and maintenance."""

    capacity: int = 1 << 19
    sh_degree: int = 0
    init_opacity: float = 0.1
    prune_interval: int = 200
    prune_min_opacity: float = 0.005
    prune_extent: float = 2.5
    trackable_opacity_th: float = 0.05
    densify_enabled: bool = False  # read by no engine, as in the reference
    densify_grad_threshold: float = 2e-4
    percent_dense: float = 0.01


@dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe selection thresholds (mp_Tracker.py:233-249)."""

    keyframe_th: float = 0.7
    keyframe_freq: int = 10
    overlapped_th: float = 5e-4
    overlapped_th2: float = 5e-5
    insert_dedup_sqd: float = 0.0


@dataclass(frozen=True)
class EngineConfig:
    """Pipeline knobs."""

    mapping_iters_per_frame: int = 3
    mapping_iters_final: int = 0
    fps_cap: Optional[float] = 30.0
    target_capacity: int = 1 << 18
    keyframe_capacity: int = 256
    frames_per_dispatch: int = 1
    parallel_mode: str = "auto"


@dataclass(frozen=True)
class RenderConfig:
    tile_size: int = 32
    # hard ceiling on the per-tile list capacity K (the engine sizes K from
    # the expected pairs per tile, ops.rasterize.tile_capacity)
    max_per_tile: int = 4096
    visible_capacity: int = 1 << 17
    tile_span: int = 2
    composite_chunk: int = 64
    znear: float = 0.2
    bg_color: tuple = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class SLAMConfig:
    intr: Intrinsics = field(default_factory=lambda: Intrinsics(640, 480, 525.0, 525.0, 319.5, 239.5))
    dataset_type: str = "replica"
    downsample_rate: int = 10
    gicp: GICPConfig = field(default_factory=GICPConfig)
    opt: OptConfig = field(default_factory=OptConfig)
    map: MapConfig = field(default_factory=MapConfig)
    kf: KeyframeConfig = field(default_factory=KeyframeConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    render: RenderConfig = field(default_factory=RenderConfig)

    def replace(self, **kw) -> "SLAMConfig":
        return dataclasses.replace(self, **kw)


def parse_caminfo(path: str) -> tuple[Intrinsics, str]:
    """Parse the reference caminfo.txt (line 3: W H fx fy cx cy depth_scale
    depth_trunc dataset_type; gs_icp_slam.py:52-62)."""
    with open(path) as f:
        lines = f.readlines()
    parts = lines[2].split()
    intr = Intrinsics(
        width=int(parts[0]), height=int(parts[1]),
        fx=float(parts[2]), fy=float(parts[3]),
        cx=float(parts[4]), cy=float(parts[5]),
        depth_scale=float(parts[6]), depth_trunc=float(parts[7]),
    )
    return intr, parts[8]


def replica_config(intr: Optional[Intrinsics] = None) -> SLAMConfig:
    """Replica tuning from replica.sh:135-142."""
    intr = intr or Intrinsics(1200, 680, 600.0, 600.0, 599.5, 339.5,
                              depth_scale=6553.5, depth_trunc=12.0)
    return SLAMConfig(
        intr=intr,
        dataset_type="replica",
        downsample_rate=10,
        gicp=GICPConfig(max_correspondence_distance=0.02),
        kf=KeyframeConfig(keyframe_th=0.7, overlapped_th=5e-4, overlapped_th2=5e-5),
        map=MapConfig(trackable_opacity_th=0.05, prune_extent=2.5),
    )


def synthetic_config(intr: Intrinsics, downsample_rate: int = 5,
                     capacity: int = 1 << 16,
                     target_capacity: int = 1 << 14,
                     visible_capacity: int = 1 << 14) -> SLAMConfig:
    """Small-scene tuning for the procedural synthetic sequence; the overlap
    thresholds are squared distances scaled to its point spacing."""
    return SLAMConfig(
        intr=intr,
        dataset_type="synthetic",
        downsample_rate=downsample_rate,
        gicp=GICPConfig(max_correspondence_distance=0.1),
        kf=KeyframeConfig(keyframe_th=0.7, overlapped_th=8e-3,
                          overlapped_th2=8e-4),
        map=MapConfig(capacity=capacity, trackable_opacity_th=0.05,
                      prune_extent=2.5),
        engine=EngineConfig(target_capacity=target_capacity),
        render=RenderConfig(visible_capacity=visible_capacity),
    )


def tum_config(intr: Optional[Intrinsics] = None) -> SLAMConfig:
    """TUM tuning from tum.sh:135-142 (pass the sequence's intrinsics)."""
    intr = intr or Intrinsics(640, 480, 517.3, 516.5, 318.6, 255.3,
                              depth_scale=5000.0, depth_trunc=6.0)
    return SLAMConfig(
        intr=intr,
        dataset_type="tum",
        downsample_rate=5,
        gicp=GICPConfig(max_correspondence_distance=0.03),
        kf=KeyframeConfig(keyframe_th=0.81, overlapped_th=1e-3, overlapped_th2=1e-3),
        map=MapConfig(trackable_opacity_th=0.09, prune_extent=10.0),
    )
