"""Op timing and the roofline model (counterpart of
gs_icp_slam_tpu/utils/profiling.py).

  * slope_time: the device time of one op, from CUDA events around R
    launches.  (JAX's version runs the op R times inside one jit, salted
    against CSE, and differences against one run, to cancel a remote TPU's
    dispatch cost; a local card needs neither.)
  * the roofline: FLOP/byte counts for the frame's dominant stages against
    the card's peak compute and memory rate give the least time the stage
    could take and the share of it a measured time reaches.  The H100's
    peaks here are the ones chip_smoke.py bounds every kernel with.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def leaf_sum(x) -> torch.Tensor:
    """Scalar float32 sum over every tensor in a nest of dicts, lists and
    tuples (forces every leaf to be computed); other leaves count 0."""
    if torch.is_tensor(x):
        x = x.to(torch.int32) if x.dtype == torch.bool else x
        return x.sum().to(torch.float32)
    tot = torch.zeros((), dtype=torch.float32)
    if isinstance(x, (dict, list, tuple)):
        for leaf in (x.values() if isinstance(x, dict) else x):
            tot = tot + leaf_sum(leaf)  # a 0-d CPU sum adds to any device
    return tot


def slope_time(fn, R: int = 8, reps: int = 3, warmup: int = 2) -> float:
    """ms per call of fn() on the card: the best of `reps` runs of R
    launches between two CUDA events, over R."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(R):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / R)
    return best


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_f32: float   # FLOP/s
    peak_flops_bf16: float
    hbm_gbps: float         # bytes/s / 1e9


# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit: 67 TFLOP/s
# in float32 outside the tensor cores, 989 in bf16, HBM3 at 3.35 TB/s
CHIPS = {
    "h100": ChipSpec("NVIDIA H100 SXM", 67e12, 989e12, 3350.0),
    "cpu": ChipSpec("host CPU (nominal)", 1e12, 2e12, 100.0),
}


def detect_chip() -> ChipSpec:
    """The peaks of the current CUDA device under its own name
    (torch.cuda.get_device_name), or the nominal CPU without a card.
    Raises for a card whose peaks the table lacks."""
    if not torch.cuda.is_available():
        return CHIPS["cpu"]
    name = torch.cuda.get_device_name()
    if "H100" not in name:
        raise ValueError(f"no peak rates known for {name!r}")
    spec = CHIPS["h100"]
    return ChipSpec(name, spec.peak_flops_f32, spec.peak_flops_bf16,
                    spec.hbm_gbps)


@dataclass(frozen=True)
class StageModel:
    name: str
    flops: float   # useful FLOPs per invocation
    bytes: float   # unavoidable device-memory traffic per invocation

    def attainable_ms(self, chip: ChipSpec, dtype: str = "f32") -> float:
        peak = (chip.peak_flops_bf16 if dtype == "bf16"
                else chip.peak_flops_f32)
        t_compute = self.flops / peak
        t_memory = self.bytes / (chip.hbm_gbps * 1e9)
        return max(t_compute, t_memory) * 1e3

    def utilization(self, measured_ms: float, chip: ChipSpec,
                    dtype: str = "f32") -> float:
        att = self.attainable_ms(chip, dtype)
        return att / measured_ms if measured_ms > 0 else 0.0


def raster_forward_model(n_cap: int, v_cap: int, tiles: int, tile_px: int,
                         tile_cap: int, pairs_real: int,
                         occupancy: int) -> StageModel:
    """FLOP/byte model of the tiled rasterizer forward at a given load:
    projection (~150 FLOPs a splat) and compositing (~40 a (pair, pixel)
    over the REAL occupancy); the sorts count as bytes (~log2(n)^2/2
    bitonic passes over the keys)."""
    P = tile_px * tile_px
    flops = 150.0 * n_cap + 40.0 * occupancy * P

    def sort_passes(n):
        return max(n.bit_length(), 1) ** 2 / 2

    bytes_ = (
        4.0 * 16 * n_cap * 2                    # attr write + read
        + 8.0 * n_cap * sort_passes(n_cap)      # depth sort (2-op)
        + 4.0 * 9 * v_cap * sort_passes(9 * v_cap)  # pair sort (1-op)
        + 4.0 * 16 * tiles * tile_cap * 2       # tile attr gather out+in
        + 4.0 * 8 * tiles * P                   # composite output
    )
    return StageModel("raster_fwd", flops, bytes_)


def gicp_iteration_model(n_source: int, n_target: int) -> StageModel:
    """One Gauss-Newton iteration: the 1-NN (8 FLOPs a source-target
    pair) and the per-point Gauss-Newton terms."""
    flops = 8.0 * n_source * n_target + 400.0 * n_source
    bytes_ = 4.0 * (3 * n_target + 9 * n_source * 4)
    return StageModel("gicp_iter", flops, bytes_)
