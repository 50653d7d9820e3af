"""gs_icp_slam_torch — the PyTorch/CUDA port of gs_icp_slam_tpu for one
NVIDIA H100.

The module layout and public names follow the JAX package, so each
function has a counterpart of the same name there.  Plain tensor code is
PyTorch; every Pallas kernel on the ported path is a CUDA kernel written
by hand for Hopper (sources in `csrc/`, built on first use by
`cuda_build.py`).  Each kernel wrapper keeps a plain PyTorch version of
the same function, which it runs only for tensors on the CPU.

Ported so far: `FusedEngine`, the engine of bench.py's path (the fused
per-frame step with grid k-NN source covariances, capacity buckets, the
reservoir keyframe store and `refine`), and the staged `SLAMEngine` —
G-ICP tracking, keyframe insertion with covariance sharing, target
export, mapping iterations (differentiable rendering, the SSIM/L1/depth
loss, masked Adam, pruning) and evaluation renders, both at training
stages 0-2; evaluation (PSNR, SSIM, LPIPS); map maintenance (`compact`,
`densify_clone_split`); bench.py's run (`python -m
gs_icp_slam_torch.bench`); the command line (`python -m gs_icp_slam_torch
run/render/eval`) with PLY export, checkpoints and resume, the Replica /
TUM / offline-scene loaders and the live viewers; and every Pallas kernel
of the JAX package, the dense compositors `make_composite` /
`make_composite_dyn` included.

Layout:
  utils/     quaternion / SE(3) / camera / SH / point-cloud math, losses
  ops/       kNN, 3x3 eigh, covariances, G-ICP, projection, rasterizer,
             and the kernel wrappers (nn_cuda, composite_cuda)
  models/    the fixed-capacity Gaussian map and masked Adam
  slam/      the fused step and engine (fused.py, state.py), the staged
             engine
  datasets/  the synthetic RGB-D sequence, Replica and TUM loaders, the
             offline Scene loaders (COLMAP, SLAM capture, Blender)
  eval/      ATE, image metrics (PSNR/SSIM/LPIPS), LPIPS fixtures, the
             offline render of a saved PLY
  io/        PLY import/export, checkpoints, the COLMAP reader
  viz/       the SIBR remote-viewer bridge and the rerun.io logger
  cli.py     `python -m gs_icp_slam_torch run/render/eval`
  bench.py   bench.py's run through the port, one JSON line
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (point coordinates, covariances, pose solves) needs true float32
# products; TF32 keeps ~3 decimal digits, fatal for mm-scale residuals
# over meter-scale scenes.  Both switches, since cuDNN's defaults to on.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> _torch.device:
    """The device an entry point runs on.  The default is the GPU; with no
    GPU present this raises unless the caller asked for the CPU."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
