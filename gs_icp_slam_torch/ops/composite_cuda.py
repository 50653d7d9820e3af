"""Per-tile alpha compositor, kernel K1-fwd (counterpart of the forward of
gs_icp_slam_tpu/ops/composite_pallas.py `make_composite_win`).

The wrapper launches csrc/composite_fwd.cu for CUDA tensors and runs the
plain PyTorch version beside it for CPU tensors.  Both follow the Pallas
kernel's exclusion rule: once a splat would take a pixel's transmittance
below T_EPS, that splat and every later one are left out (the CUDA
rasterizer's `done` rule).  The backward (K1-bwd) arrives with mapping.
"""
from __future__ import annotations

import ctypes

import torch

from ..cuda_build import CudaKernel, check_tensor, on_cuda, stream_ptr
from .projection import ALPHA_MAX, ALPHA_MIN, T_EPS

_P = ctypes.c_void_p
_I = ctypes.c_int

COMPOSITE_FWD = CudaKernel("composite_fwd", "composite_fwd.cu",
                           "composite_fwd_launch",
                           [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P])


def _composite_loop(counts, starts, pair_slot, attr, ntx, tile):
    """The kernel's front-to-back loop, one splat rank at a time over
    (T, P) pixel vectors, in the kernel's operation order.  Returns the
    (T, 8, P) output and the number of (pixel, splat) pairs examined: for
    each pixel, the splats of its run up to and including the one that
    stops it."""
    T = counts.shape[0]
    P = tile * tile
    dev = attr.device
    out = torch.zeros((T, 8, P), dtype=torch.float32, device=dev)
    examined = torch.zeros((), dtype=torch.int64, device=dev)
    kmax = int(counts.max()) if T else 0
    if kmax == 0:
        out[:, 4] = 1.0
        return out, examined
    pid = torch.arange(P, device=dev)
    tid = torch.arange(T, device=dev)
    px = (((tid % ntx) * tile)[:, None] + (pid % tile)[None]).float()
    py = (((tid // ntx) * tile)[:, None] + (pid // tile)[None]).float()
    rank = torch.arange(kmax, device=dev)
    in_run = rank[None] < counts[:, None].long()                     # (T, K)
    rows = torch.clamp(starts[:, None].long() + rank[None],
                       max=pair_slot.shape[0] - 1)
    a = attr[:10][:, torch.where(in_run, pair_slot[rows].long(), 0)]  # (10, T, K)

    tr = torch.ones((T, P), dtype=torch.float32, device=dev)
    acc = torch.zeros((4, T, P), dtype=torch.float32, device=dev)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    for j in range(kmax):
        aj = a[:, :, j:j + 1]                                         # (10, T, 1)
        live = in_run[:, j:j + 1] & ~done
        examined = examined + live.sum()
        dx = px - aj[0]
        dy = py - aj[1]
        power = -0.5 * (aj[2] * dx * dx + aj[4] * dy * dy) - aj[3] * dx * dy
        araw = aj[8] * torch.exp(power)
        gate = (power <= 0.0) & (araw >= ALPHA_MIN) & live
        alpha = torch.where(gate, torch.clamp(araw, max=ALPHA_MAX), 0.0)
        t_next = tr * (1.0 - alpha)
        stop = gate & (t_next < T_EPS)
        done = done | stop
        inc = gate & ~stop
        w = torch.where(inc, alpha * tr, 0.0)
        for c, row in enumerate((5, 6, 7, 9)):
            acc[c] = acc[c] + w * aj[row]
        tr = torch.where(inc, t_next, tr)
    out[:, 0:4] = acc.permute(1, 0, 2)
    out[:, 4] = tr
    return out, examined


def composite_fwd_plain(counts: torch.Tensor, starts: torch.Tensor,
                        pair_slot: torch.Tensor, attr: torch.Tensor,
                        ntx: int, tile: int) -> torch.Tensor:
    """Plain PyTorch K1-fwd: the same function as the kernel."""
    return _composite_loop(counts, starts, pair_slot, attr, ntx, tile)[0]


def composite_work(counts: torch.Tensor, starts: torch.Tensor,
                   pair_slot: torch.Tensor, attr: torch.Tensor, ntx: int,
                   tile: int) -> int:
    """(pixel, splat) pairs the compositor must examine on these inputs:
    the data-dependent work count behind the kernel's bound."""
    return int(_composite_loop(counts, starts, pair_slot, attr, ntx, tile)[1])


def composite_fwd(counts: torch.Tensor, starts: torch.Tensor,
                  pair_slot: torch.Tensor, attr: torch.Tensor, ntx: int,
                  tile: int) -> torch.Tensor:
    """Composite every tile's run of depth-sorted splats (kernel K1-fwd).

    counts, starts (T,) int32: tile t owns pair rows [starts[t],
    starts[t] + counts[t]) of pair_slot (Np,) int32, front to back; each
    entry is a column of attr (R >= 10, Vp) float32 channel-first (rows
    0 mx, 1 my, 2-4 conic, 5-7 rgb, 8 opacity, 9 depth).  Tiles are
    row-major with ntx per row, tile x tile pixels each (tile^2 <= 1024).
    Returns (T, 8, tile^2) float32: rows 0-2 rgb without background,
    3 depth (sum of w * depth), 4 final transmittance, 5-7 zero.
    """
    dev = attr.device
    T = counts.shape[0]
    check_tensor("counts", counts, torch.int32, (T,), dev)
    check_tensor("starts", starts, torch.int32, (T,), dev)
    check_tensor("pair_slot", pair_slot, torch.int32, (None,), dev)
    check_tensor("attr", attr, torch.float32, (None, None), dev)
    if attr.shape[0] < 10:
        raise ValueError(f"attr has {attr.shape[0]} rows, needs 10")
    if not 1 <= tile * tile <= 1024:
        raise ValueError(f"tile {tile}: tile^2 must be in 1..1024")
    if not on_cuda(dev):
        return composite_fwd_plain(counts, starts, pair_slot, attr, ntx, tile)
    out = torch.empty((T, 8, tile * tile), dtype=torch.float32, device=dev)
    COMPOSITE_FWD(counts.data_ptr(), starts.data_ptr(), pair_slot.data_ptr(), attr.data_ptr(), T,
                  attr.shape[1], ntx, tile, out.data_ptr(), stream_ptr(dev))
    return out

