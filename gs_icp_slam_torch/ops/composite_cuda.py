"""Per-tile alpha compositor: kernels K1-fwd and K1-bwd (counterpart of
gs_icp_slam_tpu/ops/composite_pallas.py `make_composite_win` and its VJP).

Each wrapper launches its csrc/ kernel for CUDA tensors and runs the plain
PyTorch version beside it for CPU tensors.  Both directions follow the
Pallas kernel's exclusion rule: once a splat would take a pixel's
transmittance below T_EPS, that splat and every later one are left out
(the CUDA rasterizer's `done` rule).  The forward also records, per pixel,
`n_contrib`: one more than the run rank of the last splat it blended (0
for none), the per-pixel form of the Pallas kernel's `nact`.  The backward
walks each pixel's run in reverse from there.

`composite` is the differentiable entry point: a torch.autograd.Function
whose forward is K1-fwd and whose backward is K1-bwd, giving the gradient
of the (10, V+1) compacted attribute table from the gradient of output
rows 0-2 (rgb), 3 (depth) and 4 (final transmittance).
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
                           [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P])
COMPOSITE_BWD = CudaKernel("composite_bwd", "composite_bwd.cu",
                           "composite_bwd_launch",
                           [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                            _P])


def _runs(counts, starts, pair_slot, attr, ntx, tile):
    """Pixel coordinates (T, P) and each tile's run gathered rank-major:
    (10, T, K) attributes, the (T, K) in-run mask and attr columns."""
    T = counts.shape[0]
    P = tile * tile
    dev = attr.device
    kmax = int(counts.max()) if T else 0
    pid = torch.arange(P, device=dev)
    tid = torch.arange(T, device=dev)
    px = (((tid % ntx) * tile)[:, None] + (pid % tile)[None]).to(attr.dtype)
    py = (((tid // ntx) * tile)[:, None] + (pid // tile)[None]).to(attr.dtype)
    rank = torch.arange(kmax, device=dev)
    in_run = rank[None] < counts[:, None].long()                     # (T, K)
    rows = torch.clamp(starts[:, None].long() + rank[None],
                       max=max(pair_slot.shape[0] - 1, 0))
    cols = torch.where(in_run, pair_slot[rows].long(), 0)
    return px, py, kmax, in_run, cols, attr[:10][:, cols]


def _geometry(aj, px, py):
    """The kernel's per-(pixel, splat) terms, in its operation order."""
    dx = px - aj[0]
    dy = py - aj[1]
    power = -0.5 * (aj[2] * dx * dx + aj[4] * dy * dy) - aj[3] * dx * dy
    # the clamp changes no output: below -80 the splat is under ALPHA_MIN
    # and gated out, and the CPU's exp is ~100x slower on denormal results
    gexp = torch.exp(torch.clamp(power, min=-80.0))
    araw = aj[8] * gexp
    gate = (power <= 0.0) & (araw >= ALPHA_MIN)
    return dx, dy, power, gexp, araw, gate


def _composite_loop(counts, starts, pair_slot, attr, ntx, tile):
    """The forward kernel's front-to-back loop, one splat rank at a time
    over (T, P) pixel vectors, in the kernel's operation order.  Returns
    the (T, 8, P) output, n_contrib (T, P) int32 and the number of (pixel,
    splat) pairs examined: for each pixel, the splats of its run up to and
    including the one that stops it."""
    T = counts.shape[0]
    P = tile * tile
    dev = attr.device
    f = dict(dtype=attr.dtype, device=dev)
    out = torch.zeros((T, 8, P), **f)
    n_contrib = torch.zeros((T, P), dtype=torch.int32, device=dev)
    examined = torch.zeros((), dtype=torch.int64, device=dev)
    px, py, kmax, in_run, _, a = _runs(counts, starts, pair_slot, attr, ntx,
                                       tile)
    tr = torch.ones((T, P), **f)
    acc = torch.zeros((4, T, P), **f)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    for j in range(kmax):
        aj = a[:, :, j:j + 1]                                         # (10, T, 1)
        live = in_run[:, j:j + 1] & ~done
        examined = examined + live.sum()
        _, _, _, _, araw, gate = _geometry(aj, px, py)
        gate = gate & live
        alpha = torch.where(gate, torch.clamp(araw, max=ALPHA_MAX), 0.0)
        t_next = tr * (1.0 - alpha)
        stop = gate & (t_next < T_EPS)
        done = done | stop
        inc = gate & ~stop
        w = torch.where(inc, alpha * tr, 0.0)
        for c, row in enumerate((5, 6, 7, 9)):
            acc[c] = acc[c] + w * aj[row]
        tr = torch.where(inc, t_next, tr)
        n_contrib = torch.where(inc, j + 1, n_contrib)
    out[:, 0:4] = acc.permute(1, 0, 2)
    out[:, 4] = tr
    return out, n_contrib, examined


def composite_fwd_plain(counts: torch.Tensor, starts: torch.Tensor,
                        pair_slot: torch.Tensor, attr: torch.Tensor,
                        ntx: int, tile: int):
    """Plain PyTorch K1-fwd: the same function as the kernel."""
    return _composite_loop(counts, starts, pair_slot, attr, ntx, tile)[:2]


def composite_work(counts: torch.Tensor, starts: torch.Tensor,
                   pair_slot: torch.Tensor, attr: torch.Tensor, ntx: int,
                   tile: int) -> int:
    """(pixel, splat) pairs the forward must examine on these inputs: the
    data-dependent work count behind K1-fwd's bound."""
    return int(_composite_loop(counts, starts, pair_slot, attr, ntx, tile)[2])


def _check_inputs(counts, starts, pair_slot, attr, tile):
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


def composite_fwd(counts: torch.Tensor, starts: torch.Tensor,
                  pair_slot: torch.Tensor, attr: torch.Tensor, ntx: int,
                  tile: int):
    """Composite every tile's run of depth-sorted splats (kernel K1-fwd).

    counts, starts (T,) int32: tile t owns pair rows [starts[t],
    starts[t] + counts[t]) of pair_slot (Np,) int32, front to back; each
    entry is a column of attr (R >= 10, Vp) float32 channel-first (rows
    0 mx, 1 my, 2-4 conic, 5-7 rgb, 8 opacity, 9 depth).  Tiles are
    row-major with ntx per row, tile x tile pixels each (tile^2 <= 1024).
    Returns (out (T, 8, tile^2) float32: rows 0-2 rgb without background,
    3 depth (sum of w * depth), 4 final transmittance, 5-7 zero;
    n_contrib (T, tile^2) int32).
    """
    _check_inputs(counts, starts, pair_slot, attr, tile)
    dev = attr.device
    if not on_cuda(dev):
        return composite_fwd_plain(counts, starts, pair_slot, attr, ntx, tile)
    T = counts.shape[0]
    out = torch.empty((T, 8, tile * tile), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((T, tile * tile), dtype=torch.int32, device=dev)
    COMPOSITE_FWD(counts.data_ptr(), starts.data_ptr(), pair_slot.data_ptr(),
                  attr.data_ptr(), T, attr.shape[1], ntx, tile,
                  out.data_ptr(), n_contrib.data_ptr(), stream_ptr(dev))
    return out, n_contrib


def _composite_bwd_loop(counts, starts, pair_slot, attr, out, n_contrib, g,
                        ntx, tile):
    """The backward kernel's reverse walk, one splat rank at a time over
    (T, P) pixel vectors, in the kernel's operation order.  Each pixel
    walks ranks below its n_contrib, recovering the transmittance before
    each blended splat by division (T_before = T_after / (1 - alpha)) and
    carrying S, the sum of w * dL/dw over the later blended splats:

        dL/dw     = g_rgb . rgb + g_depth * depth
        dL/dalpha = T_before * dL/dw - (S + g_tf * t_final) / (1 - alpha)

    zero where alpha was clamped at ALPHA_MAX.  Per-(tile, rank) sums over
    the pixels go to the splat's column with index_add_.  Returns the
    (R, Vp) gradient of attr (rows >= 10 zero), the number of (pixel,
    splat) pairs walked and of those that blended."""
    T = counts.shape[0]
    P = tile * tile
    dev = attr.device
    d_attr = torch.zeros_like(attr)
    px, py, kmax, in_run, cols, a = _runs(counts, starts, pair_slot, attr,
                                          ntx, tile)
    walked = torch.zeros((), dtype=torch.int64, device=dev)
    blended = torch.zeros((), dtype=torch.int64, device=dev)
    if kmax == 0:
        return d_attr, walked, blended
    g_r, g_g, g_b, g_d, g_tf = (g[:, c] for c in range(5))
    tr = out[:, 4].clone()
    gtf_tf = g_tf * out[:, 4]
    S = torch.zeros((T, P), dtype=attr.dtype, device=dev)
    cell = torch.zeros((10, T, kmax), dtype=attr.dtype, device=dev)
    for j in range(kmax - 1, -1, -1):
        aj = a[:, :, j:j + 1]
        act = n_contrib > j
        walked = walked + act.sum()
        dx, dy, _, gexp, araw, gate = _geometry(aj, px, py)
        gate = gate & act
        blended = blended + gate.sum()
        alpha = torch.clamp(araw, max=ALPHA_MAX)
        o = 1.0 - alpha
        t_before = tr / o
        dldw = g_r * aj[5] + g_g * aj[6] + g_b * aj[7] + g_d * aj[9]
        w = alpha * t_before
        dalpha = t_before * dldw - (S + gtf_tf) / o
        m = gate & (araw < ALPHA_MAX)
        dpow = dalpha * araw
        ca, cb, cc = aj[2], aj[3], aj[4]
        terms = (dpow * (ca * dx + cb * dy), dpow * (cc * dy + cb * dx),
                 dpow * (-0.5 * dx * dx), dpow * (-dx * dy),
                 dpow * (-0.5 * dy * dy), w * g_r, w * g_g, w * g_b,
                 dalpha * gexp, w * g_d)
        for c, v in enumerate(terms):
            keep = m if c in (0, 1, 2, 3, 4, 8) else gate
            cell[c, :, j] = torch.where(keep, v, 0.0).sum(1)
        S = torch.where(gate, S + w * dldw, S)
        tr = torch.where(gate, t_before, tr)
    cell = torch.where(in_run[None], cell, 0.0)
    d_attr[:10].index_add_(1, cols.reshape(-1), cell.reshape(10, -1))
    return d_attr, walked, blended


def composite_bwd_plain(counts, starts, pair_slot, attr, out, n_contrib, g,
                        ntx: int, tile: int) -> torch.Tensor:
    """Plain PyTorch K1-bwd: the same function as the kernel."""
    return _composite_bwd_loop(counts, starts, pair_slot, attr, out,
                               n_contrib, g, ntx, tile)[0]


def composite_bwd_work(counts, starts, pair_slot, attr, out, n_contrib, g,
                       ntx: int, tile: int):
    """(pixel, splat) pairs the backward walks on these inputs, and how
    many of them blended: the data-dependent work behind K1-bwd's bound."""
    _, walked, blended = _composite_bwd_loop(
        counts, starts, pair_slot, attr, out, n_contrib, g, ntx, tile)
    return int(walked), int(blended)


def composite_bwd(counts: torch.Tensor, starts: torch.Tensor,
                  pair_slot: torch.Tensor, attr: torch.Tensor,
                  out: torch.Tensor, n_contrib: torch.Tensor,
                  g: torch.Tensor, ntx: int, tile: int) -> torch.Tensor:
    """Gradient of the compacted attribute table (kernel K1-bwd).

    counts, starts, pair_slot, attr, ntx, tile as for composite_fwd; out
    (T, 8, P) and n_contrib (T, P) are its outputs; g (T, 8, P) float32 is
    the gradient of out (rows 0-4 read).  Returns (R, Vp) float32, rows
    0-9 the gradient of attr's rows (rows >= 10 zero)."""
    _check_inputs(counts, starts, pair_slot, attr, tile)
    dev = attr.device
    T, P = counts.shape[0], tile * tile
    check_tensor("out", out, torch.float32, (T, 8, P), dev)
    check_tensor("n_contrib", n_contrib, torch.int32, (T, P), dev)
    check_tensor("g", g, torch.float32, (T, 8, P), dev)
    if not on_cuda(dev):
        return composite_bwd_plain(counts, starts, pair_slot, attr, out,
                                   n_contrib, g, ntx, tile)
    d_attr = torch.zeros_like(attr)
    COMPOSITE_BWD(counts.data_ptr(), starts.data_ptr(), pair_slot.data_ptr(),
                  attr.data_ptr(), T, attr.shape[1], ntx, tile,
                  out.data_ptr(), n_contrib.data_ptr(), g.data_ptr(),
                  d_attr.data_ptr(), stream_ptr(dev))
    return d_attr


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, counts, starts, pair_slot, attr, ntx, tile):
        out, n_contrib = composite_fwd(counts, starts, pair_slot, attr, ntx,
                                       tile)
        ctx.save_for_backward(counts, starts, pair_slot, attr, out,
                              n_contrib)
        ctx.geom = (ntx, tile)
        return out

    @staticmethod
    def backward(ctx, g):
        counts, starts, pair_slot, attr, out, n_contrib = ctx.saved_tensors
        d_attr = composite_bwd(counts, starts, pair_slot, attr, out,
                               n_contrib, g.contiguous(), *ctx.geom)
        return None, None, None, d_attr, None, None


def composite(counts: torch.Tensor, starts: torch.Tensor,
              pair_slot: torch.Tensor, attr: torch.Tensor, ntx: int,
              tile: int) -> torch.Tensor:
    """composite_fwd's (T, 8, P) output, differentiable with respect to
    attr: the backward is K1-bwd (composite_bwd)."""
    return _Composite.apply(counts, starts, pair_slot, attr, ntx, tile)
