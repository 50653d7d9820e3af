"""Per-tile alpha compositor: kernels K1-fwd and K1-bwd (counterpart of
gs_icp_slam_tpu/ops/composite_pallas.py `make_composite_win` and its VJP),
and K4a/K4b, the same function on a dense (T, 16, K) block per tile
(`make_composite`, `make_composite_dyn`).

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
rows 0-2 (rgb), 3 (depth) and 4 (final transmittance).  K1-bwd sums each
(tile, rank) cell into a cell buffer indexed by pair row, then each
splat's cells through its pair rows (`splat_rows`: from the binning, or
`splat_pair_rows` for any pair table); `composite_bwd_cells_plain` and
`gather_cells_plain` are that design in plain PyTorch.  `make_composite`
and `make_composite_dyn` build the K4a/K4b entry points the same way.

All four kernels give each warp an 8x4 patch of pixels and skip a splat
when a rectangle test proves that no pixel of the patch reaches the
splat's gate power (`patch_culled_plain`, `fwd_warp_patches`); K4's
kernels are K1's on the dense layout (csrc/composite_tile.cuh).
`composite_fwd_cull_plain` and `composite_dense_fwd_cull_plain` are the
forwards' cull in plain PyTorch, `composite_dense_bwd_ranks_plain` K4's
backward walk bound and cull; `composite_fwd_counts`,
`composite_dense_fwd_counts` and `composite_dense_bwd_counts` read the
kernels' own counts, for chip_smoke.py.

The plain versions share one rank-at-a-time loop over a run layout: the
splats of each tile's run gathered rank-major, (10, T, kmax), with an
in-run mask.  K1 gathers it through pair_slot; K4 reads its dense block.
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
                           [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P])
COMPOSITE_BWD = CudaKernel("composite_bwd", "composite_bwd.cu",
                           "composite_bwd_launch",
                           [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                            _P, _P, _I, _P, _P, _P])
# K1-fwd's and K1-bwd's block covers a BWD_SIDE x BWD_SIDE corner of a
# tile (the whole tile when it is smaller): four blocks per 32-pixel tile
BWD_SIDE = 16
# K4a (dense) and K4b (dense with per-tile counts): one source, four entry
# points, each with its own launch count
COMPOSITE_DENSE_FWD = CudaKernel("composite_dense_fwd", "composite_dense.cu",
                                 "composite_dense_fwd_launch",
                                 [_P, _I, _I, _I, _I, _P, _P, _P, _P])
COMPOSITE_DENSE_BWD = CudaKernel("composite_dense_bwd", "composite_dense.cu",
                                 "composite_dense_bwd_launch",
                                 [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                  _P])
COMPOSITE_DYN_FWD = CudaKernel("composite_dyn_fwd", "composite_dense.cu",
                               "composite_dyn_fwd_launch",
                               [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P])
COMPOSITE_DYN_BWD = CudaKernel("composite_dyn_bwd", "composite_dense.cu",
                               "composite_dyn_bwd_launch",
                               [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                _P])


def _pixels(T, ntx, tile, dev, dtype):
    """Pixel coordinates (T, P) of every tile, row-major tiles."""
    P = tile * tile
    pid = torch.arange(P, device=dev)
    tid = torch.arange(T, device=dev)
    px = (((tid % ntx) * tile)[:, None] + (pid % tile)[None]).to(dtype)
    py = (((tid // ntx) * tile)[:, None] + (pid // tile)[None]).to(dtype)
    return px, py


def _runs(counts, starts, pair_slot, attr, ntx, tile):
    """K1's run layout: pixel coordinates (T, P), the (T, kmax) in-run
    mask, the attr columns of each run and its (10, T, kmax) attributes."""
    T = counts.shape[0]
    dev = attr.device
    kmax = int(counts.max()) if T else 0
    px, py = _pixels(T, ntx, tile, dev, attr.dtype)
    rank = torch.arange(kmax, device=dev)
    in_run = rank[None] < counts[:, None].long()                     # (T, K)
    rows = torch.clamp(starts[:, None].long() + rank[None],
                       max=max(pair_slot.shape[0] - 1, 0))
    cols = torch.where(in_run, pair_slot[rows].long(), 0)
    return px, py, in_run, cols, attr[:10][:, cols]


def _dense_runs(counts, attrs, ntx, tile):
    """K4's run layout: slot k of tile t is its run rank k; with counts,
    tile t's run is its first counts[t] slots (clamped to [0, K])."""
    T, _, K = attrs.shape
    dev = attrs.device
    px, py = _pixels(T, ntx, tile, dev, attrs.dtype)
    if counts is None:
        kmax = K
        in_run = torch.ones((T, K), dtype=torch.bool, device=dev)
    else:
        c = torch.clamp(counts.long(), 0, K)
        kmax = int(c.max()) if T else 0
        in_run = torch.arange(kmax, device=dev)[None] < c[:, None]
    return px, py, in_run, attrs[:, :10, :kmax].permute(1, 0, 2)


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


def gate_power_plain(op: torch.Tensor) -> torch.Tensor:
    """The kernels' per-splat gate power pmin (composite_common.cuh
    gate_power): below it opacity * exp(power) < 0.952 / 255, so the pair
    is gated out; +inf for an opacity <= 0 or NaN."""
    return torch.where(op > 0.0, torch.log(ALPHA_MIN / op) - 0.05,
                       float("inf"))


def patch_culled_plain(a: torch.Tensor, xlo, xhi, ylo, yhi) -> torch.Tensor:
    """The kernels' rectangle test (composite_common.cuh patch_culled), in
    its operation order: True where no pixel of [xlo, xhi] x [ylo, yhi]
    can reach the splat's gate power.  a (10, ...) splat rows, broadcast
    with the rectangle's bounds; a conic that is not positive definite or
    has a condition number of 1e4 or more culls nothing, unless the gate
    power is +inf (opacity <= 0 or NaN: culled everywhere)."""
    ca, cb, cc = a[2], a[3], a[4]
    det = ca * cc - cb * cb
    tr = ca + cc
    ok = (ca > 0.0) & (cc > 0.0) & (det * 1e4 > tr * tr)
    lam = det / tr
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    gx = torch.fmax(torch.fmax(xlo - a[0], a[0] - xhi), zero)
    gy = torch.fmax(torch.fmax(ylo - a[1], a[1] - yhi), zero)
    pmin = gate_power_plain(a[8])
    return ~(pmin < float("inf")) | (
        ok & (0.5 * lam * (gx * gx + gy * gy) * 0.98 > 0.01 - pmin))


def fwd_warp_patches(tile: int, side: int | None = None) -> torch.Tensor:
    """The kernels' warps (composite_common.cuh corner_pixel): (tile^2,) the
    warp of each pixel of a tile, numbered block by block, a block per
    side x side corner (K1-fwd, K1-bwd and K4's forward: side
    min(tile, BWD_SIDE); K4's backward: side tile), an 8x4 patch a warp
    where side is a multiple of 8, else whole rows."""
    side = min(tile, BWD_SIDE) if side is None else side
    nsx = -(-tile // side)
    threads = -(-side * side // 32) * 32
    tid = torch.arange(threads)
    lane, warp = tid % 32, tid // 32
    if side % 8 == 0:
        wx = side // 8
        lx = lane % 8 + 8 * (warp % wx)
        ly = lane // 8 + 4 * (warp // wx)
    else:
        lx, ly = tid % side, tid // side
    patch = torch.full((tile * tile,), -1, dtype=torch.long)
    for sub in range(nsx * nsx):
        x = (sub % nsx) * side + lx
        y = (sub // nsx) * side + ly
        ok = (tid < side * side) & (x < tile) & (y < tile)
        patch[(y * tile + x)[ok]] = sub * (threads // 32) + warp[ok]
    return patch


def _warp_rects(px, py, patch):
    """Each warp's pixel rectangle: four (T, nwarps, 1) bounds xlo, xhi,
    ylo, yhi over the pixels (T, P) of the warp of each pixel (patch)."""
    n = int(patch.max()) + 1
    T = px.shape[0]
    rect = []
    for v, red, fill in ((px, "amin", float("inf")),
                         (px, "amax", -float("inf")),
                         (py, "amin", float("inf")),
                         (py, "amax", -float("inf"))):
        r = torch.full((T, n), fill, dtype=px.dtype, device=px.device)
        rect.append(r.scatter_reduce(1, patch.expand(T, -1), v, red)[
            ..., None])
    return rect


def _composite_loop(px, py, in_run, a, skip=None):
    """The forward kernels' front-to-back loop over a run layout, one
    splat rank at a time over (T, P) pixel vectors, in the kernels'
    operation order.  Returns the (T, 8, P) output, n_contrib (T, P) int32
    and counts of (pixel, splat) pairs: examined (for each pixel, the
    splats of its run up to and including the one that stops it), gated
    (those that blend or stop), and, with skip (T, P, kmax) bool, the
    pairs K1-fwd's rectangle test skips: culled (the examined pairs
    skipped) and lost (skipped pairs, or pairs whose power is below the
    splat's gate power, that would have blended or stopped: none, if the
    kernel's skips are exact).  A skipped pair neither blends nor stops."""
    T, P = px.shape
    kmax = a.shape[2]
    dev = a.device
    f = dict(dtype=a.dtype, device=dev)
    out = torch.zeros((T, 8, P), **f)
    n_contrib = torch.zeros((T, P), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    examined = gated = culled = lost = zero
    tr = torch.ones((T, P), **f)
    acc = torch.zeros((4, T, P), **f)
    done = torch.zeros((T, P), dtype=torch.bool, device=dev)
    for j in range(kmax):
        aj = a[:, :, j:j + 1]                                         # (10, T, 1)
        live = in_run[:, j:j + 1] & ~done
        examined = examined + live.sum()
        _, _, power, _, araw, gate = _geometry(aj, px, py)
        gate = gate & live
        if skip is not None:
            sk = skip[:, :, j]
            low = power < gate_power_plain(aj[8])
            culled = culled + (live & sk).sum()
            lost = lost + (gate & (sk | low)).sum()
            gate = gate & ~sk
        gated = gated + gate.sum()
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
    return out, n_contrib, examined, gated, culled, lost


def composite_fwd_plain(counts: torch.Tensor, starts: torch.Tensor,
                        pair_slot: torch.Tensor, attr: torch.Tensor,
                        ntx: int, tile: int):
    """Plain PyTorch K1-fwd: the same function as the kernel."""
    px, py, in_run, _, a = _runs(counts, starts, pair_slot, attr, ntx, tile)
    return _composite_loop(px, py, in_run, a)[:2]


def composite_work(counts: torch.Tensor, starts: torch.Tensor,
                   pair_slot: torch.Tensor, attr: torch.Tensor, ntx: int,
                   tile: int) -> int:
    """(pixel, splat) pairs the forward must examine on these inputs: the
    data-dependent work count behind K1-fwd's bound."""
    px, py, in_run, _, a = _runs(counts, starts, pair_slot, attr, ntx, tile)
    return int(_composite_loop(px, py, in_run, a)[2])


def _cull_loop(px, py, in_run, a, tile):
    """The forward's loop over a run layout with every pair skipped that
    the kernels' warp-rectangle test skips (fwd_warp_patches,
    patch_culled_plain on the warp's pixel rectangle): (out, n_contrib,
    stats) as composite_fwd_cull_plain returns them."""
    patch = fwd_warp_patches(tile).to(a.device)
    rect = _warp_rects(px, py, patch)
    culled = patch_culled_plain(a[:, :, None, :], *rect)         # (T, n, K)
    out, n_contrib, examined, gated, cull, lost = _composite_loop(
        px, py, in_run, a, skip=culled[:, patch])
    stats = dict(examined=int(examined), gated=int(gated),
                 evaluated=int(examined - cull), culled=int(cull),
                 lost=int(lost))
    return out, n_contrib, stats


def composite_fwd_cull_plain(counts: torch.Tensor, starts: torch.Tensor,
                             pair_slot: torch.Tensor, attr: torch.Tensor,
                             ntx: int, tile: int):
    """Plain PyTorch model of K1-fwd's warp cull: the loop of
    composite_fwd_plain with every pair skipped that the kernel's
    rectangle test skips for the pixel's warp (fwd_warp_patches,
    patch_culled_plain on the warp's pixel rectangle).  Returns (out,
    n_contrib, stats) with stats {"examined", "gated", "evaluated" (the
    examined pairs the rectangle test lets through), "culled", "lost"}
    (see _composite_loop): exact skips give lost 0 and composite_fwd_plain's
    bits; gated counts the pairs that blend or stop, the work behind
    K1-fwd's bound.  Holds a (T, P, kmax) mask."""
    px, py, in_run, _, a = _runs(counts, starts, pair_slot, attr, ntx, tile)
    return _cull_loop(px, py, in_run, a, tile)


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


def _launch_fwd(counts, starts, pair_slot, attr, ntx, tile, counters):
    dev = attr.device
    T = counts.shape[0]
    out = torch.empty((T, 8, tile * tile), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((T, tile * tile), dtype=torch.int32, device=dev)
    COMPOSITE_FWD(counts.data_ptr(), starts.data_ptr(), pair_slot.data_ptr(),
                  attr.data_ptr(), T, attr.shape[1], ntx, tile,
                  out.data_ptr(), n_contrib.data_ptr(),
                  None if counters is None else counters.data_ptr(),
                  stream_ptr(dev))
    return out, n_contrib


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
    if not on_cuda(attr.device):
        return composite_fwd_plain(counts, starts, pair_slot, attr, ntx, tile)
    return _launch_fwd(counts, starts, pair_slot, attr, ntx, tile, None)


def composite_fwd_counts(counts: torch.Tensor, starts: torch.Tensor,
                         pair_slot: torch.Tensor, attr: torch.Tensor,
                         ntx: int, tile: int):
    """K1-fwd on the card as composite_fwd, also reading what it did (a
    host sync; for measurement): (out, n_contrib, stats), stats
    {"evaluated": the (pixel, splat) pairs whose power the kernel
    computed, "culled": those its warp-rectangle test skipped}, counted by
    the kernel over the pixels still running; their sum is the examined
    count of composite_work, and composite_fwd_cull_plain models both."""
    _check_inputs(counts, starts, pair_slot, attr, tile)
    if not on_cuda(attr.device):
        raise ValueError("composite_fwd_counts reads the kernel's counters: "
                         "CUDA tensors only")
    counters = torch.zeros(2, dtype=torch.int64, device=attr.device)
    out, n_contrib = _launch_fwd(counts, starts, pair_slot, attr, ntx, tile,
                                 counters)
    evaluated, culled = counters.tolist()
    return out, n_contrib, dict(evaluated=evaluated, culled=culled)


def _composite_bwd_loop(px, py, in_run, a, out, n_contrib, g):
    """The backward kernels' reverse walk over a run layout, one splat rank
    at a time over (T, P) pixel vectors, in the kernels' operation order.
    Each pixel walks ranks below its n_contrib, recovering the
    transmittance before each blended splat by division (T_before =
    T_after / (1 - alpha)) and carrying S, the sum of w * dL/dw over the
    later blended splats:

        dL/dw     = g_rgb . rgb + g_depth * depth
        dL/dalpha = T_before * dL/dw - (S + g_tf * t_final) / (1 - alpha)

    zero where alpha was clamped at ALPHA_MAX.  Returns the per-(tile,
    rank) sums over the pixels, (10, T, kmax) (zero outside the runs), the
    number of (pixel, splat) pairs walked and of those that blended."""
    T, P = px.shape
    kmax = a.shape[2]
    dev = a.device
    walked = torch.zeros((), dtype=torch.int64, device=dev)
    blended = torch.zeros((), dtype=torch.int64, device=dev)
    cell = torch.zeros((10, T, kmax), dtype=a.dtype, device=dev)
    if kmax == 0:
        return cell, walked, blended
    g_r, g_g, g_b, g_d, g_tf = (g[:, c] for c in range(5))
    tr = out[:, 4].clone()
    gtf_tf = g_tf * out[:, 4]
    S = torch.zeros((T, P), dtype=a.dtype, device=dev)
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
    return torch.where(in_run[None], cell, 0.0), walked, blended


def _composite_bwd_pairs(counts, starts, pair_slot, attr, out, n_contrib, g,
                         ntx, tile):
    """K1-bwd's reverse walk, the per-(tile, rank) sums sent to each
    splat's column with index_add_: ((R, Vp) gradient, walked, blended)."""
    px, py, in_run, cols, a = _runs(counts, starts, pair_slot, attr, ntx,
                                    tile)
    cell, walked, blended = _composite_bwd_loop(px, py, in_run, a, out,
                                                n_contrib, g)
    d_attr = torch.zeros_like(attr)
    d_attr[:10].index_add_(1, cols.reshape(-1), cell.reshape(10, -1))
    return d_attr, walked, blended


def composite_bwd_plain(counts, starts, pair_slot, attr, out, n_contrib, g,
                        ntx: int, tile: int) -> torch.Tensor:
    """Plain PyTorch K1-bwd: the same function as the kernel."""
    return _composite_bwd_pairs(counts, starts, pair_slot, attr, out,
                                n_contrib, g, ntx, tile)[0]


def composite_bwd_work(counts, starts, pair_slot, attr, out, n_contrib, g,
                       ntx: int, tile: int):
    """(pixel, splat) pairs the backward walks on these inputs, and how
    many of them blended: the data-dependent work behind K1-bwd's bound."""
    _, walked, blended = _composite_bwd_pairs(
        counts, starts, pair_slot, attr, out, n_contrib, g, ntx, tile)
    return int(walked), int(blended)


def splat_pair_rows(counts: torch.Tensor, starts: torch.Tensor,
                    pair_slot: torch.Tensor, Vp: int) -> torch.Tensor:
    """K1-bwd's splat -> pair-row map for any pair table: (M, Vp) int32,
    column v listing the rows of the runs (rank < counts[t]) whose slot is
    v in increasing row order, -1 padded; M is the largest count (1 at
    least).  The rasterizer's binning builds the same map from its sort
    (ops.rasterize.Binning.splat_rows); this one syncs with the host."""
    dev = pair_slot.device
    c = counts.long()
    n = int(c.sum())
    first = torch.repeat_interleave(starts.long() - (torch.cumsum(c, 0) - c),
                                    c, output_size=n)
    rows = first + torch.arange(n, device=dev)
    slot = pair_slot[rows].long()
    order = torch.sort(slot * max(pair_slot.shape[0], 1) + rows).indices
    slot, rows = slot[order], rows[order]
    pos = torch.arange(n, device=dev) - torch.searchsorted(slot, slot)
    M = int(pos.max()) + 1 if n else 1
    out = torch.full((M, Vp), -1, dtype=torch.int32, device=dev)
    out[pos, slot] = rows.to(torch.int32)
    return out


def composite_bwd_cells_plain(counts, starts, pair_slot, attr, out,
                              n_contrib, g, ntx: int, tile: int):
    """Plain PyTorch K1-bwd, first stage: the (Np, 1, 10) cell buffer, row
    starts[t] + rank holding the sums of tile t's pixels for that rank
    (zero on rows outside the runs).  The kernel keeps one plane per tile
    corner (its blocks); here one plane holds the whole tile."""
    px, py, in_run, _, a = _runs(counts, starts, pair_slot, attr, ntx, tile)
    cell, _, _ = _composite_bwd_loop(px, py, in_run, a, out, n_contrib, g)
    buf = torch.zeros((pair_slot.shape[0], 1, 10), dtype=attr.dtype,
                      device=attr.device)
    rank = torch.arange(cell.shape[2], device=attr.device)
    rows = starts[:, None].long() + rank[None]
    buf[rows[in_run], 0] = cell.permute(1, 2, 0)[in_run]
    return buf


def gather_cells_plain(cell: torch.Tensor, splat_rows: torch.Tensor,
                       R: int = 10) -> torch.Tensor:
    """Plain PyTorch K1-bwd, second stage: (R, Vp), column v the sum of
    cell (Np, nsub, 10) over its pair rows (splat_rows (M, Vp), -1
    skipped) and planes; rows >= 10 zero."""
    M, Vp = splat_rows.shape
    r = splat_rows.long()
    got = torch.where((r >= 0)[..., None, None], cell[r.clamp(min=0)], 0.0)
    d = torch.zeros((R, Vp), dtype=cell.dtype, device=cell.device)
    d[:10] = got.sum((0, 2)).T
    return d


def composite_bwd(counts: torch.Tensor, starts: torch.Tensor,
                  pair_slot: torch.Tensor, attr: torch.Tensor,
                  out: torch.Tensor, n_contrib: torch.Tensor,
                  g: torch.Tensor, ntx: int, tile: int,
                  splat_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Gradient of the compacted attribute table (kernel K1-bwd).

    counts, starts, pair_slot, attr, ntx, tile as for composite_fwd; out
    (T, 8, P) and n_contrib (T, P) are its outputs; g (T, 8, P) float32 is
    the gradient of out (rows 0-4 read); splat_rows (M, Vp) int32 is the
    splat -> pair-row map (built with splat_pair_rows when None).
    Returns (R, Vp) float32, rows 0-9 the gradient of attr's rows (rows
    >= 10 zero).  Deterministic: no atomics."""
    _check_inputs(counts, starts, pair_slot, attr, tile)
    dev = attr.device
    T, P = counts.shape[0], tile * tile
    R, Vp = attr.shape
    check_tensor("out", out, torch.float32, (T, 8, P), dev)
    check_tensor("n_contrib", n_contrib, torch.int32, (T, P), dev)
    check_tensor("g", g, torch.float32, (T, 8, P), dev)
    if splat_rows is not None:
        check_tensor("splat_rows", splat_rows, torch.int32, (None, Vp), dev)
    if not on_cuda(dev):
        return composite_bwd_plain(counts, starts, pair_slot, attr, out,
                                   n_contrib, g, ntx, tile)
    if splat_rows is None:
        splat_rows = splat_pair_rows(counts, starts, pair_slot, Vp)
    side = min(tile, BWD_SIDE)
    nsub = (-(-tile // side)) ** 2
    cell = torch.empty((pair_slot.shape[0], nsub, 10), dtype=torch.float32,
                       device=dev)
    d_attr = torch.empty_like(attr)
    COMPOSITE_BWD(counts.data_ptr(), starts.data_ptr(), pair_slot.data_ptr(),
                  attr.data_ptr(), T, R, Vp, ntx, tile, side, out.data_ptr(),
                  n_contrib.data_ptr(), g.data_ptr(), splat_rows.data_ptr(),
                  splat_rows.shape[0], cell.data_ptr(), d_attr.data_ptr(),
                  stream_ptr(dev))
    return d_attr


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, counts, starts, pair_slot, attr, ntx, tile, splat_rows):
        out, n_contrib = composite_fwd(counts, starts, pair_slot, attr, ntx,
                                       tile)
        ctx.save_for_backward(counts, starts, pair_slot, attr, out,
                              n_contrib)
        ctx.geom = (ntx, tile)
        ctx.splat_rows = splat_rows
        return out

    @staticmethod
    def backward(ctx, g):
        counts, starts, pair_slot, attr, out, n_contrib = ctx.saved_tensors
        d_attr = composite_bwd(counts, starts, pair_slot, attr, out,
                               n_contrib, g.contiguous(), *ctx.geom,
                               ctx.splat_rows)
        return None, None, None, d_attr, None, None, None


def composite(counts: torch.Tensor, starts: torch.Tensor,
              pair_slot: torch.Tensor, attr: torch.Tensor, ntx: int,
              tile: int, splat_rows: torch.Tensor | None = None
              ) -> torch.Tensor:
    """composite_fwd's (T, 8, P) output, differentiable with respect to
    attr: the backward is K1-bwd (composite_bwd, given splat_rows, the
    binning's splat -> pair-row map)."""
    return _Composite.apply(counts, starts, pair_slot, attr, ntx, tile,
                            splat_rows)


# ------------------------------------------------------------- K4a / K4b --

def _check_dense(counts, attrs, tile):
    dev = attrs.device
    check_tensor("attrs", attrs, torch.float32, (None, 16, None), dev)
    if counts is not None:
        check_tensor("counts", counts, torch.int32, (attrs.shape[0],), dev)
    if not 1 <= tile * tile <= 1024:
        raise ValueError(f"tile {tile}: tile^2 must be in 1..1024")


def composite_dense_fwd_plain(counts, attrs: torch.Tensor, ntx: int,
                              tile: int):
    """Plain PyTorch K4a (counts None) / K4b forward: the same function as
    the kernel.  Returns (out (T, 8, P), n_contrib (T, P) int32)."""
    return _composite_loop(*_dense_runs(counts, attrs, ntx, tile))[:2]


def composite_dense_work(counts, attrs: torch.Tensor, ntx: int,
                         tile: int) -> int:
    """(pixel, splat) pairs the K4 forward must examine on these inputs."""
    return int(_composite_loop(*_dense_runs(counts, attrs, ntx, tile))[2])


def composite_dense_fwd_cull_plain(counts, attrs: torch.Tensor, ntx: int,
                                   tile: int):
    """Plain PyTorch model of K4's forward cull (K1-fwd's, on the dense
    layout): (out, n_contrib, stats) as composite_fwd_cull_plain; exact
    skips give lost 0 and composite_dense_fwd_plain's bits, and evaluated +
    culled = examined, composite_dense_work's count.  Holds a (T, P, kmax)
    mask."""
    return _cull_loop(*_dense_runs(counts, attrs, ntx, tile), tile)


def composite_dense_bwd_ranks_plain(counts, attrs: torch.Tensor,
                                    n_contrib: torch.Tensor, ntx: int,
                                    tile: int) -> dict:
    """Plain PyTorch model of K4's backward walk bound and cull: one block
    per tile, a warp per 8x4 patch (fwd_warp_patches(tile, tile)); a warp
    considers the ranks below its pixels' largest n_contrib and culls
    those whose splat misses its rectangle (patch_culled_plain).  Returns
    {"walked", "culled"} (warp, rank) pairs, the kernel's counters."""
    px, py, in_run, a = _dense_runs(counts, attrs, ntx, tile)
    patch = fwd_warp_patches(tile, tile).to(a.device)
    T, n = px.shape[0], int(patch.max()) + 1
    wwalk = torch.zeros((T, n), dtype=torch.long, device=a.device)
    wwalk = wwalk.scatter_reduce(1, patch.expand(T, -1), n_contrib.long(),
                                 "amax")
    below = torch.arange(a.shape[2], device=a.device) < wwalk[..., None]
    culled = patch_culled_plain(a[:, :, None, :], *_warp_rects(px, py, patch))
    return dict(walked=int((below & ~culled).sum()),
                culled=int((below & culled).sum()))


def _composite_dense_bwd_cells(counts, attrs, out, n_contrib, g, ntx, tile):
    px, py, in_run, a = _dense_runs(counts, attrs, ntx, tile)
    cell, walked, blended = _composite_bwd_loop(px, py, in_run, a, out,
                                                n_contrib, g)
    d_attrs = torch.zeros_like(attrs)
    d_attrs[:, :10, :cell.shape[2]] = cell.permute(1, 0, 2)
    return d_attrs, walked, blended


def composite_dense_bwd_plain(counts, attrs, out, n_contrib, g, ntx: int,
                              tile: int) -> torch.Tensor:
    """Plain PyTorch K4a (counts None) / K4b backward: the (T, 16, K)
    gradient of attrs, the same function as the kernel."""
    return _composite_dense_bwd_cells(counts, attrs, out, n_contrib, g, ntx,
                                      tile)[0]


def composite_dense_bwd_work(counts, attrs, out, n_contrib, g, ntx: int,
                             tile: int):
    """(pixel, splat) pairs the K4 backward walks, and how many blended."""
    _, walked, blended = _composite_dense_bwd_cells(counts, attrs, out,
                                                    n_contrib, g, ntx, tile)
    return int(walked), int(blended)


def _launch_dense_fwd(counts, attrs, ntx, tile, counters):
    dev = attrs.device
    T, _, K = attrs.shape
    P = tile * tile
    out = torch.empty((T, 8, P), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((T, P), dtype=torch.int32, device=dev)
    cp = None if counters is None else counters.data_ptr()
    if counts is None:
        COMPOSITE_DENSE_FWD(attrs.data_ptr(), T, K, ntx, tile, out.data_ptr(),
                            n_contrib.data_ptr(), cp, stream_ptr(dev))
    else:
        COMPOSITE_DYN_FWD(counts.data_ptr(), attrs.data_ptr(), T, K, ntx,
                          tile, out.data_ptr(), n_contrib.data_ptr(), cp,
                          stream_ptr(dev))
    return out, n_contrib


def composite_dense_fwd(counts, attrs: torch.Tensor, ntx: int, tile: int):
    """Composite each tile's dense block of depth-sorted splats: kernel K4a
    when counts is None (all K slots), K4b when counts (T,) int32 is given
    (tile t's first counts[t] slots, clamped to [0, K]; the rest are
    ignored and get zero gradient).

    attrs (T, 16, K) float32, rows as composite_fwd's attr (rows 10-15
    unused); tiles row-major with ntx per row, tile x tile pixels each.
    Returns (out (T, 8, tile^2) float32, n_contrib (T, tile^2) int32), as
    composite_fwd.
    """
    _check_dense(counts, attrs, tile)
    if not on_cuda(attrs.device):
        return composite_dense_fwd_plain(counts, attrs, ntx, tile)
    return _launch_dense_fwd(counts, attrs, ntx, tile, None)


def composite_dense_fwd_counts(counts, attrs: torch.Tensor, ntx: int,
                               tile: int):
    """K4a/K4b's forward on the card as composite_dense_fwd, also reading
    what it did (a host sync; for measurement): (out, n_contrib, stats),
    stats {"evaluated", "culled"} as composite_fwd_counts, modelled by
    composite_dense_fwd_cull_plain."""
    _check_dense(counts, attrs, tile)
    if not on_cuda(attrs.device):
        raise ValueError("composite_dense_fwd_counts reads the kernel's "
                         "counters: CUDA tensors only")
    counters = torch.zeros(2, dtype=torch.int64, device=attrs.device)
    out, n_contrib = _launch_dense_fwd(counts, attrs, ntx, tile, counters)
    evaluated, culled = counters.tolist()
    return out, n_contrib, dict(evaluated=evaluated, culled=culled)


def _check_dense_bwd(counts, attrs, out, n_contrib, g, tile):
    _check_dense(counts, attrs, tile)
    dev = attrs.device
    T, P = attrs.shape[0], tile * tile
    check_tensor("out", out, torch.float32, (T, 8, P), dev)
    check_tensor("n_contrib", n_contrib, torch.int32, (T, P), dev)
    check_tensor("g", g, torch.float32, (T, 8, P), dev)


def _launch_dense_bwd(counts, attrs, out, n_contrib, g, ntx, tile,
                      counters):
    dev = attrs.device
    T, _, K = attrs.shape
    d_attrs = torch.empty_like(attrs)
    cp = None if counters is None else counters.data_ptr()
    if counts is None:
        COMPOSITE_DENSE_BWD(attrs.data_ptr(), T, K, ntx, tile, out.data_ptr(),
                            n_contrib.data_ptr(), g.data_ptr(),
                            d_attrs.data_ptr(), cp, stream_ptr(dev))
    else:
        COMPOSITE_DYN_BWD(counts.data_ptr(), attrs.data_ptr(), T, K, ntx,
                          tile, out.data_ptr(), n_contrib.data_ptr(),
                          g.data_ptr(), d_attrs.data_ptr(), cp,
                          stream_ptr(dev))
    return d_attrs


def composite_dense_bwd(counts, attrs: torch.Tensor, out: torch.Tensor,
                        n_contrib: torch.Tensor, g: torch.Tensor, ntx: int,
                        tile: int) -> torch.Tensor:
    """Gradient of attrs (T, 16, K) from g (T, 8, P), the gradient of
    composite_dense_fwd's out (rows 0-4 read): kernel K4a's backward when
    counts is None, K4b's otherwise.  Rows 10-15 and slots outside the
    runs are zero.  Deterministic: no atomics."""
    _check_dense_bwd(counts, attrs, out, n_contrib, g, tile)
    if not on_cuda(attrs.device):
        return composite_dense_bwd_plain(counts, attrs, out, n_contrib, g,
                                         ntx, tile)
    return _launch_dense_bwd(counts, attrs, out, n_contrib, g, ntx, tile,
                             None)


def composite_dense_bwd_counts(counts, attrs: torch.Tensor,
                               out: torch.Tensor, n_contrib: torch.Tensor,
                               g: torch.Tensor, ntx: int, tile: int):
    """K4a/K4b's backward on the card as composite_dense_bwd, also reading
    what its walk did (a host sync; for measurement): (d_attrs, stats),
    stats {"walked", "culled"}: the (warp, rank) pairs below each warp's
    largest n_contrib that it walked, and those its rectangle test culled
    (composite_dense_bwd_ranks_plain)."""
    _check_dense_bwd(counts, attrs, out, n_contrib, g, tile)
    if not on_cuda(attrs.device):
        raise ValueError("composite_dense_bwd_counts reads the kernel's "
                         "counters: CUDA tensors only")
    counters = torch.zeros(2, dtype=torch.int64, device=attrs.device)
    d_attrs = _launch_dense_bwd(counts, attrs, out, n_contrib, g, ntx, tile,
                                counters)
    walked, culled = counters.tolist()
    return d_attrs, dict(walked=walked, culled=culled)


class _CompositeDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, counts, attrs, ntx, tile):
        out, n_contrib = composite_dense_fwd(counts, attrs, ntx, tile)
        ctx.save_for_backward(attrs, out, n_contrib)
        ctx.counts = counts
        ctx.geom = (ntx, tile)
        return out

    @staticmethod
    def backward(ctx, g):
        attrs, out, n_contrib = ctx.saved_tensors
        d_attrs = composite_dense_bwd(ctx.counts, attrs, out, n_contrib,
                                      g.contiguous(), *ctx.geom)
        return None, d_attrs, None, None


def _check_geometry(T, ntx, tile_px, K, attrs):
    if tuple(attrs.shape) != (T, 16, K):
        raise ValueError(f"attrs: shape {tuple(attrs.shape)}, expected "
                         f"{(T, 16, K)}")
    if ntx < 1 or T % ntx:
        raise ValueError(f"{T} tiles do not fill rows of {ntx}")


def make_composite(T: int, ntx: int, tile_px: int, K: int):
    """The dense tile compositor for a fixed geometry (kernel K4a):
    f(attrs (T, 16, K)) -> (T, 8, tile_px^2), every tile compositing all K
    slots; differentiable with respect to attrs (backward: K4a's)."""

    def composite_dense(attrs: torch.Tensor) -> torch.Tensor:
        _check_geometry(T, ntx, tile_px, K, attrs)
        return _CompositeDense.apply(None, attrs, ntx, tile_px)

    return composite_dense


def make_composite_dyn(T: int, ntx: int, tile_px: int, K: int):
    """The dense tile compositor with per-tile counts (kernel K4b):
    f(counts (T,) int32, attrs (T, 16, K)) -> (T, 8, tile_px^2), tile t
    compositing its first counts[t] slots.  Slots past counts[t] are
    ignored and get zero gradient; counts are clamped to [0, K]."""

    def composite_dyn(counts: torch.Tensor,
                      attrs: torch.Tensor) -> torch.Tensor:
        _check_geometry(T, ntx, tile_px, K, attrs)
        return _CompositeDense.apply(counts, attrs, ntx, tile_px)

    return composite_dyn
