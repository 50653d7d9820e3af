"""Tiled differentiable Gaussian rasterizer (counterpart of
gs_icp_slam_tpu/ops/rasterize.py `rasterize_tiled`).

Stages, in order:
  1. project_gaussians_packed: (10, N) channel-first splat attributes;
  2. compaction of the front-most V visible splats by one stable depth
     sort (visible-cap overflow drops the farthest);
  3. the (D*D, V) tile pairs of each splat's clamped tile rect;
  4. one sort of the (tile << S) | slot keys: slots are depth ranks, so
     each tile's run comes out front to back; run starts by searchsorted,
     counts clamped to the front-most K; the sort's indices give each
     splat's pair rows (K1-bwd's splat -> pair-row map);
  5. the compositor, kernels K1-fwd / K1-bwd (ops.composite_cuda);
  6. the background blend through the final transmittance and the
     channel-first untiling;
  stats = [n_visible, vis_cap_dropped, tile_cap_dropped].

Differentiable with respect to xyz, quat, scale, opacity and sh: the
compositor is a torch.autograd.Function whose backward is K1-bwd, and
projection and the compaction gather attr[:, order] are plain autograd.
The sort and binning handle only integer keys, so the splat order is a
constant of the backward, as in the CUDA rasterizer.

Left behind from the JAX version (TPU mechanics): the power-of-two payload
windows and their padding, the _compact_cols custom VJP and the 16-row
payload.  The cell_idx inverse map survives as Binning.splat_rows, read
by K1-bwd's per-splat sum.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .composite_cuda import composite
from .projection import project_gaussians_packed, tile_rect


class RasterOut(NamedTuple):
    color: torch.Tensor    # (3, H, W)
    depth: torch.Tensor    # (H, W)
    radii: torch.Tensor    # (N,) int32
    t_final: torch.Tensor  # (H, W) final transmittance
    stats: torch.Tensor    # (3,) int64 [n_visible, vis_cap_dropped,
                           # tile_cap_dropped]


class Binning(NamedTuple):
    """The compositor's inputs for one view (stages 1-4)."""

    counts: torch.Tensor     # (T,) int32, clamped to K
    starts: torch.Tensor     # (T,) int32
    pair_slot: torch.Tensor  # (D*D*V,) int32 compacted slot per sorted pair
    attr_v: torch.Tensor     # (10, V+1) compacted attrs, last column zero
    radii: torch.Tensor      # (N,) int32
    stats: torch.Tensor      # (3,) int64
    splat_rows: torch.Tensor  # (D*D, V+1) int32 pair rows of each compacted
                              # splat inside the runs, -1 elsewhere


def tile_capacity(width: int, height: int, tile: int, tile_span: int,
                  visible_cap: int, max_per_tile: int) -> int:
    """Per-tile list capacity K from the expected pairs per tile
    (fused.py:111-125): each of <= V visible splats emits <= D^2 pairs, so
    the mean per tile is <= D^2 V / T; K is that, rounded up to 128, at
    least 128 and at most max_per_tile.  384 at 1200x680 with V = 65,536."""
    ntx = -(-width // tile)
    nty = -(-height // tile)
    est = (tile_span ** 2) * visible_cap / float(ntx * nty)
    return min(max_per_tile, max(128, int(-(-est // 128)) * 128))


def bin_splats(xyz, quat, scale, opacity, sh, w2c, live, fx, fy, cx, cy, *,
               sh_degree: int, width: int, height: int, tile: int = 16,
               visible_cap: int = 65536, tile_span: int = 3,
               tile_cap: int = 256) -> Binning:
    """Stages 1-4: projection, compaction and the tile-sorted pair table."""
    ntx = -(-width // tile)
    nty = -(-height // tile)
    T = ntx * nty
    N = xyz.shape[0]
    V = min(visible_cap, N)
    D = tile_span
    dev = xyz.device

    attr, radius_i, visible = project_gaussians_packed(
        xyz, quat, scale, opacity, sh, sh_degree, w2c, fx, fy, cx, cy,
        width, height, live)

    # ---- the front-most V visible splats, in depth order ------------------
    vcount = visible.sum()
    depth_key = torch.where(visible, attr[9], torch.inf)
    order = torch.sort(depth_key, stable=True).indices[:V]
    vslot = torch.arange(V, device=dev)
    vok = vslot < torch.clamp(vcount, max=V)
    attr_v = torch.cat([attr[:, order],
                        torch.zeros((10, 1), dtype=attr.dtype, device=dev)], 1)
    mx, my = attr_v[0, :V].detach(), attr_v[1, :V].detach()
    radius = torch.where(vok, radius_i[order], 0).to(torch.float32)

    # ---- (D*D, V) tile pairs ----------------------------------------------
    tx0, ty0, tx1, ty1 = tile_rect(mx, my, radius, ntx, nty, tile, D)
    dd = torch.arange(D * D, device=dev)
    gx = tx0[None] + (dd % D).to(torch.float32)[:, None]
    gy = ty0[None] + (dd // D).to(torch.float32)[:, None]
    pair_ok = (gx <= tx1[None]) & (gy <= ty1[None]) & vok[None]
    pair_tile = (gy * ntx + gx).to(torch.int64)

    # ---- one sort of (tile << S) | slot keys ------------------------------
    S = max(V - 1, 1).bit_length()
    sentinel = T << S  # sorts after every tile's run
    keys = torch.where(pair_ok, (pair_tile << S) | vslot[None], sentinel)
    key_s, perm = torch.sort(keys.reshape(-1))
    bounds = torch.arange(T + 1, device=dev, dtype=torch.int64) << S
    start = torch.searchsorted(key_s, bounds)
    run = start[1:] - start[:-1]
    counts = torch.clamp(run, max=tile_cap)
    pair_dropped = (run - counts).sum()
    pair_slot = (key_s & ((1 << S) - 1)).to(torch.int32)

    # ---- each splat's pair rows: the sorted position of each of its D*D
    # keys, kept where it lies in its tile's run (rank < counts) ----------
    row = torch.empty_like(perm)
    row[perm] = torch.arange(perm.shape[0], device=dev)
    row = row.reshape(D * D, V)
    tc = torch.clamp(pair_tile, 0, T - 1)
    in_run = pair_ok & (row - start[tc] < counts[tc])
    splat_rows = torch.full((D * D, V + 1), -1, dtype=torch.int32,
                            device=dev)
    splat_rows[:, :V] = torch.where(in_run, row, -1)

    stats = torch.stack([vcount, torch.clamp(vcount - V, min=0), pair_dropped])
    return Binning(counts=counts.to(torch.int32),
                   starts=start[:-1].to(torch.int32), pair_slot=pair_slot,
                   attr_v=attr_v.contiguous(), radii=radius_i, stats=stats,
                   splat_rows=splat_rows)


def _untile(x: torch.Tensor, nty: int, ntx: int, tile: int, height: int,
            width: int) -> torch.Tensor:
    """(T, C, P) -> (C, H, W)."""
    C = x.shape[1]
    x = x.reshape(nty, ntx, C, tile, tile).permute(2, 0, 3, 1, 4)
    return x.reshape(C, nty * tile, ntx * tile)[:, :height, :width]


def rasterize_tiled(xyz, quat, scale, opacity, sh, w2c, live, bg,
                    fx, fy, cx, cy, *, sh_degree: int, width: int,
                    height: int, tile: int = 16, visible_cap: int = 65536,
                    tile_span: int = 3, tile_cap: int = 256) -> RasterOut:
    """Render one view.  Args mirror project_gaussians_packed; bg is the
    (3,) background colour.  At most V = visible_cap splats are kept
    (front-most first), each enters at most tile_span^2 tile lists, and at
    most K = tile_cap composite per tile (front-most first); the stats
    report what each cap dropped."""
    ntx = -(-width // tile)
    nty = -(-height // tile)
    b = bin_splats(xyz, quat, scale, opacity, sh, w2c, live, fx, fy, cx, cy,
                   sh_degree=sh_degree, width=width, height=height,
                   tile=tile, visible_cap=visible_cap, tile_span=tile_span,
                   tile_cap=tile_cap)
    out8 = composite(b.counts, b.starts, b.pair_slot, b.attr_v, ntx, tile,
                     b.splat_rows)                               # (T, 8, P)
    tfin = out8[:, 4]
    color_px = out8[:, 0:3] + tfin[:, None, :] * bg.to(out8)[None, :, None]
    color = _untile(color_px, nty, ntx, tile, height, width)
    depth = _untile(out8[:, 3:4], nty, ntx, tile, height, width)[0]
    t_final = _untile(out8[:, 4:5], nty, ntx, tile, height, width)[0]
    return RasterOut(color=color, depth=depth, radii=b.radii,
                     t_final=t_final, stats=b.stats)
