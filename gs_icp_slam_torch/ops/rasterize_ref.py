"""Dense reference renderer: every pixel composites every Gaussian
(counterpart of gs_icp_slam_tpu/ops/rasterize_ref.py).

O(N * H * W): for tests, gradient checks and tiny scenes only.  The tiled
renderer (ops/rasterize.py) must agree with this one to float tolerance;
this one skips binning entirely: it sorts ALL Gaussians by depth once and
composites each pixel by an exclusive cumulative product.  Differentiable
with autograd.

The semantics of the CUDA rasterizer it stands in for:
  * a splat covers only pixels whose TILE lies inside its (clamped)
    3-sigma tile rect, so splat tails beyond the rect are cut even where
    alpha would still exceed 1/255
  * alpha = min(0.99, opacity * exp(-0.5 d^T conic d)), zeroed when the
    exponent is positive or alpha < 1/255
  * front-to-back order by camera z
  * compositing stops once transmittance would drop below 1e-4
  * color += T_final * background; depth composites like colour with NO
    background term (the fork's added depth channel)
"""
from __future__ import annotations

import torch

from .projection import (ALPHA_MAX, ALPHA_MIN, T_EPS, Splats2D,
                         project_gaussians, tile_rect)


def composite_pixels(pix_xy: torch.Tensor, splats: Splats2D,
                     order: torch.Tensor, bg: torch.Tensor, rects=None,
                     tile: int = 16):
    """Alpha-composite depth-ordered splats at the given pixel centres.

    pix_xy (P, 2) pixel coordinates; splats the preprocessed Gaussians (N);
    order (N,) indices front to back, invisible splats at the end; bg (3,)
    background; rects, optional (tx0, ty0, tx1, ty1) tile rects per splat
    (pre-sort order): a splat covers a pixel only if the pixel's tile lies
    inside its rect, the CUDA binning cutoff.  Returns colour (P, 3), depth
    (P,), final transmittance (P,) and contributed (N,) bool, whether each
    splat touched any pixel."""
    mean2d = splats.mean2d[order]
    conic = splats.conic[order]
    rgb = splats.rgb[order]
    opa = splats.opacity[order]
    depth = splats.depth[order]
    vis = splats.visible[order]

    d = pix_xy[:, None, :] - mean2d[None, :, :]  # (P, N, 2)
    power = -0.5 * (conic[None, :, 0] * d[..., 0] ** 2
                    + conic[None, :, 2] * d[..., 1] ** 2) \
        - conic[None, :, 1] * d[..., 0] * d[..., 1]
    e = opa[None, :] * torch.exp(power)
    alpha = torch.minimum(e, e.new_tensor(ALPHA_MAX))
    covered = (power <= 0.0) & (alpha >= ALPHA_MIN) & vis[None, :]
    if rects is not None:
        tx0, ty0, tx1, ty1 = (r[order] for r in rects)
        ptx = torch.floor(pix_xy[:, 0] / tile)[:, None]
        pty = torch.floor(pix_xy[:, 1] / tile)[:, None]
        covered = covered & (ptx >= tx0[None]) & (ptx <= tx1[None]) \
            & (pty >= ty0[None]) & (pty <= ty1[None])
    alpha = torch.where(covered, alpha, 0.0)

    one_minus = 1.0 - alpha
    t_next = torch.cumprod(one_minus, dim=1)  # T after including k
    t_before = torch.cat([torch.ones_like(t_next[:, :1]), t_next[:, :-1]],
                         dim=1)
    include = t_next >= T_EPS  # CUDA stops BEFORE the splat that crosses
    w = alpha * t_before * include

    t_final = torch.where(include, one_minus, 1.0).prod(dim=1)
    color = w @ rgb + t_final[:, None] * bg[None]
    depth_out = w @ depth
    contributed_sorted = (w > 0.0).any(dim=0)
    contributed = torch.zeros_like(contributed_sorted)
    contributed[order] = contributed_sorted
    return color, depth_out, t_final, contributed


def rasterize_dense(xyz, quat, scale, opacity, sh, sh_degree: int, w2c, fx,
                    fy, cx, cy, width: int, height: int, live, bg,
                    tile: int = 16, tile_span: int = 1_000):
    """Render a full image densely.  Returns the fork's 4-output contract
    (gaussian_renderer/__init__.py:86-94): (color (3, H, W), depth (H, W),
    radii (N,), is_used (N,)).  tile/tile_span set the CUDA-style tile
    rect cutoff; the default span is effectively unclamped (the pure
    getRect behaviour); pass the tiled renderer's span to reproduce its
    truncation."""
    splats = project_gaussians(xyz, quat, scale, opacity, sh, sh_degree,
                               w2c, fx, fy, cx, cy, width, height, live)
    ntx = -(-width // tile)
    nty = -(-height // tile)
    rects = tile_rect(splats.mean2d[:, 0], splats.mean2d[:, 1],
                      splats.radius.to(torch.float32), ntx, nty, tile,
                      tile_span)
    # front to back: invisible splats to the back via +inf depth
    key = torch.where(splats.visible, splats.depth, torch.inf)
    order = torch.argsort(key, stable=True)

    dev = xyz.device
    gy, gx = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                         device=dev),
                            torch.arange(width, dtype=torch.float32,
                                         device=dev), indexing="ij")
    pix = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)

    color, depth, _, contributed = composite_pixels(pix, splats, order, bg,
                                                    rects=rects, tile=tile)
    color = color.reshape(height, width, 3).permute(2, 0, 1)
    depth = depth.reshape(height, width)
    return color, depth, splats.radius, contributed
