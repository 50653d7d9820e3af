"""Plain PyTorch mapping for the reference: the tiled Gaussian rasterizer
(projection, the visible cap, the tile lists with their capacity, the
front-to-back compositor) and the mapper's loss.

A frozen copy of the port's plain path (gs_icp_slam_torch
ops/projection.py, ops/rasterize.py, the rank loop of
ops/composite_cuda.py and utils/losses.py at this repository's first
benchmark).  The compositor's backward is autograd through the forward
loop, not the hand-derived backward of the kernel.  It imports nothing of
the program; `q` rounds to the precision being checked.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import ident

C0 = 0.28209479177387814
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def tile_capacity(width, height, tile, span, visible_cap, max_per_tile):
    ntx, nty = -(-width // tile), -(-height // tile)
    est = (span ** 2) * visible_cap / float(ntx * nty)
    return min(max_per_tile, max(128, int(-(-est // 128)) * 128))


def _tile_rect(mx, my, radius, ntx, nty, tile, span):
    tx_min = torch.floor((mx - radius) / tile)
    tx_max = torch.floor((mx + radius) / tile)
    ty_min = torch.floor((my - radius) / tile)
    ty_max = torch.floor((my + radius) / tile)
    half = (span - 1) // 2
    ax = torch.where((tx_max - tx_min) <= span - 1, tx_min,
                     torch.maximum(tx_min, torch.floor(mx / tile) - half))
    ay = torch.where((ty_max - ty_min) <= span - 1, ty_min,
                     torch.maximum(ty_min, torch.floor(my / tile) - half))
    tx0 = torch.clamp(ax, 0, ntx - 1)
    ty0 = torch.clamp(ay, 0, nty - 1)
    tx1 = torch.clamp(torch.minimum(tx_max, tx0 + (span - 1)), max=ntx - 1)
    ty1 = torch.clamp(torch.minimum(ty_max, ty0 + (span - 1)), max=nty - 1)
    empty = radius <= 0.0
    return tx0, ty0, torch.where(empty, tx0 - 1.0, tx1), \
        torch.where(empty, ty0 - 1.0, ty1)


def _cst(c, x):
    return torch.tensor(c, dtype=x.dtype, device=x.device)


def project(xyz, quat, scale, opacity, f_dc, w2c, fx, fy, cx, cy, width,
            height, live, znear=0.2):
    """EWA splatting of N Gaussians (SH degree 0): attr (10, N) rows [mx,
    my, conic a, b, c, r, g, b, opacity, depth], radius (N,), visible."""
    R, tv = w2c[:3, :3], w2c[:3, 3]
    t = xyz @ R.T + tv
    tx_, ty_, z = t[:, 0], t[:, 1], t[:, 2]
    in_front = z > znear
    inv_z = 1.0 / torch.where(in_front, z, 1.0)
    mx = fx * tx_ * inv_z + cx
    my = fy * ty_ * inv_z + cy
    lim_x = 1.3 * (width / (2.0 * fx))
    lim_y = 1.3 * (height / (2.0 * fy))
    txz = torch.minimum(torch.maximum(tx_ * inv_z, _cst(-lim_x, z)),
                        _cst(lim_x, z))
    tyz = torch.minimum(torch.maximum(ty_ * inv_z, _cst(-lim_y, z)),
                        _cst(lim_y, z))
    n = torch.maximum(torch.sqrt(torch.sum(quat * quat, dim=-1)),
                      _cst(1e-12, z))
    x, y, zq, w = quat[:, 0] / n, quat[:, 1] / n, quat[:, 2] / n, \
        quat[:, 3] / n
    r00 = 1.0 - 2.0 * (y * y + zq * zq)
    r01 = 2.0 * (x * y - w * zq)
    r02 = 2.0 * (x * zq + w * y)
    r10 = 2.0 * (x * y + w * zq)
    r11 = 1.0 - 2.0 * (x * x + zq * zq)
    r12 = 2.0 * (y * zq - w * x)
    r20 = 2.0 * (x * zq - w * y)
    r21 = 2.0 * (y * zq + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    s0, s1, s2 = scale[:, 0] ** 2, scale[:, 1] ** 2, scale[:, 2] ** 2
    sxx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    sxy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    sxz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    syy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    syz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    szz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22

    def row(wa, wb, wc):
        return (wa * sxx + wb * sxy + wc * sxz, wa * sxy + wb * syy + wc * syz,
                wa * sxz + wb * syz + wc * szz)

    m00, m01, m02 = row(R[0, 0], R[0, 1], R[0, 2])
    m10, m11, m12 = row(R[1, 0], R[1, 1], R[1, 2])
    m20, m21, m22 = row(R[2, 0], R[2, 1], R[2, 2])
    a = m00 * R[0, 0] + m01 * R[0, 1] + m02 * R[0, 2]
    b = m00 * R[1, 0] + m01 * R[1, 1] + m02 * R[1, 2]
    c = m00 * R[2, 0] + m01 * R[2, 1] + m02 * R[2, 2]
    d = m10 * R[1, 0] + m11 * R[1, 1] + m12 * R[1, 2]
    e = m10 * R[2, 0] + m11 * R[2, 1] + m12 * R[2, 2]
    f = m20 * R[2, 0] + m21 * R[2, 1] + m22 * R[2, 2]
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z
    c00 = j00 * (j00 * a + j02 * c) + j02 * (j00 * c + j02 * f) + 0.3
    c01 = j11 * (j00 * b + j02 * e) + j12 * (j00 * c + j02 * f)
    c11 = j11 * (j11 * d + j12 * e) + j12 * (j11 * e + j12 * f) + 0.3
    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    mid = 0.5 * (c00 + c11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))
    on_screen = ((mx > -radius_f) & (mx < width + radius_f)
                 & (my > -radius_f) & (my < height + radius_f))
    visible = live & in_front & det_ok & on_screen
    radius = torch.where(visible, radius_f, 0.0).to(torch.int32)
    rgb = [torch.maximum(C0 * f_dc[:, j] + 0.5, _cst(0.0, z))
           for j in range(3)]
    attr = torch.stack([mx, my, c11 * inv_det, -c01 * inv_det,
                        c00 * inv_det, *rgb, opacity, z], dim=0)
    return attr, radius, visible


def composite(attr_runs, in_run, px, py, q=ident, chunk=32):
    """Front to back over each tile's run, the CUDA rasterizer's rules:
    a pair is skipped below ALPHA_MIN or at positive power, alpha clamps at
    ALPHA_MAX, and the splat that would take a pixel's transmittance under
    T_EPS and every later one are left out.  attr_runs (10, T, K), in_run
    (T, K), px / py (T, P).  `chunk` ranks at a time: the transmittance
    through a chunk by a cumulative product.  Returns (color (3, T, P),
    depth (T, P), final transmittance (T, P)), differentiable in
    attr_runs."""
    T, P = px.shape
    K = int(in_run.sum(1).max()) if in_run.numel() else 0
    f = dict(dtype=attr_runs.dtype, device=px.device)
    tr = torch.ones((T, P), **f)
    acc = [torch.zeros((T, P), **f) for _ in range(4)]
    done = torch.zeros((T, P), dtype=torch.bool, device=px.device)
    X, Y = px[..., None], py[..., None]
    for j0 in range(0, K, chunk):
        a = attr_runs[:, :, None, j0:j0 + chunk]              # (10, T, 1, c)
        c = a.shape[-1]
        live = in_run[:, None, j0:j0 + chunk] & ~done[..., None]
        dx = X - a[0]
        dy = Y - a[1]
        power = -0.5 * (a[2] * dx * dx + a[4] * dy * dy) - a[3] * dx * dy
        araw = q(a[8] * torch.exp(torch.clamp(power, min=-80.0)))
        gate = (power <= 0.0) & (araw >= ALPHA_MIN) & live
        alpha = torch.where(gate, torch.clamp(araw, max=ALPHA_MAX), 0.0)
        cp = torch.cumprod(1.0 - alpha, dim=-1)
        t_before = q(tr[..., None] * torch.cat(
            [torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1))
        t_after = q(tr[..., None] * cp)
        stop = gate & (t_after < T_EPS)
        stopped = stop.any(-1)
        first = torch.where(stopped, torch.argmax(stop.to(torch.int8), -1), c)
        inc = gate & (torch.arange(c, device=px.device) < first[..., None])
        w = torch.where(inc, alpha * t_before, 0.0)
        for k, r in enumerate((5, 6, 7, 9)):
            acc[k] = q(acc[k] + (w * a[r]).sum(-1))
        tr = torch.where(stopped, torch.gather(
            t_before, -1, first.clamp(max=c - 1)[..., None])[..., 0],
            t_after[..., -1])
        done = done | stopped
    return torch.stack(acc[:3]), acc[3], tr


class View:
    """One view binned for the compositor: the runs of each tile (10, T,
    K), differentiable in the projected attributes, and their pixels."""

    def __init__(self, runs, in_run, px, py, geom, stats):
        self.runs, self.in_run, self.px, self.py = runs, in_run, px, py
        self.geom, self.stats = geom, stats

    def _untile(self, x):                                     # (C, T, P)
        ntx, nty, tile, width, height = self.geom
        C = x.shape[0]
        x = x.reshape(C, nty, ntx, tile, tile).permute(0, 1, 3, 2, 4)
        return x.reshape(C, nty * tile, ntx * tile)[:, :height, :width]

    def _tiled(self, img):                                    # (C, H, W)
        ntx, nty, tile, width, height = self.geom
        C = img.shape[0]
        full = torch.zeros((C, nty * tile, ntx * tile), dtype=img.dtype,
                           device=img.device)
        full[:, :height, :width] = img
        x = full.reshape(C, nty, tile, ntx, tile).permute(0, 1, 3, 2, 4)
        return x.reshape(C, nty * ntx, tile * tile)

    def render(self, bg, q=ident, tiles=None):
        """(color (3, H, W) with the background through the final
        transmittance, depth (H, W)); with `tiles`, only those tiles' (3,
        t, P) colour and (t, P) depth."""
        sel = slice(None) if tiles is None else tiles
        c, d, t = composite(self.runs[:, sel], self.in_run[sel],
                            self.px[sel], self.py[sel], q)
        c = c + t[None] * bg[:, None, None]
        if tiles is not None:
            return c, d
        return self._untile(c), self._untile(d[None])[0]

    def backward(self, d_color, d_depth, bg, q=ident, budget=2 ** 28):
        """Send d loss / d(color, depth) of the whole image back through
        the compositor block of tiles by block (each block's forward again
        under autograd, about `budget` pixel-rank pairs a block), then
        through the projection."""
        gc, gd = self._tiled(d_color), self._tiled(d_depth[None])[0]
        runs = self.runs.detach()
        g_runs = torch.zeros_like(runs)
        T = runs.shape[1]
        K = max(int(self.in_run.sum(1).max()), 1)
        block = max(1, budget // (K * self.px.shape[1]))
        for s in range(0, T, block):
            blk = slice(s, min(s + block, T))
            r = runs[:, blk].clone().requires_grad_(True)
            c, d, t = composite(r, self.in_run[blk], self.px[blk],
                                self.py[blk], q)
            if not d.requires_grad:
                continue                  # no splat in these tiles
            c = c + t[None] * bg[:, None, None]
            torch.autograd.backward([c, d], [gc[:, blk], gd[blk]])
            g_runs[:, blk] = r.grad
        self.runs.backward(g_runs)


def bin_view(xyz, quat, scale, opacity, f_dc, w2c, live, fx, fy, cx, cy,
             width, height, tile, span, visible_cap, tile_cap, q=ident):
    """Projection, the front-most visible_cap visible splats in depth
    order, each in the tiles of its span x span rect, each tile's run cut
    to its front-most tile_cap: a View, stats [visible, visible-cap drops,
    tile-cap drops]."""
    ntx, nty = -(-width // tile), -(-height // tile)
    T = ntx * nty
    N = xyz.shape[0]
    V = min(visible_cap, N)
    dev = xyz.device
    attr, radius_i, visible = project(xyz, quat, scale, opacity, f_dc, w2c,
                                      fx, fy, cx, cy, width, height, live)
    attr = q(attr)
    vcount = visible.sum()
    order = torch.sort(torch.where(visible, attr[9].detach(), torch.inf),
                       stable=True).indices[:V]
    vok = torch.arange(V, device=dev) < torch.clamp(vcount, max=V)
    attr_v = attr[:, order]
    radius = torch.where(vok, radius_i[order], 0).to(torch.float32)
    tx0, ty0, tx1, ty1 = _tile_rect(attr_v[0].detach(), attr_v[1].detach(),
                                    radius, ntx, nty, tile, span)
    dd = torch.arange(span * span, device=dev)
    gx = tx0[None] + (dd % span).to(torch.float32)[:, None]
    gy = ty0[None] + (dd // span).to(torch.float32)[:, None]
    ok = (gx <= tx1[None]) & (gy <= ty1[None]) & vok[None]
    tile_id = (gy * ntx + gx).to(torch.int64)
    slot = torch.arange(V, device=dev).expand(span * span, V)
    key = torch.where(ok, tile_id * (V + 1) + slot, T * (V + 1)).reshape(-1)
    key_s = torch.sort(key).values
    key_s = key_s[key_s < T * (V + 1)]
    t_of = key_s // (V + 1)
    s_of = key_s % (V + 1)
    run = torch.bincount(t_of, minlength=T)
    start = torch.cumsum(run, 0) - run
    rank = torch.arange(key_s.shape[0], device=dev) - start[t_of]
    keep = rank < tile_cap
    K = int(torch.clamp(run, max=tile_cap).max()) if key_s.numel() else 0
    cols = torch.full((T, max(K, 1)), V, dtype=torch.int64, device=dev)
    cols[t_of[keep], rank[keep]] = s_of[keep]
    attr_pad = torch.cat([attr_v, torch.zeros((10, 1), dtype=attr_v.dtype,
                                              device=dev)], dim=1)
    pid = torch.arange(tile * tile, device=dev)
    tid = torch.arange(T, device=dev)
    px = (((tid % ntx) * tile)[:, None] + (pid % tile)[None]).to(attr.dtype)
    py = (((tid // ntx) * tile)[:, None] + (pid // tile)[None]).to(attr.dtype)
    stats = [int(vcount), int(torch.clamp(vcount - V, min=0)),
             int((run - torch.clamp(run, max=tile_cap)).sum())]
    return View(attr_pad[:, cols], cols < V, px, py,
                (ntx, nty, tile, width, height), stats)


# ------------------------------------------------------------------- loss --

def _window(size, sigma, device):
    xs = np.arange(size)
    g = np.exp(-((xs - size // 2) ** 2) / (2.0 * sigma ** 2))
    return torch.as_tensor((g / g.sum()).astype(np.float32), device=device)


def _blur(img, size=11, sigma=1.5):
    C, k = img.shape[0], size // 2
    g = _window(size, sigma, img.device).to(img.dtype)
    x = F.conv2d(img[None], g.view(1, 1, -1, 1).expand(C, 1, -1, 1),
                 padding=(k, 0), groups=C)
    x = F.conv2d(x, g.view(1, 1, 1, -1).expand(C, 1, 1, -1),
                 padding=(0, k), groups=C)
    return x[0]


def ssim(img, gt):
    img = torch.where(gt != 0.0, img, 0.0)
    C = img.shape[0]
    mu1, mu2, b11, b22, b12 = _blur(torch.cat(
        [img, gt, img * img, gt * gt, img * gt])).split(C)
    s1 = b11 - mu1 * mu1
    s2 = b22 - mu2 * mu2
    s12 = b12 - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2.0 * mu1 * mu2 + c1) * (2.0 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return m.mean()


def mapping_loss(color, depth, gt_img, gt_depth, o):
    """(1 - l) L1 + l (1 - SSIM) on depth-masked colour, plus the weighted
    L1 of depth / d_max, L1 means over all elements (the reference
    mapper's loss)."""
    mask = (gt_depth > 0.0).to(color.dtype)
    gt_img = gt_img * mask
    l1 = torch.where(gt_img != 0.0, torch.abs(color - gt_img), 0.0).mean()
    gd = gt_depth / o["depth_d_max"]
    l1_d = torch.where(gd != 0.0, torch.abs(depth / o["depth_d_max"] - gd),
                       0.0).mean()
    lam = o["lambda_dssim"]
    return ((1.0 - lam) * l1 + lam * (1.0 - ssim(color, gt_img))
            + o["depth_loss_weight"] * l1_d)

