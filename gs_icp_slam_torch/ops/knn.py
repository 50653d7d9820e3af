"""Neighbour search (counterpart of gs_icp_slam_tpu/ops/knn.py).

  nn_search       : masked 1-NN, through kernel K2 (ops.nn_cuda)
  knn_search      : exact k-NN, through kernel K3 (ops.nn_cuda)
  knn_search_grid : k-NN inside an image-grid window of the pixel-grid
                    source cloud, plain PyTorch (plain XLA in JAX too)
"""
from __future__ import annotations

import torch

from .nn_cuda import knn_search_kernel, nn_search_pre, prepare_refs

_BIG = 3.4e38


def nn_search(query: torch.Tensor, ref: torch.Tensor,
              ref_valid: torch.Tensor):
    """1-NN of each query (Q, 3) among the valid refs (R, 3): idx (Q,)
    int32 (0 when no ref is valid) and sqdist (Q,) (3.4e38 then)."""
    rT, bias = prepare_refs(ref, ref_valid)
    return nn_search_pre(query.contiguous(), rT, bias)


def knn_search(query: torch.Tensor, ref: torch.Tensor,
               ref_valid: torch.Tensor, k: int = 20):
    """k-NN of each query among the valid refs, self included when query is
    ref: idx (Q, k) int32 nearest first, sqd (Q, k) (3.4e38 where fewer than
    k valid refs exist)."""
    return knn_search_kernel(query.contiguous(), ref.contiguous(),
                             ref_valid.contiguous(), k)


def mean_sq_dist_3nn(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of each point to its 3 nearest neighbours (the
    simple-knn distCUDA2 used for vanilla-3DGS scale init)."""
    _, sqd = knn_search(points, points, valid, k=4)  # self + 3 NN
    s = sqd[:, 1:4]
    d = torch.where(torch.isfinite(s) & (s < 1e37), s, 0.0)
    return torch.where(valid, d.mean(dim=1), 0.0)


def resolve_grid_span(k: int, span: int = 0) -> int:
    """GICPConfig.grid_knn_span's auto sentinel (span <= 0): the smallest
    window holding >= ~2.4*k candidates, so the k-NN stays a selection."""
    if span > 0:
        return span
    span = 1
    while (2 * span + 1) ** 2 < 2.4 * k:
        span += 1
    return span


def knn_search_grid(points: torch.Tensor, valid: torch.Tensor, gh: int,
                    gw: int, k: int = 20, span: int = 2):
    """k-NN restricted to a (2*span+1)^2 image-grid window (span <= 0 =
    auto).  The source cloud is the row-major (gh*gw, 3) pixel-grid
    subsample, so a point's 3D neighbours on a smooth surface lie in a
    small window around it.  Candidates are ordered by (distance, window
    position), row-major over the window, as in the JAX version; missing
    candidates (frame border, invalid depth) come back as (self index,
    3.4e38).  Returns the knn_search contract (idx (S, k), sqd (S, k))."""
    span = resolve_grid_span(k, span)
    W = 2 * span + 1
    if k > W * W:
        raise ValueError(f"k={k} exceeds the {W}x{W} window")
    S = gh * gw
    dev = points.device
    pts_g = points.reshape(gh, gw, 3)
    pad_pts = torch.zeros((gh + 2 * span, gw + 2 * span, 3),
                          dtype=points.dtype, device=dev)
    pad_pts[span:span + gh, span:span + gw] = pts_g
    pad_ok = torch.zeros((gh + 2 * span, gw + 2 * span), dtype=torch.bool,
                         device=dev)
    pad_ok[span:span + gh, span:span + gw] = valid.reshape(gh, gw)
    pad_idx = torch.zeros((gh + 2 * span, gw + 2 * span), dtype=torch.int32,
                          device=dev)
    pad_idx[span:span + gh, span:span + gw] = torch.arange(
        S, dtype=torch.int32, device=dev).reshape(gh, gw)

    cand_d, cand_i = [], []
    for dy in range(W):
        for dx in range(W):
            q = pad_pts[dy:dy + gh, dx:dx + gw]
            ok = pad_ok[dy:dy + gh, dx:dx + gw]
            d2 = torch.sum((q - pts_g) ** 2, dim=-1)
            cand_d.append(torch.where(ok, d2, _BIG))
            cand_i.append(pad_idx[dy:dy + gh, dx:dx + gw])
    d2 = torch.stack(cand_d, dim=0).reshape(W * W, S)
    ci = torch.stack(cand_i, dim=0).reshape(W * W, S)
    # a stable sort over the window axis orders by (distance, position):
    # the JAX version's k passes of (min, lowest position)
    vals, order = torch.sort(d2, dim=0, stable=True)
    sqd = vals[:k].T.contiguous()
    idx = torch.gather(ci, 0, order[:k]).T
    self_i = torch.arange(S, dtype=torch.int32, device=dev)[:, None]
    return torch.where(sqd < _BIG, idx, self_i).contiguous(), sqd
