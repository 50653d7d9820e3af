"""Deterministic image pairs for LPIPS golden-value validation
(counterpart of gs_icp_slam_tpu/eval/lpips_fixtures.py; the same bytes).

The pairs come from closed-form math (no RNG, no platform-dependent
operations beyond float32 arithmetic), so that LPIPS values computed with
the official `lpips` package on another machine can be checked against
this package's LPIPS with converted weights.
"""
from __future__ import annotations

import numpy as np

H = W = 64


def _grid():
    y = np.arange(H, dtype=np.float32)[:, None] / (H - 1)
    x = np.arange(W, dtype=np.float32)[None, :] / (W - 1)
    return (np.broadcast_to(y, (H, W)).astype(np.float32),
            np.broadcast_to(x, (H, W)).astype(np.float32))


def fixture_pair(name: str):
    """Return (img_a, img_b), each (3, H, W) float32 in [0, 1]."""
    y, x = _grid()
    if name == "gradient_vs_checker":
        a = np.stack([x, y, 0.5 * (x + y)])
        checker = 0.15 * (((np.floor(y * 8) + np.floor(x * 8)) % 2)
                          .astype(np.float32))
        b = np.clip(a + checker[None], 0.0, 1.0)
    elif name == "rings_vs_shifted":
        r = np.sqrt((y - 0.5) ** 2 + (x - 0.5) ** 2)
        a = np.stack([0.5 + 0.5 * np.sin(20 * r),
                      0.5 + 0.5 * np.cos(20 * r),
                      np.clip(2 * r, 0, 1)]).astype(np.float32)
        r2 = np.sqrt((y - 0.4) ** 2 + (x - 0.6) ** 2)
        b = np.stack([0.5 + 0.5 * np.sin(20 * r2),
                      0.5 + 0.5 * np.cos(20 * r2),
                      np.clip(2 * r2, 0, 1)]).astype(np.float32)
    elif name == "flat_vs_edge":
        a = np.full((3, H, W), 0.4, np.float32)
        b = a.copy()
        b[:, :, W // 2:] = 0.6
    else:
        raise KeyError(name)
    return a.astype(np.float32), b.astype(np.float32)


FIXTURE_NAMES = ("gradient_vs_checker", "rings_vs_shifted", "flat_vs_edge")
