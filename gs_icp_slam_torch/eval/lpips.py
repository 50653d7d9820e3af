"""LPIPS, AlexNet and VGG16 variants (counterpart of
gs_icp_slam_tpu/eval/lpips.py).

The reference evaluates LPIPS twice: in-process with torchmetrics' alex
variant (mp_Mapper.py:19,340) and offline with a bundled lpipsPyTorch vgg
variant (metrics.py:74).  Both are the same computation: a conv feature
trunk, per-layer unit-normalized feature differences, non-negative 1x1
linear calibration heads, spatial mean, layer sum.  The trunk is
torch.nn.functional.conv2d / max_pool2d, as the JAX package's is lax.conv
(the package turns cuDNN's TF32 off, so it runs in float32).

Weights: none are shipped.  Provide them as an .npz via the `weights`
argument, the GS_LPIPS_WEIGHTS environment variable, or a file
lpips_alex.npz / lpips_vgg.npz next to this module, in the JAX package's
format (its tools/convert_lpips_weights.py writes it).  Without weights,
`lpips_available()` is False and evaluation reports LPIPS as None.
LPIPS(x, x) == 0 holds for any weights (the metric is a norm of feature
differences).
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# Feature trunks (torchvision layout): per conv (out_c, in_c, k, stride,
# pad); pool_after = conv indices followed by a maxpool; taps = conv
# indices whose relu output feeds a calibration head.
_NETS = {
    "alex": dict(
        convs=[(64, 3, 11, 4, 2), (192, 64, 5, 1, 2), (384, 192, 3, 1, 1),
               (256, 384, 3, 1, 1), (256, 256, 3, 1, 1)],
        pool_after={0, 1},
        pool=(3, 2),  # kernel 3 stride 2
        taps=(0, 1, 2, 3, 4),
    ),
    # VGG16 features through relu5_3 (lpipsPyTorch/modules/networks.py
    # taps relu1_2, 2_2, 3_3, 4_3, 5_3, the standard LPIPS-vgg trunk)
    "vgg": dict(
        convs=[(64, 3, 3, 1, 1), (64, 64, 3, 1, 1),
               (128, 64, 3, 1, 1), (128, 128, 3, 1, 1),
               (256, 128, 3, 1, 1), (256, 256, 3, 1, 1),
               (256, 256, 3, 1, 1),
               (512, 256, 3, 1, 1), (512, 512, 3, 1, 1),
               (512, 512, 3, 1, 1),
               (512, 512, 3, 1, 1), (512, 512, 3, 1, 1),
               (512, 512, 3, 1, 1)],
        pool_after={1, 3, 6, 9},
        pool=(2, 2),
        taps=(1, 3, 6, 9, 12),
    ),
}

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def default_weights_path() -> Optional[str]:
    p = os.environ.get("GS_LPIPS_WEIGHTS")
    if p and os.path.exists(p):
        return p
    here = os.path.dirname(__file__)
    for name in ("lpips_alex.npz", "lpips_vgg.npz"):
        cand = os.path.join(here, name)
        if os.path.exists(cand):
            return cand
    return None


def lpips_available() -> bool:
    return default_weights_path() is not None


@lru_cache(maxsize=2)
def _load_weights(path: str, device: torch.device):
    z = np.load(path)
    net = str(z["net"]) if "net" in z.files else "alex"
    spec = _NETS[net]
    n = len(spec["convs"])
    convs = [(torch.as_tensor(z[f"conv{i}.weight"], device=device),
              torch.as_tensor(z[f"conv{i}.bias"], device=device))
             for i in range(n)]
    lins = [torch.as_tensor(z[f"lin{i}.weight"], device=device).reshape(-1)
            for i in range(len(spec["taps"]))]
    for i, (w, _) in enumerate(convs):  # schema validation
        oc, ic, k, _, _ = spec["convs"][i]
        assert tuple(w.shape) == (oc, ic, k, k), (
            f"conv{i}.weight shape {tuple(w.shape)} != {(oc, ic, k, k)} "
            f"for net={net}")
    return net, convs, lins


def _features(x, convs, spec):
    """x (N, 3, H, W) in [-1, 1] -> relu feature maps at the tap layers."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    x = (x - shift) / scale
    taps = set(spec["taps"])
    pk, ps = spec["pool"]
    feats = []
    for i, ((w, b), (_, _, _, stride, pad)) in enumerate(
            zip(convs, spec["convs"])):
        x = torch.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
        if i in taps:
            feats.append(x)
        if i in spec["pool_after"]:
            x = F.max_pool2d(x, pk, ps)
    return feats


def _unit_normalize(f, eps=1e-10):
    n = torch.sqrt(torch.sum(f * f, dim=1, keepdim=True))
    return f / (n + eps)


def lpips(img0: torch.Tensor, img1: torch.Tensor,
          weights: Optional[str] = None) -> torch.Tensor:
    """LPIPS distance between (3, H, W) or (N, 3, H, W) images in [0, 1];
    returns (N,).  Raises FileNotFoundError if no weights file is available
    (see the module docstring): a random-weight LPIPS is not a meaningful
    metric."""
    path = weights or default_weights_path()
    if path is None:
        raise FileNotFoundError(
            "LPIPS weights not found: set GS_LPIPS_WEIGHTS or place "
            "lpips_alex.npz / lpips_vgg.npz next to eval/lpips.py")
    net, convs, lins = _load_weights(path, img0.device)
    spec = _NETS[net]
    if img0.ndim == 3:
        img0, img1 = img0[None], img1[None]
    f0 = _features(img0 * 2.0 - 1.0, convs, spec)
    f1 = _features(img1 * 2.0 - 1.0, convs, spec)
    total = 0.0
    for a, b, lw in zip(f0, f1, lins):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2   # (N, C, H, W)
        per_px = torch.einsum("nchw,c->nhw", d, lw)
        total = total + per_px.mean(dim=(1, 2))
    return total


def make_random_weights(path: str, seed: int = 0, net: str = "alex") -> None:
    """Write a RANDOM-weight npz in the exact file format, the same bytes
    as the JAX package's (for tests; not a perceptual metric)."""
    rng = np.random.default_rng(seed)
    spec = _NETS[net]
    out = {"net": np.asarray(net)}
    for i, (oc, ic, k, _, _) in enumerate(spec["convs"]):
        out[f"conv{i}.weight"] = rng.normal(
            0, 0.05, (oc, ic, k, k)).astype(np.float32)
        out[f"conv{i}.bias"] = np.zeros((oc,), np.float32)
    for j, i in enumerate(spec["taps"]):
        oc = spec["convs"][i][0]
        out[f"lin{j}.weight"] = np.abs(
            rng.normal(0, 0.01, (oc,))).astype(np.float32)
    np.savez(path, **out)
