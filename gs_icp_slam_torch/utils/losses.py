"""Mapping losses: depth-masked L1 and SSIM, plus PSNR (counterpart of
gs_icp_slam_tpu/utils/losses.py).

Semantics match the reference (utils/loss_utils.py:17-69,
utils/image_utils.py:17-19):
  * l1: |x-y| zeroed where gt == 0, then the mean over ALL elements (the
    mask does not renormalize the mean);
  * ssim: prediction zeroed where gt == 0, 11x11 Gaussian window sigma
    1.5, per-channel, SAME zero padding (the window truncated at the
    border).
Images are channels-first (C, H, W).  The separable blur is two depthwise
conv2d passes over the five blurred maps stacked as channels; the package
turns cuDNN's TF32 off, so it runs in float32.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def l1_masked(pred: torch.Tensor, gt: torch.Tensor):
    """Masked L1.  Returns (per-element map, scalar mean over all
    elements)."""
    diff = torch.where(gt != 0.0, torch.abs(pred - gt), 0.0)
    return diff, diff.mean()


def l2_masked(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.where(gt != 0.0, (pred - gt) ** 2, 0.0).mean()


@lru_cache(maxsize=None)
def _gaussian_1d(window_size: int, sigma: float,
                 device: torch.device) -> torch.Tensor:
    """The normalised window, uploaded once per device and kept: a
    captured CUDA graph reads it by address (slam/fused.py OptGraph)."""
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma**2))
    return torch.as_tensor((g / g.sum()).astype(np.float32), device=device)


def _blur(img: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (C, H, W), zero padded (SAME)."""
    C = img.shape[0]
    k = window_size // 2
    g = _gaussian_1d(window_size, sigma, img.device)
    x = F.conv2d(img[None], g.view(1, 1, -1, 1).expand(C, 1, -1, 1),
                 padding=(k, 0), groups=C)
    x = F.conv2d(x, g.view(1, 1, 1, -1).expand(C, 1, 1, -1),
                 padding=(0, k), groups=C)
    return x[0]


def ssim(img: torch.Tensor, gt: torch.Tensor, window_size: int = 11):
    """SSIM with the reference's masking; img/gt are (C, H, W) in [0, 1].
    Returns (ssim_map, scalar mean)."""
    img = torch.where(gt != 0.0, img, 0.0)
    C = img.shape[0]
    stats = _blur(torch.cat([img, gt, img * img, gt * gt, img * gt]),
                  window_size, 1.5)
    mu1, mu2, b11, b22, b12 = stats.split(C)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = b11 - mu1_sq
    sigma2_sq = b22 - mu2_sq
    sigma12 = b12 - mu1_mu2

    c1 = 0.01**2
    c2 = 0.03**2
    ssim_map = ((2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map, ssim_map.mean()


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """PSNR over the full image (values in [0, 1])."""
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def mse_to_psnr(mse: torch.Tensor) -> torch.Tensor:
    """Reference mp_Mapper.mse2psnr (mp_Mapper.py:422-423)."""
    return -10.0 * torch.log(mse) / math.log(10.0)


def mapping_loss(image, depth, gt_image, gt_depth, lambda_dssim: float = 0.2,
                 depth_weight: float = 0.1, d_max: float = 10.0):
    """The reference mapper's loss (mp_Mapper.py:225-240): gt_image is
    masked by gt_depth > 0; L1 and SSIM mask internally on gt == 0; the
    depth term is L1 on depth / d_max, weighted by depth_weight.  Returns
    (scalar loss, {"l1", "ssim", "l1_depth"})."""
    mask = (gt_depth > 0.0).to(image.dtype)
    gt_image = gt_image * mask
    _, l1 = l1_masked(image, gt_image)
    _, ssim_val = ssim(image, gt_image)
    _, l1_d = l1_masked(depth / d_max, gt_depth / d_max)
    loss_rgb = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim_val)
    loss = loss_rgb + depth_weight * l1_d
    return loss, {"l1": l1, "ssim": ssim_val, "l1_depth": l1_d}
