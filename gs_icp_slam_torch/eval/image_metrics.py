"""Full-sequence rendering metrics (counterpart of
gs_icp_slam_tpu/eval/image_metrics.py): the reference's calc_2d_metric
(mp_Mapper.py:335-420) and offline metrics.py evaluate() as one runner.

For every (strided) frame: render the final map at the tracker's final
pose, then
  * PSNR masked by gt_depth > 0 (mp_Mapper.py:388-393 semantics: the
    prediction and gt are zeroed outside the mask and the MSE mean runs
    over the mask only),
  * SSIM (11x11 Gaussian window, utils/losses.py),
  * LPIPS where weights are available (eval/lpips.py).

Returns means and per-frame arrays, and can dump side-by-side PNG
comparisons like the reference's matplotlib dumps (mp_Mapper.py:400-411).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.losses import ssim as ssim_fn
from .lpips import lpips, lpips_available


@dataclass
class SequenceMetrics:
    psnr: float
    ssim: float
    lpips: Optional[float]
    per_frame_psnr: np.ndarray
    per_frame_ssim: np.ndarray
    per_frame_lpips: Optional[np.ndarray]

    def summary(self) -> str:
        lp = f"{self.lpips:.4f}" if self.lpips is not None else "n/a"
        return (f"PSNR: {self.psnr:.3f} dB  SSIM: {self.ssim:.4f}  "
                f"LPIPS: {lp}")


def _masked_psnr(pred, gt_img, gt_depth) -> torch.Tensor:
    mask = (gt_depth > 0.0)[None]
    mse = torch.sum(((pred - gt_img) * mask) ** 2) / torch.clamp(
        mask.sum() * 3.0, min=1.0)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def _ssim_val(pred, gt_img) -> torch.Tensor:
    return ssim_fn(pred, gt_img)[1]


@torch.no_grad()
def evaluate_sequence(render_frame: Callable[[int], torch.Tensor],
                      dataset, n: int, stride: int = 1,
                      depth_scale: float = 1.0,
                      dump_dir: Optional[str] = None,
                      dump_every: int = 100,
                      with_lpips: bool = True) -> SequenceMetrics:
    """render_frame(i) -> (3, H, W) float prediction for frame i; the
    ground truth goes to the prediction's device."""
    use_lpips = with_lpips and lpips_available()
    psnrs, ssims, lps = [], [], []
    for i in range(0, n, stride):
        fr = dataset[i]
        pred = render_frame(i)
        gt_img = torch.from_numpy(np.ascontiguousarray(
            fr.rgb.transpose(2, 0, 1))).to(pred.device, torch.float32) / 255.0
        gt_depth = torch.from_numpy(np.asarray(fr.depth)).to(
            pred.device, torch.float32) / depth_scale
        psnrs.append(float(_masked_psnr(pred, gt_img, gt_depth)))
        ssims.append(float(_ssim_val(pred, gt_img)))
        if use_lpips:
            lps.append(float(lpips(pred, gt_img)[0]))
        if dump_dir and (i % dump_every == 0):
            _dump_compare(dump_dir, i, pred, gt_img)
    per_psnr = np.asarray(psnrs)
    per_ssim = np.asarray(ssims)
    per_lp = np.asarray(lps) if use_lpips else None
    return SequenceMetrics(
        psnr=float(per_psnr.mean()), ssim=float(per_ssim.mean()),
        lpips=float(per_lp.mean()) if per_lp is not None else None,
        per_frame_psnr=per_psnr, per_frame_ssim=per_ssim,
        per_frame_lpips=per_lp)


def _dump_compare(dump_dir: str, i: int, pred, gt) -> None:
    """Side-by-side prediction|gt PNG (reference mp_Mapper.py:400-411),
    or .npy where PIL is missing."""
    os.makedirs(dump_dir, exist_ok=True)
    a = np.clip(pred.detach().cpu().numpy(), 0, 1)
    b = np.clip(gt.detach().cpu().numpy(), 0, 1)
    img = (np.concatenate([a, b], axis=2).transpose(1, 2, 0)
           * 255).astype(np.uint8)
    try:
        from PIL import Image
        Image.fromarray(img).save(os.path.join(dump_dir, f"frame_{i:06d}.png"))
    except Exception:
        np.save(os.path.join(dump_dir, f"frame_{i:06d}.npy"), img)
