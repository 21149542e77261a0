"""Training losses: (1 - λ) L1 + λ (1 - SSIM) + λ_depth scale/shift-
invariant depth, with λ = 0.2 and λ_depth = 0 by default.

Counterpart of `ht3dgs.train.losses` (single device; the sharded variants
are not ported yet). Images are channel-last [H, W, 3] in [0, 1].

Precision on the card: cuDNN runs float32 convolutions in TF32 unless told
otherwise, so the SSIM blur runs with `cudnn.allow_tf32 = False`. Float32
matrix products are full precision already
(`torch.backends.cuda.matmul.allow_tf32` defaults to False).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _depthwise_blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> separable depthwise Gaussian blur, zero padding."""
    C = x.shape[-1]
    k = window.shape[0]
    y = x.permute(2, 0, 1)[None]                                  # [1,C,H,W]
    y = F.conv2d(y, window.reshape(1, 1, 1, k).repeat(C, 1, 1, 1),
                 padding=(0, k // 2), groups=C)
    y = F.conv2d(y, window.reshape(1, 1, k, 1).repeat(C, 1, 1, 1),
                 padding=(k // 2, 0), groups=C)
    return y[0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two [H, W, C] images (11x11 Gaussian window, σ 1.5)."""
    w = torch.as_tensor(_gaussian_window(window_size), device=img1.device)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        mu1 = _depthwise_blur(img1, w)
        mu2 = _depthwise_blur(img2, w)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = _depthwise_blur(img1 * img1, w) - mu1_sq
        sigma2_sq = _depthwise_blur(img2 * img2, w) - mu2_sq
        sigma12 = _depthwise_blur(img1 * img2, w) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()


def l1_loss(pred, gt):
    return (pred - gt).abs().mean()


def compute_scale_and_shift(prediction, target, mask):
    """Least-squares (scale, shift) aligning prediction to target, [H, W]."""
    a00 = (mask * prediction * prediction).sum()
    a01 = (mask * prediction).sum()
    a11 = mask.sum()
    b0 = (mask * prediction * target).sum()
    b1 = (mask * target).sum()
    det = a00 * a11 - a01 * a01
    ok = det != 0.0
    det_safe = torch.where(ok, det, torch.ones_like(det))
    x0 = torch.where(ok, (a11 * b0 - a01 * b1) / det_safe, 0.0)
    x1 = torch.where(ok, (-a01 * b0 + a00 * b1) / det_safe, 0.0)
    return x0, x1


def _gradient_matching(diff, mask):
    gx = (diff[:, 1:] - diff[:, :-1]).abs() * (mask[:, 1:] * mask[:, :-1])
    gy = (diff[1:, :] - diff[:-1, :]).abs() * (mask[1:, :] * mask[:-1, :])
    denom = torch.clamp(mask.sum(), min=1.0)
    return (gx.sum() + gy.sum()) / denom


def scale_shift_invariant_depth_loss(depth_pred, depth_gt, mask=None,
                                     alpha: float = 0.5) -> torch.Tensor:
    """[H, W] depths; mask defaults to depth_gt > 0.02."""
    if mask is None:
        mask = (depth_gt > 0.02).to(depth_pred.dtype)
    s, t = compute_scale_and_shift(depth_pred, depth_gt, mask)
    res = s * depth_pred + t - depth_gt
    denom = torch.clamp(mask.sum(), min=1.0)
    data_term = (mask * res * res).sum() / (2.0 * denom)
    return data_term + alpha * _gradient_matching(mask * res, mask)


def compute_loss(image: torch.Tensor, gt_image: torch.Tensor,
                 lambda_dssim: float = 0.2, lambda_depth: float = 0.0,
                 depth_pred: Optional[torch.Tensor] = None,
                 depth_gt: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    zero = torch.zeros((), device=image.device)
    rgb_full = (1.0 - lambda_dssim) * l1_loss(image, gt_image)
    dssim = 1.0 - ssim(image, gt_image) if lambda_dssim != 0.0 else zero
    if lambda_depth != 0.0 and depth_pred is not None \
            and depth_gt is not None:
        depth_loss = scale_shift_invariant_depth_loss(
            torch.clamp(depth_pred, 0.02, 20.0), depth_gt)
    else:
        depth_loss = zero
    loss = rgb_full + lambda_dssim * dssim + lambda_depth * depth_loss
    return {"loss": loss, "loss_rgb": rgb_full, "loss_dssim": dssim,
            "loss_depth": depth_loss}


def psnr(pred, gt):
    mse = ((pred - gt) ** 2).mean()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
