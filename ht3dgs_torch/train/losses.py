"""Training losses: (1 - λ) L1 + λ (1 - SSIM) + λ_depth scale/shift-
invariant depth, with λ = 0.2 and λ_depth = 0 by default.

Counterpart of `ht3dgs.train.losses`. Images are channel-last [H, W, 3]
in [0, 1]; a batch [B, H, W, 3] gives each image its own loss and PSNR [B]
(the SSIM blur runs as one convolution over the batch), and a batched
step differentiates their sum. The sharded variants take one row block of
the image per rank of an `Axis` and return this rank's share of the loss:
the shares sum over the ranks to the full image's loss, and so do their
gradients.

Precision on the card: cuDNN runs float32 convolutions in TF32 unless told
otherwise, so the SSIM blur runs with `cudnn.allow_tf32 = False`. Float32
matrix products are full precision already
(`torch.backends.cuda.matmul.allow_tf32` defaults to False).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import comm


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _window(window_size: int, device: torch.device) -> torch.Tensor:
    """The blur window on `device`, made once: a copy from host memory
    synchronises the stream."""
    return torch.as_tensor(_gaussian_window(window_size), device=device)


def _depthwise_blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> separable depthwise Gaussian blur, zero padding,
    the leading dimensions as one convolution batch."""
    C = x.shape[-1]
    k = window.shape[0]
    y = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)       # [B,C,H,W]
    y = F.conv2d(y, window.reshape(1, 1, 1, k).repeat(C, 1, 1, 1),
                 padding=(0, k // 2), groups=C)
    y = F.conv2d(y, window.reshape(1, 1, k, 1).repeat(C, 1, 1, 1),
                 padding=(k // 2, 0), groups=C)
    return y.permute(0, 2, 3, 1).reshape(x.shape)


@contextlib.contextmanager
def full_precision_convs(use_cudnn: bool = True):
    """Convolutions in float32 without TF32, inside this block only: the
    training step's other settings stay as they are. use_cudnn=False runs
    them on PyTorch's own kernels (im2col + cuBLAS) in place of cuDNN's."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled and use_cudnn,
                     benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def _ssim_map(img1: torch.Tensor, img2: torch.Tensor,
              window_size: int) -> torch.Tensor:
    w = _window(window_size, img1.device)
    with full_precision_convs():
        mu1 = _depthwise_blur(img1, w)
        mu2 = _depthwise_blur(img2, w)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = _depthwise_blur(img1 * img1, w) - mu1_sq
        sigma2_sq = _depthwise_blur(img2 * img2, w) - mu2_sq
        sigma12 = _depthwise_blur(img1 * img2, w) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))


# the per-image axes of [..., H, W, C]
_IMAGE_DIMS = (-3, -2, -1)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two [H, W, C] images (11x11 Gaussian window, σ 1.5),
    or [B] of two [B, H, W, C] batches."""
    return _ssim_map(img1, img2, window_size).mean(_IMAGE_DIMS)


def ssim_sharded(img1: torch.Tensor, img2: torch.Tensor, axis: comm.Axis,
                 n_values: int, window_size: int = 11) -> torch.Tensor:
    """This rank's share of the full image's mean SSIM: the sum of its row
    block's SSIM map over `n_values` (H * W * C of the full image). A
    window_size // 2 row halo exchanged with the neighbours (the gradient
    of the halo rows goes back to them) makes the map exact at the block
    edges."""
    halo = window_size // 2
    both = comm.exchange_row_halos(torch.cat([img1, img2], dim=-1), axis,
                                   halo)
    C = img1.shape[-1]
    m = _ssim_map(both[..., :C], both[..., C:], window_size)
    return m[halo:-halo].sum() / n_values


def l1_loss(pred, gt):
    return (pred - gt).abs().mean(_IMAGE_DIMS)


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


def scale_shift_invariant_depth_loss_sharded(
        depth_pred, depth_gt, axis: comm.Axis, mask=None,
        alpha: float = 0.5) -> torch.Tensor:
    """This rank's share of `scale_shift_invariant_depth_loss` over row
    blocks: the normal equations are summed over the axis (their backward
    sums too, so every rank sees the whole loss's dependence on scale and
    shift), and a 1-row halo from the next block closes the vertical pairs
    across each block edge, counted by the block that holds the upper
    row."""
    if mask is None:
        mask = (depth_gt > 0.02).to(depth_pred.dtype)
    sums = comm.all_reduce_sum(torch.stack([
        (mask * depth_pred * depth_pred).sum(), (mask * depth_pred).sum(),
        mask.sum(), (mask * depth_pred * depth_gt).sum(),
        (mask * depth_gt).sum()]), axis)
    a00, a01, a11, b0, b1 = sums.unbind(0)
    det = a00 * a11 - a01 * a01
    ok = det != 0.0
    det_safe = torch.where(ok, det, torch.ones_like(det))
    s = torch.where(ok, (a11 * b0 - a01 * b1) / det_safe, 0.0)
    t = torch.where(ok, (-a01 * b0 + a00 * b1) / det_safe, 0.0)
    res = s * depth_pred + t - depth_gt
    denom = torch.clamp(a11, min=1.0)
    data_term = (mask * res * res).sum() / (2.0 * denom)

    diff = mask * res
    gx = (diff[:, 1:] - diff[:, :-1]).abs() * (mask[:, 1:] * mask[:, :-1])
    # the next block's first row (zeros below the image's last row)
    ext = comm.exchange_row_halos(torch.stack([diff, mask], dim=-1), axis, 1)
    dext, mext = ext[1:, :, 0], ext[1:, :, 1].detach()
    gy = (dext[1:] - dext[:-1]).abs() * (mext[1:] * mext[:-1])
    return data_term + alpha * (gx.sum() + gy.sum()) / denom


def compute_loss(image: torch.Tensor, gt_image: torch.Tensor,
                 lambda_dssim: float = 0.2, lambda_depth: float = 0.0,
                 depth_pred: Optional[torch.Tensor] = None,
                 depth_gt: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """Loss terms of one image [H, W, 3], or [B] of a batch [B, H, W, 3]
    (without the depth term, which the batched fits do not use)."""
    if image.ndim == 4 and lambda_depth != 0.0:
        raise ValueError("compute_loss: no depth term for a batch")
    zero = torch.zeros(image.shape[:-3], device=image.device)
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
    """PSNR of one image, or [B] of a batch [B, H, W, C]."""
    mse = ((pred - gt) ** 2).mean(_IMAGE_DIMS)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def leaf_grads(loss: torch.Tensor,
               leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaf for each of a step's fresh leaves (zeros where the
    loss does not reach one), by `backward()` into the leaves' `.grad`.
    Not `torch.autograd.grad`: on the card its result is also held by the
    autograd engine's task until the engine's device thread lets go of
    the task, which can be after the call has returned and the step has
    dropped its gradients, so they may still be allocated at the next
    step's peak."""
    loss.backward()
    return [torch.zeros_like(x) if x.grad is None else x.grad
            for x in leaves]
