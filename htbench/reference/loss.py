"""The photometric loss of 3D Gaussian splatting: (1 - l) L1 + l (1 - SSIM),
l = 0.2, SSIM with an 11x11 Gaussian window of sigma 1.5 (separable, zero
padding) and C1 = 0.01^2, C2 = 0.03^2, over an [H, W, 3] image in [0, 1]."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import r


def _window(device) -> torch.Tensor:
    g = torch.tensor([math.exp(-(x - 5) ** 2 / (2 * 1.5 ** 2))
                      for x in range(11)], dtype=torch.float64)
    return (g / g.sum()).float().to(device)


def _blur(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> the same blurred, one channel at a time."""
    y = x.permute(2, 0, 1)[:, None]
    y = F.conv2d(r(y), r(w.reshape(1, 1, 1, 11)), padding=(0, 5))
    y = F.conv2d(r(y), r(w.reshape(1, 1, 11, 1)), padding=(5, 0))
    return y[:, 0].permute(1, 2, 0)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    w = _window(a.device)
    mu1, mu2 = _blur(a, w), _blur(b, w)
    s11 = _blur(a * a, w) - mu1 * mu1
    s22 = _blur(b * b, w) - mu2 * mu2
    s12 = _blur(a * b, w) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def photometric(image: torch.Tensor, gt: torch.Tensor,
                lambda_dssim: float = 0.2) -> torch.Tensor:
    l1 = (image - gt).abs().mean()
    return (1 - lambda_dssim) * l1 + lambda_dssim * (1 - ssim(image, gt))
