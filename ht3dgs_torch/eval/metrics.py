"""Image-quality metrics: PSNR / SSIM / LPIPS.

Counterpart of `ht3dgs.eval.metrics`. PSNR and SSIM are the port's
`train.losses`. LPIPS is v0.1 with a VGG16 feature stack (`LPIPS`, an
`nn.Module` in NCHW) and the published linear layers. The weights load from
the npz layout that `convert_lpips_weights` writes, at the path the JAX
package reads (`HT3DGS_LPIPS_WEIGHTS` or ~/.cache/ht3dgs/lpips_vgg.npz), so
one file serves both packages; without it `try_lpips` reports NaN.

The convolutions run without TF32 (`full_precision_convs`), the
counterpart of the JAX package's Precision.HIGHEST.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..train.losses import full_precision_convs
from ..train.losses import psnr, ssim  # re-export  # noqa: F401

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
# LPIPS v0.1 taps the activations after each conv-stage (pre-pool ReLUs)
_TAPS = [1, 3, 6, 9, 12]  # indices into the conv list (0-based, after ReLU)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _weights_path() -> str:
    return os.environ.get(
        "HT3DGS_LPIPS_WEIGHTS",
        os.path.expanduser("~/.cache/ht3dgs/lpips_vgg.npz"))


# (weights path, device) -> LPIPS module
_cached: Dict[tuple, "LPIPS"] = {}


def _load_weights(path: str) -> Dict[str, np.ndarray]:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"LPIPS weights not found at {path}; run "
            "ht3dgs_torch.eval.metrics.convert_lpips_weights() on a host "
            "with the torchvision VGG16 + LPIPS checkpoints, or set "
            "HT3DGS_LPIPS_WEIGHTS.")
    with np.load(path) as z:
        return dict(z)


def convert_lpips_weights(out_path: Optional[str] = None) -> str:
    """Export torchvision VGG16 conv weights + LPIPS v0.1 linear weights to
    the npz that `LPIPS` (and the JAX package) loads. Needs torchvision and
    its cached checkpoints."""
    import torchvision

    out_path = out_path or _weights_path()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    vgg = torchvision.models.vgg16(weights="IMAGENET1K_V1").features.eval()
    arrs = {}
    conv_idx = 0
    for layer in vgg:
        if isinstance(layer, nn.Conv2d):
            arrs[f"conv{conv_idx}_w"] = layer.weight.detach().numpy()
            arrs[f"conv{conv_idx}_b"] = layer.bias.detach().numpy()
            conv_idx += 1
    url = ("https://raw.githubusercontent.com/richzhang/PerceptualSimilarity"
           "/master/lpips/weights/v0.1/vgg.pth")
    lin = torch.hub.load_state_dict_from_url(url, map_location="cpu")
    for i in range(5):
        arrs[f"lin{i}"] = lin[f"lin{i}.model.1.weight"].detach().numpy()
    np.savez(out_path, **arrs)
    return out_path


class LPIPS(nn.Module):
    """LPIPS(vgg) v0.1 from the npz arrays conv{i}_w/_b and lin{i}."""

    def __init__(self, weights: Dict[str, np.ndarray]):
        super().__init__()
        convs, cin = [], 3
        for v in _VGG_CFG:
            if v == "M":
                continue
            i = len(convs)
            conv = nn.Conv2d(cin, v, 3, padding=1)
            conv.weight.data = torch.as_tensor(weights[f"conv{i}_w"])
            conv.bias.data = torch.as_tensor(weights[f"conv{i}_b"])
            convs.append(conv)
            cin = v
        self.convs = nn.ModuleList(convs)
        self.register_buffer("shift", torch.as_tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.as_tensor(_SCALE).view(1, 3, 1, 1))
        for i in range(len(_TAPS)):
            self.register_buffer(f"lin{i}", torch.as_tensor(
                weights[f"lin{i}"]).reshape(1, -1, 1, 1))
        self.requires_grad_(False)

    def features(self, x: torch.Tensor):
        """[N, 3, H, W] in [0, 1] -> the activations at the taps."""
        x = (x * 2.0 - 1.0 - self.shift) / self.scale
        feats, ci = [], 0
        for v in _VGG_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2)
                continue
            x = F.relu(self.convs[ci](x))
            if ci in _TAPS:
                feats.append(x)
            ci += 1
        return feats

    @torch.no_grad()
    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """[N, 3, H, W] images in [0, 1] -> [N] distances."""
        with full_precision_convs():
            f0, f1 = self.features(img0), self.features(img1)
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            a = a / a.norm(dim=1, keepdim=True).clamp_min(1e-10)
            b = b / b.norm(dim=1, keepdim=True).clamp_min(1e-10)
            d = ((a - b) ** 2 * getattr(self, f"lin{i}")).sum(dim=1)
            total = total + d.mean(dim=(1, 2))
        return total


def lpips_module(device="cuda") -> LPIPS:
    """The LPIPS network on `device`, built once per weights file."""
    device = torch.device(device)
    path = _weights_path()
    key = (path, str(device))
    if key not in _cached:
        _cached[key] = LPIPS(_load_weights(path)).to(device)
    return _cached[key]


def lpips(img0, img1, device=None) -> float:
    """LPIPS(vgg) distance between [H, W, 3] images in [0, 1] (tensors or
    numpy arrays). It runs on `device`, else on img0's device where img0 is
    a tensor, else on the card."""
    if device is None:
        device = img0.device if isinstance(img0, torch.Tensor) else "cuda"

    def nchw(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        return x.permute(2, 0, 1)[None]

    return float(lpips_module(device)(nchw(img0), nchw(img1))[0])


def try_lpips(img0, img1, device=None) -> float:
    try:
        return lpips(img0, img1, device=device)
    except FileNotFoundError:
        return float("nan")
