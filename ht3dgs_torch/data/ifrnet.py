"""IFRNet video-frame interpolation as a PyTorch module (NCHW).

Counterpart of `ht3dgs.data.ifrnet`: the public IFRNet architecture (Kong
et al., CVPR 2022) with a 4-level conv encoder (stride-2 pyramids
32/48/72/96, per-channel PReLU) and four coarse-to-fine decoders, each
convrelu -> side-channel ResBlock -> 4x4/stride-2 transposed conv, that
predict bidirectional flows, a merge mask and a residual. Frames are
backward-warped (`grid_sample`, bilinear, border padding,
align_corners=True) and merged at t = 0.5.

The module's parameter names are the torch state_dict names of
`param_spec()`, so the public IFRNet_Vimeo90K.pth loads with
`load_state_dict`. It runs on the trainer's device in float32 (no TF32),
on PyTorch's own convolution kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..train.losses import full_precision_convs


# ---------------------------------------------------------------------------
# ops (NCHW)
# ---------------------------------------------------------------------------

def resize_bilinear(x: torch.Tensor, scale: float) -> torch.Tensor:
    n, c, h, w = x.shape
    return F.interpolate(x, size=(int(round(h * scale)),
                                  int(round(w * scale))),
                         mode="bilinear", align_corners=False)


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp img by flow (pixels; channels dx, dy), bilinear,
    border padding, align_corners=True."""
    n, _, h, w = img.shape
    xs = torch.linspace(-1.0, 1.0, w, device=img.device)
    ys = torch.linspace(-1.0, 1.0, h, device=img.device)
    grid = torch.stack([xs.view(1, 1, w).expand(n, h, w),
                        ys.view(1, h, 1).expand(n, h, w)], dim=-1)
    norm = torch.stack([flow[:, 0] / ((w - 1) / 2.0),
                        flow[:, 1] / ((h - 1) / 2.0)], dim=-1)
    return F.grid_sample(img, grid + norm, mode="bilinear",
                         padding_mode="border", align_corners=True)


# ---------------------------------------------------------------------------
# blocks, named as the torch state_dict
# ---------------------------------------------------------------------------

def convrelu(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, 1), nn.PReLU(cout))


class ResBlock(nn.Module):
    def __init__(self, c: int, side: int = 32):
        super().__init__()
        self.side = side
        self.conv1 = convrelu(c, c)
        self.conv2 = convrelu(side, side)
        self.conv3 = convrelu(c, c)
        self.conv4 = convrelu(side, side)
        self.conv5 = nn.Conv2d(c, c, 3, 1, 1)
        self.prelu = nn.PReLU(c)

    def forward(self, x):
        s = self.side
        out = self.conv1(x)
        out = torch.cat([out[:, :-s], self.conv2(out[:, -s:])], dim=1)
        out = self.conv3(out)
        out = torch.cat([out[:, :-s], self.conv4(out[:, -s:])], dim=1)
        return self.prelu(x + self.conv5(out))


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        for i, (cin, cout) in enumerate(((3, 32), (32, 48), (48, 72),
                                         (72, 96)), start=1):
            setattr(self, f"pyramid{i}", nn.Sequential(
                convrelu(cin, cout, 2), convrelu(cout, cout)))

    def forward(self, img):
        f1 = self.pyramid1(img)
        f2 = self.pyramid2(f1)
        f3 = self.pyramid3(f2)
        f4 = self.pyramid4(f3)
        return f1, f2, f3, f4


class Decoder(nn.Module):
    def __init__(self, cin: int, cmid: int, cout: int):
        super().__init__()
        self.convblock = nn.Sequential(
            convrelu(cin, cmid), ResBlock(cmid),
            nn.ConvTranspose2d(cmid, cout, 4, 2, 1))

    def forward(self, x):
        return self.convblock(x)


_DECODERS = (("decoder4", 193, 192, 76), ("decoder3", 220, 216, 52),
             ("decoder2", 148, 144, 36), ("decoder1", 100, 96, 8))


class IFRNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = Encoder()
        for name, cin, cmid, cout in _DECODERS:
            setattr(self, name, Decoder(cin, cmid, cout))
        self.requires_grad_(False)

    @torch.no_grad()
    def forward(self, img0: torch.Tensor, img1: torch.Tensor,
                embt: float = 0.5) -> torch.Tensor:
        """img0/img1: [N, 3, H, W] in [0, 1], H and W divisible by 16."""
        # Not cuDNN: without TF32 its heuristics pick FFT convolutions for
        # these layers at 1080p, which launch ~130,000 small kernels and
        # take ~24 GiB of workspace per call (chip_smoke.py phase 10 times
        # both).
        with full_precision_convs(use_cudnn=False):
            return self._interpolate(img0, img1, embt)

    def _interpolate(self, img0, img1, embt):
        # one mean over both frames (and every channel) per batch item
        mean_ = torch.cat([img0, img1], dim=2).mean(dim=(1, 2, 3),
                                                    keepdim=True)
        img0 = img0 - mean_
        img1 = img1 - mean_

        f0 = self.encoder(img0)
        f1 = self.encoder(img1)

        n, _, h4, w4 = f0[3].shape
        embt_map = torch.full((n, 1, h4, w4), embt, device=img0.device)
        out4 = self.decoder4(torch.cat([f0[3], f1[3], embt_map], dim=1))
        up_flow0 = out4[:, 0:2]
        up_flow1 = out4[:, 2:4]
        ft_ = out4[:, 4:]

        for lvl, dec in ((2, self.decoder3), (1, self.decoder2),
                         (0, self.decoder1)):
            f0w = warp(f0[lvl], up_flow0)
            f1w = warp(f1[lvl], up_flow1)
            out = dec(torch.cat([ft_, f0w, f1w, up_flow0, up_flow1], dim=1))
            up_flow0 = out[:, 0:2] + 2.0 * resize_bilinear(up_flow0, 2.0)
            up_flow1 = out[:, 2:4] + 2.0 * resize_bilinear(up_flow1, 2.0)
            ft_ = out[:, 4:]
        mask = torch.sigmoid(out[:, 4:5])
        res = out[:, 5:8]

        img0_warp = warp(img0, up_flow0)
        img1_warp = warp(img1, up_flow1)
        merged = mask * img0_warp + (1.0 - mask) * img1_warp + mean_
        return torch.clamp(merged + res, 0.0, 1.0)


# ---------------------------------------------------------------------------
# checkpoint / API
# ---------------------------------------------------------------------------

def param_spec() -> Dict[str, Tuple[int, ...]]:
    """Complete name -> shape map of the IFRNet(Vimeo90K) weights under the
    torch state_dict naming (pyramid channels 32/48/72/96; decoders
    193->192->76, 220->216->52, 148->144->36, 100->96->8)."""
    spec: Dict[str, Tuple[int, ...]] = {}

    def convrelu_spec(prefix, cin, cout, k=3):
        spec[f"{prefix}.0.weight"] = (cout, cin, k, k)
        spec[f"{prefix}.0.bias"] = (cout,)
        spec[f"{prefix}.1.weight"] = (cout,)      # per-channel PReLU

    def resblock_spec(prefix, c, side=32):
        convrelu_spec(f"{prefix}.conv1", c, c)
        convrelu_spec(f"{prefix}.conv2", side, side)
        convrelu_spec(f"{prefix}.conv3", c, c)
        convrelu_spec(f"{prefix}.conv4", side, side)
        spec[f"{prefix}.conv5.weight"] = (c, c, 3, 3)
        spec[f"{prefix}.conv5.bias"] = (c,)
        spec[f"{prefix}.prelu.weight"] = (c,)

    pyramids = [("pyramid1", 3, 32), ("pyramid2", 32, 48),
                ("pyramid3", 48, 72), ("pyramid4", 72, 96)]
    for name, cin, cout in pyramids:
        convrelu_spec(f"encoder.{name}.0", cin, cout)
        convrelu_spec(f"encoder.{name}.1", cout, cout)
    for name, cin, cmid, cout in _DECODERS:
        convrelu_spec(f"{name}.convblock.0", cin, cmid)
        resblock_spec(f"{name}.convblock.1", cmid)
        # ConvTranspose2d stores IOHW
        spec[f"{name}.convblock.2.weight"] = (cmid, cout, 4, 4)
        spec[f"{name}.convblock.2.bias"] = (cout,)
    return spec


def random_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random parameters matching `param_spec` (He-ish scaling, PReLU slopes
    at the torch init 0.25), the JAX package's draws. For tests and smoke
    runs only."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in param_spec().items():
        if k.endswith("1.weight") and len(shape) == 1 or \
                k.endswith("prelu.weight"):
            out[k] = np.full(shape, 0.25, np.float32)
        elif k.endswith("bias"):
            out[k] = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            out[k] = (rng.standard_normal(shape) *
                      np.sqrt(2.0 / max(fan_in, 1))).astype(np.float32)
    return out


def validate_params(params: Dict[str, np.ndarray]):
    """Raise if a converted checkpoint is missing weights or has shape
    mismatches; returns the list of unused extra keys (e.g. optimizer
    buffers) that were ignored."""
    spec = param_spec()
    missing = [k for k in spec if k not in params]
    if missing:
        raise ValueError(f"IFRNet checkpoint is missing {len(missing)} "
                         f"weights, e.g. {missing[:5]}")
    bad = [(k, tuple(np.shape(params[k])), spec[k]) for k in spec
           if tuple(np.shape(params[k])) != spec[k]]
    if bad:
        raise ValueError(f"IFRNet checkpoint shape mismatches: {bad[:5]}")
    return [k for k in params if k not in spec]


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        k = k.replace("module.", "")
        out[k] = v.detach().numpy().astype(np.float32)
    return out


def from_params(params: Dict[str, np.ndarray], device="cuda") -> IFRNet:
    """An IFRNet on `device` holding `params` (param_spec's names)."""
    validate_params(params)
    net = IFRNet()
    net.load_state_dict({k: torch.as_tensor(np.asarray(params[k], np.float32))
                         for k in param_spec()})
    return net.to(device).eval()


def build(checkpoint: Optional[str] = None, device="cuda") -> IFRNet:
    if checkpoint is None:
        raise ValueError(
            "IFRNet needs a converted IFRNet_Vimeo90K checkpoint; use the "
            "'blend' or 'precomputed' VFI provider on hosts without it")
    if checkpoint.endswith(".npz"):
        with np.load(checkpoint) as z:
            loaded = dict(z)
    else:
        loaded = load_torch_checkpoint(checkpoint)
    return from_params(loaded, device)


def pad16(img: np.ndarray, device) -> torch.Tensor:
    """[H, W, 3] -> [1, 3, H', W'] on `device`, edge-padded to /16 (the
    reference's InputPadder)."""
    h, w, _ = img.shape
    a = np.pad(img, ((0, (-h) % 16), (0, (-w) % 16), (0, 0)), mode="edge")
    return torch.as_tensor(np.ascontiguousarray(a.transpose(2, 0, 1)[None]),
                           dtype=torch.float32, device=device)


def interpolate(net: IFRNet, img0: np.ndarray, img1: np.ndarray,
                embt: float = 0.5) -> np.ndarray:
    """[H, W, 3] float32 frames -> midway frame, on the network's device."""
    h, w, _ = img0.shape
    dev = next(net.parameters()).device
    out = net(pad16(img0, dev), pad16(img1, dev), embt)
    return out[0, :, :h, :w].permute(1, 2, 0).cpu().numpy()
