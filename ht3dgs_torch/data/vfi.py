"""Video-frame-interpolation (VFI) providers for multi-source supervision,
counterpart of `ht3dgs.data.vfi`:

- "blend": 0.5 (a + b), a dependency-free stand-in for a VFI network;
- "precomputed": `{dir}/{i}_to_{i+1}.{png,jpg,npy}` midway frames (images
  decoded by `imgcodec`);
- "none": no VFI;
- "ifrnet": the IFRNet network (`data.ifrnet`) on the trainer's device,
  from a converted IFRNet_Vimeo90K checkpoint.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import ifrnet, imgcodec


class VFIProvider:
    def __call__(self, img0: np.ndarray, img1: np.ndarray,
                 pair_name: str) -> np.ndarray:
        """img0/img1: [H, W, 3] float32 -> midway frame [H, W, 3]."""
        raise NotImplementedError


class BlendVFI(VFIProvider):
    def __call__(self, img0, img1, pair_name):
        return 0.5 * (img0 + img1)


class PrecomputedVFI(VFIProvider):
    def __init__(self, directory: str):
        self.dir = directory

    def __call__(self, img0, img1, pair_name):
        for ext in (".png", ".jpg", ".npy"):
            p = os.path.join(self.dir, pair_name + ext)
            if os.path.exists(p):
                if ext == ".npy":
                    return np.load(p).astype(np.float32)
                return imgcodec.load_rgb8(p).astype(np.float32) / 255.0
        raise FileNotFoundError(
            f"no precomputed VFI frame {pair_name} under {self.dir}")


class IFRNetVFI(VFIProvider):
    def __init__(self, checkpoint: Optional[str] = None, device="cuda"):
        self.net = ifrnet.build(checkpoint, device)

    def __call__(self, img0, img1, pair_name):
        return ifrnet.interpolate(self.net, img0, img1)


def make_vfi_provider(kind: str, **kw) -> Optional[VFIProvider]:
    if kind in ("none", ""):
        return None
    if kind == "blend":
        return BlendVFI()
    if kind == "precomputed":
        return PrecomputedVFI(**kw)
    if kind == "ifrnet":
        return IFRNetVFI(**kw)
    raise ValueError(f"unknown VFI provider {kind}")
