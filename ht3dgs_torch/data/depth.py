"""Monocular-depth providers, counterpart of `ht3dgs.data.depth`.

- "precomputed": `{dir}/{name}.npy` metric depth, or 8/16-bit PNGs
  (decoded by `imgcodec`; a map of another size is resized as Pillow's
  BILINEAR resizes a float image);
- "dpt"/"midas"/"zoe": torch-hub inference when the hub cache holds the
  weights, with the reference's disparity -> depth affine;
- "constant"/"none": all-ones depth.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from . import imgcodec

NEAR = 0.01

# disparity -> depth affine constants per model
# (predict_depth, the reference's trainer/trainer.py:198-239)
_AFFINE = {
    "midas": (0.000305, 0.1378),
    "dpt": (0.000305, 0.1378),
    "depth_anything": (0.0305, 0.15),
}


def disparity_to_depth(disp: np.ndarray, model_type: str = "dpt") -> np.ndarray:
    scale, shift = _AFFINE.get(model_type, _AFFINE["dpt"])
    d = scale * disp + shift
    d = np.where(d < 1e-8, 1e-8, d)
    depth = 1.0 / d
    return np.maximum(depth, NEAR).astype(np.float32)


class DepthProvider:
    def __call__(self, image: np.ndarray, name: str) -> np.ndarray:
        raise NotImplementedError


class ConstantDepth(DepthProvider):
    def __call__(self, image, name):
        return np.ones(image.shape[:2], np.float32)


class PrecomputedDepth(DepthProvider):
    """Reads `{dir}/{name}.npy` (metric depth) or 16-bit pngs."""

    def __init__(self, directory: str, is_disparity: bool = False,
                 model_type: str = "dpt"):
        self.dir = directory
        self.is_disparity = is_disparity
        self.model_type = model_type

    def __call__(self, image, name):
        npy = os.path.join(self.dir, f"{name}.npy")
        if os.path.exists(npy):
            d = np.load(npy).astype(np.float32)
        else:
            png = os.path.join(self.dir, f"{name}.png")
            d = imgcodec.open_array(png).astype(np.float32)
            if d.max() > 255:
                d = d / 65535.0
            else:
                d = d / 255.0
        if d.shape != image.shape[:2]:
            h, w = image.shape[:2]
            d = imgcodec.resize_bilinear_f32(d, w, h)
        if self.is_disparity:
            d = disparity_to_depth(d, self.model_type)
        return np.maximum(d.astype(np.float32), NEAR)


class TorchHubDepth(DepthProvider):
    """MiDaS / Zoe / DepthAnything via torch hub (CPU), reference parity.
    Only usable when the hub cache is already populated (zero-egress hosts
    can't download); construct lazily and fail with a clear message."""

    def __init__(self, model_type: str = "dpt"):
        self.model_type = model_type
        self._model = None
        self._transform = None

    def _ensure(self):
        if self._model is not None:
            return
        import torch

        if self.model_type in ("dpt", "midas"):
            self._model = torch.hub.load("intel-isl/MiDaS", "DPT_Hybrid")
            tf = torch.hub.load("intel-isl/MiDaS", "transforms")
            self._transform = tf.dpt_transform
        elif self.model_type == "zoe":
            self._model = torch.hub.load("isl-org/ZoeDepth", "ZoeD_NK",
                                         pretrained=True)
        else:
            raise ValueError(f"unknown depth model {self.model_type}")
        self._model.eval()

    def __call__(self, image, name):
        import torch

        self._ensure()
        img255 = (image * 255).astype(np.uint8)
        with torch.no_grad():
            if self.model_type == "zoe":
                depth = self._model.infer_pil(img255)
                return np.maximum(np.asarray(depth, np.float32), NEAR)
            batch = self._transform(img255)
            pred = self._model(batch)
            pred = torch.nn.functional.interpolate(
                pred.unsqueeze(1), size=image.shape[:2], mode="bicubic",
                align_corners=False).squeeze().cpu().numpy()
        return disparity_to_depth(pred, self.model_type)


def make_depth_provider(kind: str, **kw) -> DepthProvider:
    if kind in ("constant", "none"):
        return ConstantDepth()
    if kind == "precomputed":
        return PrecomputedDepth(**kw)
    return TorchHubDepth(model_type=kind)
