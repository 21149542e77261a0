"""Image output: depth colorization and render | ground-truth PNG dumps.

Counterpart of `ht3dgs.utils.image`. PNGs are written by `write_png` with
the standard library (zlib, struct), so a training run needs no PIL.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np


def write_png(path: str, rgb: np.ndarray) -> None:
    """[H, W, 3] uint8 -> 8-bit RGB PNG (no filtering, zlib level 6)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png takes [H, W, 3], got {rgb.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)],
                         axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def colorize(value: np.ndarray, vmin: Optional[float] = None,
             vmax: Optional[float] = None, cmap: str = "magma_r",
             invalid_val: float = -99.0) -> np.ndarray:
    """[H, W] scalar map -> [H, W, 3] uint8 colormapped image (grey where
    matplotlib is missing)."""
    value = np.asarray(value, dtype=np.float64).squeeze()
    mask = value != invalid_val
    vmin = np.percentile(value[mask], 2) if vmin is None and mask.any() \
        else (vmin or 0.0)
    vmax = np.percentile(value[mask], 85) if vmax is None and mask.any() \
        else (vmax or 1.0)
    if vmin != vmax:
        value = (value - vmin) / (vmax - vmin)
    else:
        value = value * 0.0
    value = np.clip(value, 0.0, 1.0)
    try:
        import matplotlib

        out = matplotlib.colormaps[cmap](value, bytes=True)[..., :3]
    except (ImportError, KeyError):
        g = (value * 255).astype(np.uint8)
        out = np.stack([g, g, g], axis=-1)
    out[~mask] = 128
    return out


def save_image(path: str, image: np.ndarray,
               gt_image: Optional[np.ndarray] = None):
    """Save a render (GT | render side by side when gt_image is given) as
    PNG. Inputs [H, W, 3] float in [0, 1]."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
    if gt_image is not None:
        gt = (np.clip(np.asarray(gt_image), 0, 1) * 255).astype(np.uint8)
        img = np.hstack([gt, img])
    write_png(path, img)


def save_depth(path: str, depth: np.ndarray,
               gt_depth: Optional[np.ndarray] = None, cmap: str = "magma_r"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    d = colorize(np.asarray(depth), cmap=cmap)
    if gt_depth is not None:
        d = np.hstack([colorize(np.asarray(gt_depth), cmap=cmap), d])
    write_png(path, d)
