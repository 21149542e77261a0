"""Pinhole camera with the reference's OpenGL-style projection.

Counterpart of `ht3dgs.core.camera`: `world_view` is the 4x4 world-to-camera
matrix (R not transposed), matrices are in math convention
(`p_clip = full_proj @ p`), images are channel-last `[H, W, 3]`. A stack of
B cameras of one image size (`train.phase_a.stack_cameras`) has
`world_view [B, 4, 4]` and `fx`...`cy` `[B]`; the properties keep the
leading [B].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

ZNEAR = 0.01
ZFAR = 100.0


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * float(np.arctan(pixels / (2.0 * focal)))


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * float(np.tan(fov / 2.0)))


@dataclasses.dataclass(frozen=True)
class Camera:
    """Tensor fields on one device; `height`/`width` are plain ints."""

    world_view: torch.Tensor   # [4, 4] world -> camera ([B, 4, 4] stacked)
    fx: torch.Tensor           # 0-dim ([B] stacked)
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    height: int
    width: int
    # EWA Jacobian clamp limits (tan of half-FoV); None derives them from
    # this camera's own size
    clip_tan_x: Optional[torch.Tensor] = None
    clip_tan_y: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.world_view.device

    @property
    def tan_half_fovx(self):
        if self.clip_tan_x is not None:
            return self.clip_tan_x
        return 0.5 * self.width / self.fx

    @property
    def tan_half_fovy(self):
        if self.clip_tan_y is not None:
            return self.clip_tan_y
        return 0.5 * self.height / self.fy

    @property
    def full_proj(self) -> torch.Tensor:
        w, h = float(self.width), float(self.height)
        zero = torch.zeros(self.fx.shape, dtype=torch.float32,
                           device=self.device)
        one = torch.ones_like(zero)
        rows = [
            [2.0 * self.fx / w, zero, -(w - 2.0 * self.cx) / w, zero],
            [zero, 2.0 * self.fy / h, -(h - 2.0 * self.cy) / h, zero],
            [zero, zero, zero + ZFAR / (ZFAR - ZNEAR),
             zero - (ZFAR * ZNEAR) / (ZFAR - ZNEAR)],
            [zero, zero, one, zero],
        ]
        proj = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
        return proj @ self.world_view

    @property
    def camera_center(self) -> torch.Tensor:
        R = self.world_view[..., :3, :3]
        t = self.world_view[..., :3, 3:]
        return -(R.mT @ t)[..., 0]


def make_camera(height: int, width: int, intrinsics: np.ndarray,
                world_view: Optional[np.ndarray] = None,
                R: Optional[np.ndarray] = None,
                T: Optional[np.ndarray] = None,
                device="cuda") -> Camera:
    """Camera from a 3x3 K and either a 4x4 w2c or (R, T), R the w2c
    rotation."""
    if world_view is None:
        world_view = np.eye(4, dtype=np.float32)
        if R is not None:
            world_view[:3, :3] = R
        if T is not None:
            world_view[:3, 3] = T
    K = np.asarray(intrinsics, dtype=np.float32)

    def scalar(v):
        return torch.tensor(float(v), dtype=torch.float32, device=device)

    return Camera(
        world_view=torch.as_tensor(np.asarray(world_view, np.float32),
                                   device=device),
        fx=scalar(K[0, 0]), fy=scalar(K[1, 1]),
        cx=scalar(K[0, 2]), cy=scalar(K[1, 2]),
        height=int(height), width=int(width))


def intrinsics_from_fov(fovx: float, height: int, width: int,
                        fovy: Optional[float] = None) -> np.ndarray:
    """K with the principal point at the image center."""
    fx = fov2focal(fovx, width)
    fy = fov2focal(fovy, height) if fovy is not None else fx
    return np.asarray(
        [[fx, 0.0, width / 2.0], [0.0, fy, height / 2.0], [0.0, 0.0, 1.0]],
        dtype=np.float32)
