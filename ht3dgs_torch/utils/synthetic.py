"""Synthetic video for tests and the card check.

Counterpart of `ht3dgs.utils.synthetic`: the same random Gaussian scene,
camera orbit and expected depths, with the frames rendered by the port's
oracle renderer. `write_images_only` writes them as an images_only dataset
(PNGs by `utils.image.write_png`: other bytes than Pillow's, the same
pixels).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core import gaussians as G
from ..core.camera import intrinsics_from_fov, make_camera
from .image import write_png


@dataclass
class SyntheticScene:
    state: "G.GaussianState"
    intrinsics: np.ndarray
    height: int
    width: int
    poses_w2c: np.ndarray      # [F, 4, 4]
    frames: np.ndarray         # [F, H, W, 3]
    depths: np.ndarray = None  # [F, H, W] expected ray depth


def make_scene_states(n_gaussians=400, seed=0, spread=0.7, z_center=3.0,
                      device="cuda"):
    """Depth-rich random scene: z spans ~[z_center-1, z_center+2] so camera
    rotation and translation are visually distinguishable (shallow scenes
    make relative pose ill-conditioned — any SfM-free method needs
    parallax)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([
        rng.standard_normal(n_gaussians) * spread,
        rng.standard_normal(n_gaussians) * spread * 0.75,
        z_center - 1.0 + 3.0 * rng.random(n_gaussians),
    ], axis=1).astype(np.float32)
    colors = rng.random((n_gaussians, 3)).astype(np.float32)
    state = G.create_from_pcd(pts, colors, capacity=n_gaussians,
                              device=device)
    return state


def orbit_poses(n_frames: int, radius: float = 0.08,
                z_center: float = 3.0, max_angle: float = 0.08) -> np.ndarray:
    """Small smooth camera orbit. Adjacent-frame motion is kept video-like
    (~0.5-1 deg rotation) — the regime the reference's 300-iteration
    relative-pose fits are tuned for."""
    poses = []
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        ang = max_angle * np.sin(2 * np.pi * t)
        # rotate about y through the scene center, small translation
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        center = np.array([radius * np.sin(2 * np.pi * t),
                           0.05 * np.sin(4 * np.pi * t),
                           0.0], np.float32)
        # w2c: x_cam = R (x - C) with pivot at scene center
        pivot = np.array([0, 0, z_center], np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = R
        w2c[:3, 3] = -R @ (center + pivot) + pivot
        poses.append(w2c)
    return np.stack(poses)


def generate(n_frames=12, height=48, width=64, n_gaussians=400,
             fovx=1.2, seed=0, device="cuda") -> SyntheticScene:
    from ..raster import render

    state = make_scene_states(n_gaussians, seed=seed, device=device)
    K = intrinsics_from_fov(fovx, height, width)
    poses = orbit_poses(n_frames)
    frames, depths = [], []
    for i in range(n_frames):
        cam = make_camera(height, width, K, world_view=poses[i],
                          device=device)
        with torch.no_grad():
            out = render(state, cam, mode="oracle")
        frames.append(out["image"].cpu().numpy())
        # expected depth (alpha-normalized); background gets the far mean
        d = out["depth"].cpu().numpy()
        a = out["alpha"].cpu().numpy()
        dn = np.where(a > 0.3, d / np.maximum(a, 1e-6),
                      np.median(d[a > 0.3]) if np.any(a > 0.3) else 3.0)
        depths.append(dn.astype(np.float32))
    return SyntheticScene(state=state, intrinsics=K, height=height,
                          width=width, poses_w2c=poses,
                          frames=np.stack(frames), depths=np.stack(depths))


def write_images_only(scene: SyntheticScene, out_dir: str,
                      depth_dir: str = None) -> str:
    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(scene.frames):
        write_png(os.path.join(out_dir, f"{i:04d}.png"),
                  (f * 255).astype(np.uint8))
    if depth_dir is not None and scene.depths is not None:
        os.makedirs(depth_dir, exist_ok=True)
        for i, d in enumerate(scene.depths):
            np.save(os.path.join(depth_dir, f"{i:04d}.npy"), d)
    return out_dir
