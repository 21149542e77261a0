"""Point-cloud preprocessing on the host (numpy).

Counterpart of `ht3dgs.data.pointcloud`: depth unprojection through K on
the integer pixel grid, colours from the frame, and voxel downsampling by
averaging per voxel. Only the numpy voxel path is here; the JAX package's
optional native C++ kernel is not used. Normals are zeros (the model never
reads them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PointCloud:
    points: np.ndarray   # [N, 3]
    colors: np.ndarray   # [N, 3] in [0, 1]
    normals: np.ndarray  # [N, 3]


def unproject_depth(depth: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """depth [H, W] + K -> camera-space points [H*W, 3] (pixel-center grid,
    kornia depth_to_3d semantics: integer pixel coordinates)."""
    H, W = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    x = (xs - cx) / fx * depth
    y = (ys - cy) / fy * depth
    return np.stack([x, y, depth], axis=-1).reshape(-1, 3).astype(np.float32)


def voxel_downsample(points: np.ndarray, colors: np.ndarray,
                     voxel_size: float = 0.01) -> PointCloud:
    """Average points/colors per voxel (open3d voxel_down_sample
    semantics), voxels in lexicographic order."""
    vox = np.floor(points / voxel_size).astype(np.int64)
    # dictionary-free grouping: lexsort + reduceat
    order = np.lexsort((vox[:, 2], vox[:, 1], vox[:, 0]))
    vox_s = vox[order]
    boundary = np.ones(len(vox_s), dtype=bool)
    boundary[1:] = np.any(vox_s[1:] != vox_s[:-1], axis=1)
    starts = np.flatnonzero(boundary)
    counts = np.diff(np.append(starts, len(vox_s)))[:, None]
    pts = np.add.reduceat(points[order], starts, axis=0) / counts
    cols = np.add.reduceat(colors[order], starts, axis=0) / counts
    pts = pts.astype(np.float32)
    return PointCloud(pts, cols.astype(np.float32), np.zeros_like(pts))


def pcd_from_depth_image(image: np.ndarray, depth: np.ndarray,
                         intrinsics: np.ndarray, voxel_size: float = 0.01,
                         down_sample: bool = True) -> PointCloud:
    """The reference's per-frame init pipeline: unproject mono-depth, color
    by the RGB frame, voxel-downsample
    (prepare_data_from_viewpoint, the reference's
    trainer/trainer.py:644-672)."""
    points = unproject_depth(depth, intrinsics)
    colors = image.reshape(-1, 3).astype(np.float32)
    if down_sample:
        return voxel_downsample(points, colors, voxel_size)
    return PointCloud(points, colors, np.zeros_like(points))
