"""Real-photograph benchmark scenes, a stand-in for Tanks and Temples video.

Counterpart of `ht3dgs.utils.photo_scene` (numpy): a multi-plane 3D scene
(fronto-parallel textured planes at different depths, textured with the
sample photograph grace_hopper.jpg) imaged by a moving pinhole camera
with exact geometry. Each frame is a perspective
re-projection of the photo planes, composited near-to-far, with exact
ground-truth poses and depth maps: real image statistics, real parallax,
zero pose/depth noise.

`write_dataset` writes it in the NeRF-synthetic layout (transforms_train.json
+ PNGs + depth dir) that data.readers.read_blender reads, so the full
pipeline (train / eval_pose / eval_nvs) runs on it unchanged. `write_tanks`
and `write_co3d` write it in the layouts that the published configs read
(configs/tanks/*.yml: a frame folder with a COLMAP model; configs/co3d/*.yml:
CO3D-v2 frame annotations), with exact depth maps and, for each pair of
consecutive train frames, the frame at their midpoint pose as the
precomputed VFI frame.

The photograph is a byte-for-byte copy of matplotlib's sample data
(`mpl-data/sample_data/grace_hopper.jpg`, 61,306 bytes, SHA-256
a8ca6d734765703b09728ab47fe59f473d93ae3967fc24c7c0288c3c7adb7130), a U.S.
Navy portrait of Grace Hopper in the public domain. It ships in `assets/`
of this package and is decoded by `data.imgcodec`, so building the scene
needs no matplotlib; the PNGs are written by utils.image.write_png.
"""

from __future__ import annotations

import gzip
import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


PHOTO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                     "grace_hopper.jpg")


def _load_photo() -> np.ndarray:
    """A real photograph, [H, W, 3] float32 in [0,1]."""
    from ..data import imgcodec

    return imgcodec.load_rgb8(PHOTO).astype(np.float32) / 255.0


@dataclass
class Plane:
    tex: np.ndarray      # [th, tw, 3]
    z: float             # world depth of the plane
    center: Tuple[float, float]  # world (x, y) of texture center
    width: float         # world width the texture spans


def default_planes(rng: np.random.Generator) -> List[Plane]:
    photo = _load_photo()
    h, w, _ = photo.shape
    # background: full photo, far; mid + near: crops with distinct content
    return [
        Plane(photo, z=8.0, center=(0.0, 0.0), width=14.0),
        Plane(photo[: h // 2, : w // 2], z=5.0, center=(-1.2, -0.6),
              width=4.5),
        Plane(photo[h // 3:, w // 3:], z=3.2, center=(1.1, 0.7), width=2.6),
    ]


def render_frame(planes: List[Plane], w2c: np.ndarray, K: np.ndarray,
                 height: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact pinhole rendering of fronto-parallel textured planes.

    Returns (rgb [H, W, 3], depth [H, W] camera-space z). Pixels that hit no
    plane get the background plane's border color (planes should cover the
    frustum for realistic frames)."""
    c2w = np.linalg.inv(w2c)
    R, t = c2w[:3, :3], c2w[:3, 3]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    px, py = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))
    # camera-frame ray directions (OpenCV convention)
    d_cam = np.stack([(px - cx) / fx, (py - cy) / fy, np.ones_like(px)],
                     axis=-1)
    d_world = d_cam @ R.T
    o = t

    rgb = np.zeros((height, width, 3), np.float32)
    dep = np.zeros((height, width), np.float32)
    filled = np.zeros((height, width), bool)

    for plane in sorted(planes, key=lambda p: p.z):
        dz = d_world[..., 2]
        s = np.where(np.abs(dz) > 1e-9, (plane.z - o[2]) / dz, np.inf)
        hit = s > 1e-6
        X = o[0] + s * d_world[..., 0]
        Y = o[1] + s * d_world[..., 1]
        th, tw, _ = plane.tex.shape
        w_world = plane.width
        h_world = w_world * th / tw
        u = (X - plane.center[0]) / w_world + 0.5     # [0,1] across texture
        v = (Y - plane.center[1]) / h_world + 0.5
        inside = hit & (u >= 0) & (u < 1) & (v >= 0) & (v < 1) & ~filled
        # bilinear sample
        fu = np.clip(u * (tw - 1), 0, tw - 1.000001)
        fv = np.clip(v * (th - 1), 0, th - 1.000001)
        x0 = fu.astype(np.int64)
        y0 = fv.astype(np.int64)
        wx = (fu - x0)[..., None]
        wy = (fv - y0)[..., None]
        tex = plane.tex
        c = (tex[y0, x0] * (1 - wx) * (1 - wy)
             + tex[y0, np.minimum(x0 + 1, tw - 1)] * wx * (1 - wy)
             + tex[np.minimum(y0 + 1, th - 1), x0] * (1 - wx) * wy
             + tex[np.minimum(y0 + 1, th - 1),
                   np.minimum(x0 + 1, tw - 1)] * wx * wy)
        rgb = np.where(inside[..., None], c, rgb)
        # camera-space z of the hit point
        z_cam = (w2c[:3, :3] @ np.stack(
            [X, Y, np.full_like(X, plane.z)], axis=0).reshape(3, -1)
        )[2].reshape(height, width) + w2c[2, 3]
        dep = np.where(inside, z_cam.astype(np.float32), dep)
        filled |= inside
    # unfilled pixels: clamp to background plane border (sample with u,v
    # clipped on the farthest plane)
    if not filled.all():
        bg = max(planes, key=lambda p: p.z)
        dz = d_world[..., 2]
        s = (bg.z - o[2]) / np.where(np.abs(dz) > 1e-9, dz, 1e-9)
        X = o[0] + s * d_world[..., 0]
        Y = o[1] + s * d_world[..., 1]
        th, tw, _ = bg.tex.shape
        h_world = bg.width * th / tw
        u = np.clip((X - bg.center[0]) / bg.width + 0.5, 0, 1)
        v = np.clip((Y - bg.center[1]) / h_world + 0.5, 0, 1)
        x0 = np.clip((u * (tw - 1)).astype(np.int64), 0, tw - 1)
        y0 = np.clip((v * (th - 1)).astype(np.int64), 0, th - 1)
        c = bg.tex[y0, x0]
        rgb = np.where(filled[..., None], rgb, c)
        z_cam = (w2c[:3, :3] @ np.stack(
            [X, Y, np.full_like(X, bg.z)], axis=0).reshape(3, -1)
        )[2].reshape(height, width) + w2c[2, 3]
        dep = np.where(filled, dep, z_cam.astype(np.float32))
    return rgb, dep


def camera_trajectory(n_frames: int, radius: float = 0.35,
                      forward: float = 0.8) -> List[np.ndarray]:
    """Smooth dolly-arc trajectory (w2c 4x4 list, frame 0 = identity),
    handheld-video-like baby steps between frames."""
    poses = []
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        # camera center in world
        cx = radius * np.sin(2.0 * np.pi * a * 0.5)
        cy = 0.4 * radius * np.sin(2.0 * np.pi * a)
        cz = forward * a
        yaw = 0.12 * np.sin(2.0 * np.pi * a * 0.5)
        pitch = 0.05 * np.sin(2.0 * np.pi * a)
        Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)],
                       [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]])
        Rx = np.array([[1, 0, 0],
                       [0, np.cos(pitch), -np.sin(pitch)],
                       [0, np.sin(pitch), np.cos(pitch)]])
        R_c2w = Ry @ Rx
        c2w = np.eye(4)
        c2w[:3, :3] = R_c2w
        c2w[:3, 3] = [cx, cy, cz]
        poses.append(np.linalg.inv(c2w).astype(np.float64))
    # anchor frame 0 at identity (relative trajectory)
    inv0 = np.linalg.inv(poses[0])
    return [(p @ inv0).astype(np.float64) for p in poses]


def write_dataset(out_dir: str, n_frames: int = 12, height: int = 96,
                  width: int = 128, fovx: float = 1.1, seed: int = 0):
    """Render the photo-plane scene along the trajectory and write a
    NeRF-synthetic-layout dataset (+ depth/ for the precomputed provider).
    Returns (gt_w2c [F, 4, 4], K)."""
    from .image import write_png

    rng = np.random.default_rng(seed)
    planes = default_planes(rng)
    fx = width / (2.0 * np.tan(fovx / 2.0))
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]],
                 np.float64)
    poses = camera_trajectory(n_frames)

    img_dir = os.path.join(out_dir, "train")
    dep_dir = os.path.join(out_dir, "depth")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(dep_dir, exist_ok=True)
    frames = []
    for i, w2c in enumerate(poses):
        rgb, dep = render_frame(planes, w2c, K, height, width)
        name = f"r_{i:03d}"
        write_png(os.path.join(img_dir, name + ".png"),
                  (rgb * 255).astype(np.uint8))
        np.save(os.path.join(dep_dir, name + ".npy"), dep)
        c2w = np.linalg.inv(w2c)
        # OpenCV w2c -> NeRF/OpenGL c2w (flip y/z) for transforms.json
        c2w_gl = c2w.copy()
        c2w_gl[:3, 1:3] *= -1
        frames.append({"file_path": f"train/{name}",
                       "transform_matrix": c2w_gl.tolist()})
    with open(os.path.join(out_dir, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": fovx, "frames": frames}, f)
    return np.stack(poses).astype(np.float32), K.astype(np.float32)


def midpoint_pose(w2c_a: np.ndarray, w2c_b: np.ndarray) -> np.ndarray:
    """The w2c pose halfway between two: the slerp of the camera rotations
    at 1/2 and the mean of the camera centres."""
    from ..data.colmap import qvec2rotmat, rotmat2qvec

    ca, cb = np.linalg.inv(w2c_a), np.linalg.inv(w2c_b)
    qa, qb = rotmat2qvec(ca[:3, :3]), rotmat2qvec(cb[:3, :3])
    q = qa + (qb if qa @ qb >= 0 else -qb)
    c2w = np.eye(4)
    c2w[:3, :3] = qvec2rotmat(q / np.linalg.norm(q))
    c2w[:3, 3] = 0.5 * (ca[:3, 3] + cb[:3, 3])
    return np.linalg.inv(c2w)


def _render_to(jobs, K: np.ndarray, height: int, width: int, seed: int,
               workers=None) -> None:
    """Render each job (w2c, PNG path, depth .npy path) and write both, on
    `workers` threads (default: one per core; numpy and zlib release the
    GIL)."""
    from .image import write_png

    planes = default_planes(np.random.default_rng(seed))

    def one(job):
        w2c, png, npy = job
        rgb, dep = render_frame(planes, w2c, K, height, width)
        write_png(png, (rgb * 255).astype(np.uint8))
        np.save(npy, dep)

    with ThreadPoolExecutor(max(1, workers or os.cpu_count() or 1)) as ex:
        list(ex.map(one, jobs))


def _midpoint_jobs(poses, train_ids, vfi_dir: str, depth_dir: str,
                   names) -> list:
    """The VFI frame of each pair of consecutive train frames k, k+1 (the
    trainer's indices): {vfi_dir}/{k}_to_{k+1}.png and its depth
    {depth_dir}/{name of frame k}_vfi.npy, where the trainer looks them
    up."""
    return [(midpoint_pose(poses[a], poses[b]),
             os.path.join(vfi_dir, f"{k}_to_{k + 1}.png"),
             os.path.join(depth_dir, f"{names[a]}_vfi.npy"))
            for k, (a, b) in enumerate(zip(train_ids[:-1], train_ids[1:]))]


def write_tanks(scene_dir: str, n_frames: int = 24, height: int = 900,
                width: int = 1600, fovx: float = 1.369319187580747,
                seed: int = 0, workers=None):
    """The scene as a Tanks and Temples folder, as configs/tanks/*.yml read
    it: {scene_dir}/images/*.png (the images_only training frames),
    sparse/0/{cameras,images,points3D}.bin (a PINHOLE COLMAP model of the
    true poses: the eval set), depth/{stem}.npy, and the VFI frames of the
    train split (every frame but the test frames of the split the readers
    take for this path) in vfi/ with their depths depth/{stem}_vfi.npy.
    Returns (gt_w2c [F, 4, 4], K)."""
    from ..data import colmap as cl
    from ..data import imgcodec
    from ..data.pointcloud import unproject_depth
    from ..data.readers import _split, sample_rate_for

    img_dir, dep_dir, vfi_dir = (os.path.join(scene_dir, d)
                                 for d in ("images", "depth", "vfi"))
    for d in (img_dir, dep_dir, vfi_dir):
        os.makedirs(d, exist_ok=True)
    fx = width / (2.0 * np.tan(fovx / 2.0))
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]],
                 np.float64)
    poses = camera_trajectory(n_frames)
    names = [f"{i + 1:06d}" for i in range(n_frames)]
    i_train, _ = _split(n_frames, sample_rate_for(img_dir))
    jobs = [(w2c, os.path.join(img_dir, n + ".png"),
             os.path.join(dep_dir, n + ".npy"))
            for w2c, n in zip(poses, names)]
    _render_to(jobs + _midpoint_jobs(poses, i_train, vfi_dir, dep_dir, names),
               K, height, width, seed, workers)

    cams = {1: cl.ColmapCamera(1, "PINHOLE", width, height,
                               np.array([fx, fx, width / 2, height / 2]))}
    images = {i + 1: cl.ColmapImage(i + 1, cl.rotmat2qvec(w2c[:3, :3]),
                                    w2c[:3, 3].copy(), 1, n + ".png")
              for i, (w2c, n) in enumerate(zip(poses, names))}
    # sparse points: frame 0's depth on a 16-pixel grid (frame 0 is the
    # world frame), coloured by the frame
    grid = (slice(None, None, 16), slice(None, None, 16))
    dep0 = np.load(os.path.join(dep_dir, names[0] + ".npy"))[grid]
    K0 = K.copy()
    K0[:2] /= 16
    rgb0 = imgcodec.load_rgb8(jobs[0][1])[grid].reshape(-1, 3) / 255.0
    cl.write_model(os.path.join(scene_dir, "sparse", "0"), cams, images,
                   unproject_depth(dep0, K0).astype(np.float64), rgb0)
    return np.stack(poses).astype(np.float32), K.astype(np.float32)


def write_co3d(data_root: str, category: str, seq_name: str, depth_dir: str,
               vfi_dir: str, n_frames: int = 16, height: int = 900,
               width: int = 1200, focal_ndc=(2.0, 2.0),
               principal_ndc=(0.02, -0.01), seed: int = 0, workers=None):
    """The scene as one CO3D-v2 sequence, as configs/co3d/*.yml read it:
    the frame annotations at {data_root}/{category}/{subdir}/
    frame_annotations.jgz (seq_name = "{subdir}_{sequence}", the readers'
    join), frames at {data_root}/{subdir}/{sequence}/images/frame*.png
    (their annotated paths), depths {depth_dir}/{frame basename}.npy, and
    the VFI frames of the train split (stride 8) in vfi_dir with their
    depths {depth_dir}/{basename}_vfi.npy. The camera is annotated in
    pytorch3d's NDC convention (focal_ndc, principal_ndc) and the poses as
    pytorch3d world-to-view R, T. Returns (gt_w2c [F, 4, 4], K)."""
    from ..data.readers import _split, co3d_ndc_to_opencv

    subdir, sequence = seq_name.split("_")[0], "_".join(
        seq_name.split("_")[1:])
    rel_dir = f"{subdir}/{sequence}/images"
    ann_dir = os.path.join(data_root, category, subdir)
    for d in (os.path.join(data_root, rel_dir), ann_dir, depth_dir, vfi_dir):
        os.makedirs(d, exist_ok=True)
    K = co3d_ndc_to_opencv(principal_ndc, focal_ndc,
                           (height, width)).astype(np.float64)
    poses = camera_trajectory(n_frames)
    paths = [f"{rel_dir}/frame{i + 1:06d}.png" for i in range(n_frames)]
    names = [os.path.basename(p) for p in paths]
    flip = np.diag([-1.0, -1.0, 1.0])
    entries = [{
        "sequence_name": sequence, "frame_number": i,
        "image": {"path": path, "size": [height, width]},
        "depth": {"path": os.path.relpath(
            os.path.join(depth_dir, name + ".npy"), data_root)},
        "viewpoint": {"R": (flip @ w2c[:3, :3]).T.tolist(),
                      "T": (flip @ w2c[:3, 3]).tolist(),
                      "focal_length": list(focal_ndc),
                      "principal_point": list(principal_ndc)}}
        for i, (w2c, path, name) in enumerate(zip(poses, paths, names))]
    with gzip.open(os.path.join(ann_dir, "frame_annotations.jgz"), "wt") as f:
        json.dump(entries, f)
    i_train, _ = _split(n_frames, 8)
    jobs = [(w2c, os.path.join(data_root, p),
             os.path.join(depth_dir, n + ".npy"))
            for w2c, p, n in zip(poses, paths, names)]
    _render_to(jobs + _midpoint_jobs(poses, i_train, vfi_dir, depth_dir,
                                     names), K, height, width, seed, workers)
    return np.stack(poses).astype(np.float32), K.astype(np.float32)
