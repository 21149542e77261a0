"""COLMAP sparse-reconstruction parsers and writers (binary + text),
counterpart of `ht3dgs.data.colmap`. COLMAP stores the w2c rotation as a
[w, x, y, z] quaternion and a translation t per image.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# camera model id -> (name, num_params); public COLMAP enumeration
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # [w, x, y, z]
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP [w,x,y,z] quaternion -> rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height),
                                        params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.read(24 * n_pts)  # skip 2D points (x, y, point3D_id)
            images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                           name.decode("utf-8"))
    return images


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz [N,3], rgb [N,3] in [0,1], error [N])."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        err = np.empty(n)
        for i in range(n):
            vals = _read(f, "<QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return xyz, rgb / 255.0, err


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cams[cam_id] = ColmapCamera(
                cam_id, parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.strip().startswith("#")]
    for meta in lines[0::2]:  # every other line is the 2D point list
        parts = meta.split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        images[image_id] = ColmapImage(image_id, qvec, tvec, int(parts[8]),
                                       parts[9])
    return images


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyz.append([float(p) for p in parts[1:4]])
            rgb.append([float(p) for p in parts[4:7]])
            err.append(float(parts[7]))
    return (np.array(xyz), np.array(rgb) / 255.0, np.array(err))


def read_model(sparse_dir: str):
    """Read cameras+images+points from a COLMAP sparse dir, preferring
    binary (same fallback the reference applies,
    the reference's scene/dataset_readers.py:151-160)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        images = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        images = read_images_text(os.path.join(sparse_dir, "images.txt"))
    pts_bin = os.path.join(sparse_dir, "points3D.bin")
    if os.path.exists(pts_bin):
        points = read_points3d_binary(pts_bin)
    elif os.path.exists(os.path.join(sparse_dir, "points3D.txt")):
        points = read_points3d_text(os.path.join(sparse_dir, "points3D.txt"))
    else:
        points = None
    return cams, images, points


def camera_intrinsics(cam: ColmapCamera) -> np.ndarray:
    """3x3 K from a COLMAP camera (pinhole family)."""
    if cam.model == "SIMPLE_PINHOLE" or cam.model == "SIMPLE_RADIAL":
        f, cx, cy = cam.params[:3]
        fx = fy = f
    elif cam.model in ("PINHOLE", "OPENCV", "FULL_OPENCV", "OPENCV_FISHEYE"):
        fx, fy, cx, cy = cam.params[:4]
    else:
        raise ValueError(f"unsupported COLMAP camera model {cam.model}")
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)


# --------------------------------------------------------------------------
# binary writers (mirror of the readers above; used to export scenes in
# COLMAP layout and by the synthetic COLMAP-ingestion e2e fixture —
# format per colmap/src/base/reconstruction.cc, the same layout
# the reference's scene/colmap_loader.py parses)

def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> [w, x, y, z] unit quaternion."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def write_cameras_binary(cams: Dict[int, ColmapCamera], path: str) -> None:
    model_ids = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            f.write(struct.pack("<iiQQ", cam.id, model_ids[cam.model],
                                cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))     # no 2D points


def write_points3d_binary(xyz: np.ndarray, rgb: np.ndarray,
                          path: str) -> None:
    """rgb in [0, 1]."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            r, g, b = (np.clip(rgb[i], 0, 1) * 255).astype(np.uint8)
            f.write(struct.pack("<QdddBBBd", i + 1, *xyz[i].astype(float),
                                int(r), int(g), int(b), 0.0))
            f.write(struct.pack("<Q", 0))     # empty track


def write_model(sparse_dir: str, cams: Dict[int, ColmapCamera],
                images: Dict[int, ColmapImage],
                xyz: np.ndarray, rgb: np.ndarray) -> None:
    os.makedirs(sparse_dir, exist_ok=True)
    write_cameras_binary(cams, os.path.join(sparse_dir, "cameras.bin"))
    write_images_binary(images, os.path.join(sparse_dir, "images.bin"))
    write_points3d_binary(xyz, rgb, os.path.join(sparse_dir,
                                                 "points3D.bin"))
