"""Scene/dataset readers, counterpart of `ht3dgs.data.readers`.

Dataset-type dispatch to a `SceneInfo` of per-frame `FrameInfo`s, with the
reference's train/test split (every `sample_rate`-th frame is test; 2 for
paths with "Family", else 8) and the 1.6K resolution cap. Images decode on
first access as channel-last float32 [H, W, 3], through `imgcodec` (the
same pixels as the JAX package's Pillow calls, Pillow's LANCZOS resize
included); a reader opens an image only for the size in its header. A
`FrameInfo` built with `_image` holds its frame in memory and needs no
file.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core.camera import focal2fov, fov2focal
from . import imgcodec


@dataclass
class FrameInfo:
    uid: int
    image_path: Optional[str]
    image_name: str
    width: int
    height: int
    intrinsics: np.ndarray                 # 3x3 K at load resolution
    fovx: float
    fovy: float
    R: Optional[np.ndarray] = None         # GT w2c rotation (eval only)
    T: Optional[np.ndarray] = None         # GT translation
    depth_path: Optional[str] = None
    _image: Optional[np.ndarray] = field(default=None, repr=False)

    def load_image(self) -> np.ndarray:
        if self._image is not None:
            return self._image
        img = imgcodec.load_rgb8(self.image_path)
        if img.shape[:2] != (self.height, self.width):
            img = imgcodec.resize_lanczos_rgb8(img, self.width, self.height)
        return img.astype(np.float32) / 255.0

    def gt_pose(self) -> Optional[np.ndarray]:
        if self.R is None:
            return None
        T4 = np.eye(4, dtype=np.float32)
        T4[:3, :3] = self.R
        T4[:3, 3] = self.T if self.T is not None else 0.0
        return T4


@dataclass
class SceneInfo:
    train_frames: List[FrameInfo]
    test_frames: List[FrameInfo]
    i_train: np.ndarray
    i_test: np.ndarray
    nerf_radius: float
    points: Optional[np.ndarray] = None   # COLMAP sparse points
    colors: Optional[np.ndarray] = None


IMG_EXTS = (".png", ".jpg", ".jpeg", ".JPG", ".PNG")


def _target_resolution(w: int, h: int, resolution: int = -1):
    """The 1.6K cap (loadCam, the reference's utils/camera_utils.py:19-45)."""
    if resolution in (1, 2, 4, 8):
        return round(w / resolution), round(h / resolution)
    down = (w / 1600 if (resolution == -1 and w > 1600)
            else (1 if resolution == -1 else w / resolution))
    return int(w / down), int(h / down)


def _split(n: int, sample_rate: int):
    ids = np.arange(n)
    i_test = ids[int(sample_rate / 2)::sample_rate]
    i_train = np.array([i for i in ids if i not in i_test])
    return i_train, i_test


def sample_rate_for(path: str, override=None) -> int:
    """Reference quirk (dataset_readers.py:424-427): stride 2 for Family,
    8 otherwise, inferred from the path. `override` (model_cfg
    .test_sample_rate) bypasses the substring match — a directory that
    merely CONTAINS "Family" would otherwise silently halve the split."""
    if override:
        return int(override)
    return 2 if "Family" in path else 8


def read_images_only(path: str, fovx: float, fovy: Optional[float] = None,
                     resolution: int = -1, do_split: bool = True,
                     sample_rate: Optional[int] = None) -> SceneInfo:
    """A directory of video frames, no poses (the main SfM-free input,
    readImagesOnlyInfo the reference's scene/dataset_readers.py:418-450)."""
    files = sorted(p for p in glob.glob(os.path.join(path, "*"))
                   if p.endswith(IMG_EXTS))
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    w0, h0 = imgcodec.image_size(files[0])
    w, h = _target_resolution(w0, h0, resolution)

    # intrinsics rebuilt at load resolution (loadCam semantics: floor-divided
    # focal, centered principal point)
    scale = int(w0 / w) if w else 1
    fx = fov2focal(fovx, w0) // scale
    fy_full = fov2focal(fovy, h0) if fovy is not None else fov2focal(fovx, w0)
    fy = fy_full // scale
    fovy_eff = fovy if fovy is not None else focal2fov(fy, h)
    K = np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]], np.float32)

    frames = [
        FrameInfo(uid=i, image_path=p,
                  image_name=os.path.splitext(os.path.basename(p))[0],
                  width=w, height=h, intrinsics=K, fovx=fovx, fovy=fovy_eff)
        for i, p in enumerate(files)
    ]
    if do_split:
        i_train, i_test = _split(len(frames),
                                 sample_rate_for(path, sample_rate))
    else:
        i_train, i_test = np.arange(len(frames)), np.array([], dtype=int)
    return SceneInfo(
        train_frames=[frames[i] for i in i_train],
        test_frames=[frames[i] for i in i_test],
        i_train=i_train, i_test=i_test,
        nerf_radius=_nerfpp_radius(frames),
    )


def read_colmap(path: str, images_dir: str = "images", resolution: int = -1,
                do_split: bool = True, sample_rate: Optional[int] = None) -> SceneInfo:
    """COLMAP scene with GT poses (used for pose evaluation,
    readColmapSceneInfo the reference's scene/dataset_readers.py:150-201)."""
    from . import colmap as cl

    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    cams, images, points = cl.read_model(sparse)

    frames = []
    for idx, (img_id, im) in enumerate(
            sorted(images.items(), key=lambda kv: kv[1].name)):
        cam = cams[im.camera_id]
        K0 = cl.camera_intrinsics(cam)
        w, h = _target_resolution(cam.width, cam.height, resolution)
        sx, sy = w / cam.width, h / cam.height
        K = K0.copy()
        K[0] *= sx
        K[1] *= sy
        R = cl.qvec2rotmat(im.qvec)   # w2c rotation
        frames.append(FrameInfo(
            uid=idx,
            image_path=os.path.join(path, images_dir, im.name),
            image_name=os.path.splitext(im.name)[0],
            width=w, height=h, intrinsics=K,
            fovx=focal2fov(K[0, 0], w), fovy=focal2fov(K[1, 1], h),
            R=R.astype(np.float32), T=im.tvec.astype(np.float32)))

    if do_split:
        i_train, i_test = _split(len(frames),
                                 sample_rate_for(path, sample_rate))
    else:
        i_train, i_test = np.arange(len(frames)), np.array([], dtype=int)
    pts, cols = (points[0], points[1]) if points else (None, None)
    return SceneInfo(
        train_frames=[frames[i] for i in i_train],
        test_frames=[frames[i] for i in i_test],
        i_train=i_train, i_test=i_test,
        nerf_radius=_nerfpp_radius(frames),
        points=pts, colors=cols)


def read_blender(path: str, split_file: str = "transforms_train.json",
                 white_background: bool = False,
                 resolution: int = -1) -> SceneInfo:
    """NeRF-synthetic transforms.json scenes (readNerfSyntheticInfo,
    the reference's scene/dataset_readers.py:375-414)."""

    def load(split):
        with open(os.path.join(path, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        frames = []
        for i, fr in enumerate(meta["frames"]):
            img_path = os.path.join(path, fr["file_path"] + ".png")
            w0, h0 = imgcodec.image_size(img_path)
            w, h = _target_resolution(w0, h0, resolution)
            # nerf c2w (OpenGL) -> w2c OpenCV: flip y/z axes
            c2w = np.array(fr["transform_matrix"], dtype=np.float32)
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            fx = fov2focal(fovx, w)
            fovy = focal2fov(fx, h)
            K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]],
                         np.float32)
            frames.append(FrameInfo(
                uid=i, image_path=img_path,
                image_name=os.path.splitext(os.path.basename(img_path))[0],
                width=w, height=h, intrinsics=K, fovx=fovx, fovy=fovy,
                R=w2c[:3, :3], T=w2c[:3, 3]))
        return frames

    train = load("train")
    try:
        test = load("test")
    except FileNotFoundError:
        test = []
    return SceneInfo(train_frames=train, test_frames=test,
                     i_train=np.arange(len(train)),
                     i_test=np.arange(len(train), len(train) + len(test)),
                     nerf_radius=_nerfpp_radius(train))


# ---------------------------------------------------------------------------
# CO3D
# ---------------------------------------------------------------------------

def co3d_ndc_to_opencv(principal_point, focal_length, image_size_hw):
    """pytorch3d NDC-convention camera -> OpenCV K.

    Replaces `opencv_from_cameras_projection`
    (the reference's trainer/trainer.py:104-154): NDC is scaled by half of
    the min image side, centered at the image center, x left / y up flipped.
    """
    h, w = image_size_hw
    half = min(h, w) / 2.0
    px, py = principal_point
    fx, fy = focal_length
    cx = w / 2.0 - px * half
    cy = h / 2.0 - py * half
    return np.array([[fx * half, 0, cx], [0, fy * half, cy], [0, 0, 1]],
                    dtype=np.float32)


def co3d_pose_to_opencv(R_pt3d, T_pt3d):
    """pytorch3d world->view (row-vector, x-left/y-up) -> OpenCV w2c R, t."""
    R = np.asarray(R_pt3d, dtype=np.float32).T
    t = np.asarray(T_pt3d, dtype=np.float32)
    flip = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
    return flip @ R, flip @ t


def read_co3d(data_root: str, category: str, seq_name: str,
              resolution: int = -1, do_split: bool = True) -> SceneInfo:
    """CO3D-v2 sequence via frame_annotations.jgz
    (setup_dataset co3d branch, the reference's trainer/trainer.py:265-298).
    `seq_name` like 'hydrant_106_12648_23157'."""
    subdir = seq_name.split("_")[0]
    subseq = "_".join(seq_name.split("_")[1:])
    ann_path = os.path.join(data_root, category, subdir,
                            "frame_annotations.jgz")
    dataset = json.loads(gzip.GzipFile(ann_path, "rb").read().decode("utf8"))
    seq_data = [d for d in dataset if d["sequence_name"] == subseq]

    frames = []
    for i, d in enumerate(seq_data):
        h, w = d["image"]["size"]
        K = co3d_ndc_to_opencv(d["viewpoint"]["principal_point"],
                               d["viewpoint"]["focal_length"], (h, w))
        R, t = co3d_pose_to_opencv(d["viewpoint"]["R"], d["viewpoint"]["T"])
        tw, th = _target_resolution(w, h, resolution)
        sx, sy = tw / w, th / h
        K = K.copy()
        K[0] *= sx
        K[1] *= sy
        frames.append(FrameInfo(
            uid=i,
            image_path=os.path.join(data_root, d["image"]["path"]),
            image_name=os.path.basename(d["image"]["path"]),
            width=tw, height=th, intrinsics=K,
            fovx=focal2fov(K[0, 0], tw), fovy=focal2fov(K[1, 1], th),
            R=R, T=t,
            depth_path=os.path.join(data_root, d["depth"]["path"])
            if d.get("depth") else None))

    if do_split:
        i_train, i_test = _split(len(frames), 8)
    else:
        i_train, i_test = np.arange(len(frames)), np.array([], dtype=int)
    return SceneInfo(
        train_frames=[frames[i] for i in i_train],
        test_frames=[frames[i] for i in i_test],
        i_train=i_train, i_test=i_test,
        nerf_radius=_nerfpp_radius(frames))


def _nerfpp_radius(frames: List[FrameInfo]) -> float:
    """nerf++ normalization radius from camera centers (getNerfppNorm,
    the reference's scene/dataset_readers.py:52-73). Frames without poses
    (images_only) get radius 1."""
    centers = []
    for f in frames:
        if f.R is None:
            continue
        centers.append(-f.R.T @ f.T)
    if not centers:
        return 1.0
    centers = np.stack(centers)
    center = centers.mean(axis=0)
    diag = np.linalg.norm(centers - center, axis=1).max()
    return float(diag * 1.1)


READERS = {
    "images_only": read_images_only,
    "colmap": read_colmap,
    "tanks": read_colmap,
    "blender": read_blender,
    "co3d": read_co3d,
}
