"""The benchmark's scenes, made on the device from `--seed`.

A PyTorch copy of the port's photo scene (`ht3dgs_torch/utils/photo_scene.py`):
three fronto-parallel planes textured with a real photograph (Grace Hopper,
public domain; `assets/photo.npz` holds its decoded 600x512 RGB bytes) at
depths 8, 5 and 3.2, seen by a pinhole camera along a smooth dolly-arc
trajectory, with exact depth maps and, for each pair of consecutive train
frames, the frame at their midpoint pose (the stand-in for a VFI frame).

The seed changes what the planes show (the crop of the photograph, a mirror
and an order of the colour channels per plane), never the geometry: every
seed gives the same trajectory, the same depth maps and so the same
point-cloud sizes, so the work of a cell does not move with the seed.

`trained_root` is the trained-statistics model of the JAX package's
`bench.py` (bimodal opacities, 3-NN-free sizes) with its Gaussians on the
scene's surfaces, for the cells that start from a trained model.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

_PHOTO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                      "photo.npz")

# (depth z, centre (x, y), world width, crop rows, crop cols) of each plane,
# the crops as fractions of the photograph (photo_scene.default_planes)
_PLANES = ((8.0, (0.0, 0.0), 14.0, (0.0, 1.0), (0.0, 1.0)),
           (5.0, (-1.2, -0.6), 4.5, (0.0, 0.5), (0.0, 0.5)),
           (3.2, (1.1, 0.7), 2.6, (1.0 / 3.0, 1.0), (1.0 / 3.0, 1.0)))


def photo(device) -> torch.Tensor:
    with np.load(_PHOTO) as z:
        a = z["photo"]
    return torch.as_tensor(a, device=device).float() / 255.0


@dataclass
class Plane:
    tex: torch.Tensor    # [th, tw, 3]
    z: float
    center: tuple
    width: float


def planes(seed: int, device) -> List[Plane]:
    """The three planes; the seed picks each plane's crop offset within the
    photograph (same crop size), a mirror and a channel order."""
    img = photo(device)
    h, w, _ = img.shape
    g = np.random.default_rng(seed)
    out = []
    for z, c, width, (r0, r1), (c0, c1) in _PLANES:
        th, tw = int(round((r1 - r0) * h)), int(round((c1 - c0) * w))
        y = int(g.integers(0, h - th + 1))
        x = int(g.integers(0, w - tw + 1))
        tex = img[y:y + th, x:x + tw]
        if g.random() < 0.5:
            tex = tex.flip(1)
        tex = tex[..., torch.as_tensor(g.permutation(3), device=device)]
        out.append(Plane(tex.contiguous(), z, c, width))
    return out


def trajectory(n_frames: int, radius: float = 0.35,
               forward: float = 0.8) -> np.ndarray:
    """[F, 4, 4] w2c (float64), frame 0 the identity
    (photo_scene.camera_trajectory)."""
    poses = []
    for i in range(n_frames):
        a = i / max(n_frames - 1, 1)
        cx = radius * np.sin(np.pi * a)
        cy = 0.4 * radius * np.sin(2.0 * np.pi * a)
        cz = forward * a
        yaw = 0.12 * np.sin(np.pi * a)
        pitch = 0.05 * np.sin(2.0 * np.pi * a)
        Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]])
        Rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)],
                       [0, np.sin(pitch), np.cos(pitch)]])
        c2w = np.eye(4)
        c2w[:3, :3] = Ry @ Rx
        c2w[:3, 3] = [cx, cy, cz]
        poses.append(np.linalg.inv(c2w))
    inv0 = np.linalg.inv(poses[0])
    return np.stack([p @ inv0 for p in poses])


def _quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion [w, x, y, z], w >= 0."""
    m = R
    tr = np.trace(m)
    cands = np.array([
        [1 + tr, m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]],
        [m[2, 1] - m[1, 2], 1 + m[0, 0] - m[1, 1] - m[2, 2],
         m[0, 1] + m[1, 0], m[0, 2] + m[2, 0]],
        [m[0, 2] - m[2, 0], m[0, 1] + m[1, 0],
         1 - m[0, 0] + m[1, 1] - m[2, 2], m[1, 2] + m[2, 1]],
        [m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1],
         1 - m[0, 0] - m[1, 1] + m[2, 2]]])
    q = cands[int(np.argmax([tr, m[0, 0], m[1, 1], m[2, 2]]))]
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def _rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def midpoint_pose(w2c_a: np.ndarray, w2c_b: np.ndarray) -> np.ndarray:
    """The w2c pose halfway between two: the rotations' slerp at 1/2 and
    the mean of the camera centres (photo_scene.midpoint_pose)."""
    ca, cb = np.linalg.inv(w2c_a), np.linalg.inv(w2c_b)
    qa, qb = _quat(ca[:3, :3]), _quat(cb[:3, :3])
    q = qa + (qb if qa @ qb >= 0 else -qb)
    c2w = np.eye(4)
    c2w[:3, :3] = _rot(q / np.linalg.norm(q))
    c2w[:3, 3] = 0.5 * (ca[:3, 3] + cb[:3, 3])
    return np.linalg.inv(c2w)


def render(pl: List[Plane], w2c: np.ndarray, K: np.ndarray, height: int,
           width: int, device):
    """Exact pinhole rendering of the planes (photo_scene.render_frame):
    (rgb [H, W, 3] float32, depth [H, W] float32) on the device. Pixels
    that hit no plane take the far plane's border colour."""
    f64 = torch.float64
    c2w = torch.as_tensor(np.linalg.inv(w2c), dtype=f64, device=device)
    w2c_t = torch.as_tensor(w2c, dtype=f64, device=device)
    R, o = c2w[:3, :3], c2w[:3, 3]
    fx, fy, cx, cy = (float(v) for v in (K[0, 0], K[1, 1], K[0, 2],
                                         K[1, 2]))
    py, px = torch.meshgrid(torch.arange(height, dtype=f64, device=device),
                            torch.arange(width, dtype=f64, device=device),
                            indexing="ij")
    d = torch.stack([(px - cx) / fx, (py - cy) / fy, torch.ones_like(px)],
                    -1) @ R.T
    rgb = torch.zeros(height, width, 3, device=device)
    dep = torch.zeros(height, width, device=device)
    filled = torch.zeros(height, width, dtype=torch.bool, device=device)

    def hit(p: Plane):
        dz = d[..., 2]
        s = (p.z - o[2]) / torch.where(dz.abs() > 1e-9, dz,
                                       torch.full_like(dz, 1e-9))
        X = o[0] + s * d[..., 0]
        Y = o[1] + s * d[..., 1]
        th, tw, _ = p.tex.shape
        u = (X - p.center[0]) / p.width + 0.5
        v = (Y - p.center[1]) / (p.width * th / tw) + 0.5
        z_cam = (w2c_t[2, 0] * X + w2c_t[2, 1] * Y + w2c_t[2, 2] * p.z
                 + w2c_t[2, 3]).float()
        return s, u, v, z_cam

    for p in sorted(pl, key=lambda p: p.z):
        s, u, v, z_cam = hit(p)
        inside = (s > 1e-6) & (u >= 0) & (u < 1) & (v >= 0) & (v < 1) \
            & ~filled
        th, tw, _ = p.tex.shape
        fu = (u * (tw - 1)).clamp(0, tw - 1.000001)
        fv = (v * (th - 1)).clamp(0, th - 1.000001)
        x0, y0 = fu.long(), fv.long()
        x1, y1 = (x0 + 1).clamp(max=tw - 1), (y0 + 1).clamp(max=th - 1)
        wx = (fu - x0)[..., None].float()
        wy = (fv - y0)[..., None].float()
        t = p.tex
        c = (t[y0, x0] * (1 - wx) * (1 - wy) + t[y0, x1] * wx * (1 - wy)
             + t[y1, x0] * (1 - wx) * wy + t[y1, x1] * wx * wy)
        rgb = torch.where(inside[..., None], c, rgb)
        dep = torch.where(inside, z_cam, dep)
        filled |= inside
    bg = max(pl, key=lambda p: p.z)
    _, u, v, z_cam = hit(bg)
    th, tw, _ = bg.tex.shape
    x0 = (u.clamp(0, 1) * (tw - 1)).long().clamp(0, tw - 1)
    y0 = (v.clamp(0, 1) * (th - 1)).long().clamp(0, th - 1)
    rgb = torch.where(filled[..., None], rgb, bg.tex[y0, x0])
    dep = torch.where(filled, dep, z_cam)
    return rgb, dep


def quantize(rgb: torch.Tensor) -> torch.Tensor:
    """As a frame read from an 8-bit file: (rgb * 255) truncated, / 255."""
    return (rgb * 255).to(torch.uint8).float() / 255.0


def split(n: int, stride: int):
    """The readers' train/test split: every stride-th frame from
    stride // 2 is a test frame."""
    test = set(range(stride // 2, n, stride))
    return [i for i in range(n) if i not in test]


@dataclass
class Scene:
    """The train frames of one configuration, as the trainer indexes them
    (0..F-1), on the host as float32, with the device copies beside."""

    K_true: np.ndarray           # the intrinsics the frames were made with
    K: np.ndarray                # the intrinsics the trainer is given
    height: int
    width: int
    poses: np.ndarray            # [F, 4, 4] w2c of the train frames
    mid_poses: np.ndarray        # [F-1, 4, 4] midpoint of train k, k+1
    rgb: Dict[int, torch.Tensor]       # train frame k (device)
    depth: Dict[int, torch.Tensor]
    vfi: Dict[int, torch.Tensor]       # midpoint frame of k, k+1
    vfi_depth: Dict[int, torch.Tensor]

    @property
    def n_frames(self) -> int:
        return len(self.poses)


def intrinsics(cfg: dict):
    """(K the frames are made with, K the port's reader derives) of a
    configuration's scene: a horizontal field of view with the reader's
    floor-divided focal (images_only), or a CO3D camera in pytorch3d's NDC
    convention."""
    sc = cfg["scene"]
    H, W = sc["height"], sc["width"]
    if "fovx" in sc:
        fx = W / (2.0 * math.tan(sc["fovx"] / 2.0))
        K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]])
        Kr = K.copy()
        Kr[0, 0] = Kr[1, 1] = math.floor(fx)
        return K, Kr.astype(np.float32)
    half = min(H, W) / 2.0
    (fx, fy), (px, py) = sc["focal_ndc"], sc["principal_ndc"]
    K = np.array([[fx * half, 0, W / 2.0 - px * half],
                  [0, fy * half, H / 2.0 - py * half], [0, 0, 1]])
    return K, K.astype(np.float32)


def make_scene(cfg: dict, seed: int, device, frames=None,
               mids=None) -> Scene:
    """The train frames `frames` (default: all) and midpoint frames `mids`
    (default: all) of the configuration's scene, rendered on the device."""
    sc = cfg["scene"]
    H, W = sc["height"], sc["width"]
    K, Kr = intrinsics(cfg)
    all_poses = trajectory(sc["n_frames"])
    train = split(sc["n_frames"], sc["test_stride"])
    poses = all_poses[train]
    mid_poses = np.stack([midpoint_pose(poses[k], poses[k + 1])
                          for k in range(len(poses) - 1)])
    pl = planes(seed, device)
    frames = range(len(poses)) if frames is None else frames
    mids = range(len(poses) - 1) if mids is None else mids
    rgb, depth, vfi, vfi_depth = {}, {}, {}, {}
    for k in frames:
        c, d = render(pl, poses[k], K, H, W, device)
        rgb[k], depth[k] = quantize(c), d
    for k in mids:
        c, d = render(pl, mid_poses[k], K, H, W, device)
        vfi[k], vfi_depth[k] = quantize(c), d
    return Scene(K, Kr, H, W, poses.astype(np.float32),
                 mid_poses.astype(np.float32), rgb, depth, vfi, vfi_depth)


def trained_root(scene: Scene, n_rows: int, capacity: int, sh_degree: int,
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """A model with a trained model's statistics (the JAX package's
    bench.py:115-158: opacities 45% in [0.6, 0.99], 30% in [0.15, 0.6],
    25% in [0.01, 0.15]) whose n_rows Gaussians lie on the scene's
    surfaces: each at a pixel of a train frame drawn from the seed,
    unprojected through its depth, coloured by the frame, flattened along
    the view ray, with sizes of a few pixels' footprint and random
    rotations; SH rest small and decaying by degree. Rows past n_rows are
    dead. Made by a few large calls of a generator on the device."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    n, F = n_rows, scene.n_frames
    K = torch.as_tensor(scene.K_true, dtype=torch.float32, device=device)
    fr = torch.randint(0, F, (n,), generator=g, device=device)
    py = torch.randint(0, scene.height, (n,), generator=g, device=device)
    px = torch.randint(0, scene.width, (n,), generator=g, device=device)
    depth = torch.stack([scene.depth[k] for k in range(F)])
    rgb = torch.stack([scene.rgb[k] for k in range(F)])
    z = depth[fr, py, px]
    cam = torch.stack([(px.float() - K[0, 2]) / K[0, 0] * z,
                       (py.float() - K[1, 2]) / K[1, 1] * z, z], -1)
    c2w = torch.linalg.inv(torch.as_tensor(scene.poses, device=device))[fr]
    pts = (c2w[:, :3, :3] @ cam[:, :, None])[..., 0] + c2w[:, :3, 3]
    col = rgb[fr, py, px]
    # footprint of ~1.5 px at the point's depth, log-normal spread, the
    # third axis a tenth (a trained surface Gaussian is flat)
    foot = 1.5 * z / K[0, 0]
    s = foot[:, None] * torch.exp(0.5 * torch.randn(n, 3, generator=g,
                                                    device=device))
    s[:, 2] *= 0.1
    q = torch.randn(n, 4, generator=g, device=device)
    q = q / q.norm(dim=-1, keepdim=True)
    u = torch.rand(n, generator=g, device=device)
    r = torch.rand(n, generator=g, device=device)
    op = torch.where(u < 0.45, 0.60 + 0.39 * r,
                     torch.where(u < 0.75, 0.15 + 0.45 * r, 0.01 + 0.14 * r))
    nk = (sh_degree + 1) ** 2 - 1
    rest = 0.05 * torch.randn(n, nk, 3, generator=g, device=device)
    deg = torch.arange(1, nk + 1, device=device).float().sqrt().floor()
    rest = rest / deg[None, :, None]

    def pad(x, fill=0.0):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=device)
        out[:n] = x
        return out

    quats = pad(q)
    quats[n:, 3] = 1.0
    C0 = 0.28209479177387814
    return {
        "means": pad(pts), "quats": quats,
        "log_scales": pad(torch.log(s), -10.0),
        "sh_dc": pad(((col - 0.5) / C0)[:, None, :]),
        "sh_rest": pad(rest),
        "opacity_logit": pad(torch.log(op / (1 - op))[:, None],
                             math.log(0.1 / 0.9)),
        "live": pad(torch.ones(n, dtype=torch.bool, device=device), False),
    }
