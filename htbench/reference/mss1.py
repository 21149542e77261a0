"""MSS phase 1 of a root, plainly: the merge that makes the root from its
two children, then steps of which a share is supervised by a pseudo-view,
the image a frozen child renders at a pose between two of the root's
frames.

The merge: each child's rows are pruned by colour importance (the sum over
the child's frames of |d sum(image) / d SH| over the pixel count, the
largest over the coefficients; the prune_ratio share of the rows with the
lowest, ties to the lower row), the second child's kept means are moved
into the root's coordinates by the inverse of the root's pose of its first
frame, and the kept rows are concatenated, the first child's first.

A step draws a frame f of the children's frames, then whether it is a
pseudo step (with probability mss_phase1_ratio), then, for a pseudo step,
alpha in [0, 1). A pseudo step steps back one frame from the last frame,
takes the pose p0 exp(alpha log(p0^-1 p1)) between the root's poses p0 of
frame f and p1 of frame f + 1 (the geodesic on SE(3)), and lets the child
that covers f render it: the last child whose first frame is at or before
f and whose frames hold f. The child's model lives in the coordinates of
its first frame, so it renders at the pose times the inverse of the root's
pose of that frame. The root then takes the step of `train.view_steps`
through the interpolated pose with that render as its target; any other
step is a step on frame f at its pose.

Departures from the reference implementation (3DGS_Hierarchical_Training,
trainer/ht3dgs_trainer.py: get_virtual_view, train_nonleaf_3DGS_phase1 and
the merge):
- the interpolation is lietorch's SE3 Log and Exp, written out in float32
  on unit quaternions (`interpolate`); a pose matrix becomes a quaternion
  by Shepperd's method;
- the importance and the renders go through `splat` (the published
  method's rasterizer written plainly), a pseudo-view clamped to [0, 1], on
  a black background;
- the root's step is `train.view_steps` (its loss, Adam and densify
  statistics), one view a step.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import splat
from . import train as ref

# a pixel of two renders of one pseudo-view agrees when no channel differs
# by more than one 8-bit level
PIXEL_TOL = 1.0 / 255.0
# an entry of two interpolated poses agrees within this share of
# max(1, |entry|): a few float32 roundings
POSE_TOL = 1e-6
# two importances of a row agree within this share: the renders' roundings
# move them by up to ~3e-4 at 64x48 (a pixel's 1/255 gate or 1e-4 stop)
IMPORTANCE_TOL = 1e-3
# lietorch's switch to the series near 0
EPS = 1e-6


# ---------------------------------------------------------------------- #
# SE(3) in float32: a pose is (t [3], q [4] = [x, y, z, w], unit)
def _vec(*xs) -> torch.Tensor:
    return torch.stack([torch.as_tensor(x, dtype=torch.float32)
                        for x in xs])


def _cross(a, b):
    return _vec(a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])


def _unit(q):
    return q / torch.linalg.vector_norm(q)


def _quat_of(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> unit quaternion with w >= 0 (Shepperd: the row of
    the largest of the trace and the diagonal)."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    rows = (
        (tr, (m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1],
              1.0 + tr)),
        (m[0, 0], (1.0 + m[0, 0] - m[1, 1] - m[2, 2], m[0, 1] + m[1, 0],
                   m[0, 2] + m[2, 0], m[2, 1] - m[1, 2])),
        (m[1, 1], (m[0, 1] + m[1, 0], 1.0 - m[0, 0] + m[1, 1] - m[2, 2],
                   m[1, 2] + m[2, 1], m[0, 2] - m[2, 0])),
        (m[2, 2], (m[0, 2] + m[2, 0], m[1, 2] + m[2, 1],
                   1.0 - m[0, 0] - m[1, 1] + m[2, 2], m[1, 0] - m[0, 1])))
    q = _unit(_vec(*max(rows, key=lambda r: float(r[0]))[1]))
    return -q if q[3] < 0 else q


def _qmul(a, b):
    return _unit(_vec(a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1],
                      a[3] * b[1] + a[1] * b[3] + a[2] * b[0] - a[0] * b[2],
                      a[3] * b[2] + a[2] * b[3] + a[0] * b[1] - a[1] * b[0],
                      a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2]))


def _qrot(q, p):
    uv = _cross(q[:3], p)
    uv = uv + uv
    return p + q[3] * uv + _cross(q[:3], uv)


def _hat(p):
    z = torch.zeros((), dtype=torch.float32)
    return torch.stack([_vec(z, -p[2], p[1]), _vec(p[2], z, -p[0]),
                        _vec(-p[1], p[0], z)])


def _so3_exp(phi):
    t2 = (phi * phi).sum()
    t = torch.sqrt(t2)
    if t < EPS:
        im = 0.5 - t2 / 48.0 + t2 * t2 / 3840.0
        re = 1.0 - t2 / 8.0 + t2 * t2 / 384.0
    else:
        im, re = torch.sin(0.5 * t) / t, torch.cos(0.5 * t)
    return _unit(torch.cat([im * phi, re.reshape(1)]))


def _so3_log(q):
    n, w = torch.linalg.vector_norm(q[:3]), q[3]
    if n < EPS:
        f = 2.0 / w - (2.0 / 3.0) * n * n / (w * w * w)
    else:
        f = 2.0 * torch.atan(n / w) / n
    return f * q[:3]


def _jacobian(phi, inverse: bool):
    """SO(3)'s left Jacobian of phi, or its inverse."""
    P = _hat(phi)
    t = torch.linalg.vector_norm(phi)
    if inverse:
        c1 = torch.tensor(-0.5)
        c2 = (torch.tensor(1.0 / 12.0) if t < EPS else
              (1.0 - t * torch.cos(0.5 * t) / (2.0 * torch.sin(0.5 * t)))
              / (t * t))
    elif t < EPS:
        c1, c2 = 0.5 - t * t / 24.0, 1.0 / 6.0 - t * t / 120.0
    else:
        c1 = (1.0 - torch.cos(t)) / (t * t)
        c2 = (t - torch.sin(t)) / (t * t * t)
    return torch.eye(3) + c1 * P + c2 * (P @ P)


def _mul(a, b):
    return a[0] + _qrot(a[1], b[0]), _qmul(a[1], b[1])


def _inv(a):
    qi = torch.cat([-a[1][:3], a[1][3:]])
    return -_qrot(qi, a[0]), qi


def _exp(tau):
    return _jacobian(tau[3:], False) @ tau[:3], _so3_exp(tau[3:])


def _log(a):
    phi = _so3_log(a[1])
    return torch.cat([_jacobian(phi, True) @ a[0], phi])


def interpolate(p0: np.ndarray, p1: np.ndarray, alpha: float) -> np.ndarray:
    """p0 exp(alpha log(p0^-1 p1)) of two w2c poses, 4x4 float32."""
    a, b = ((T[:3, 3], _quat_of(T[:3, :3])) for T in (
        torch.as_tensor(np.asarray(p, np.float32)) for p in (p0, p1)))
    t, q = _mul(a, _exp(_log(_mul(_inv(a), b))
                        * torch.tensor(alpha, dtype=torch.float32)))
    x, y, z, w = q
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = torch.stack([
        _vec(1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)),
        _vec(2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)),
        _vec(2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y))]).numpy()
    out[:3, 3] = t.numpy()
    return out


def poses_off(pose: np.ndarray, ref_pose: np.ndarray) -> int:
    """Entries of a 4x4 pose off the reference's by more than POSE_TOL of
    max(1, |entry|) (all 16 if there is no pose)."""
    if pose is None:
        return 16
    r = np.asarray(ref_pose, np.float64)
    d = np.abs(np.asarray(pose, np.float64) - r)
    return int((d > POSE_TOL * np.maximum(1.0, np.abs(r))).sum())


# ---------------------------------------------------------------------- #
# the merge
def importance(rows: Dict[str, torch.Tensor], poses: np.ndarray,
               frames: Sequence[int], K, height: int, width: int,
               sh_degree: int) -> torch.Tensor:
    """[n] colour importance of a model's rows over its frames (poses in
    its own coordinates)."""
    n, dev = rows["means"].shape[0], rows["means"].device
    live = torch.ones(n, dtype=torch.bool, device=dev)
    acc = torch.zeros(n, 16, 3, device=dev)
    for f in frames:
        cam = splat.Camera(poses[f], K, height, width, dev)
        sh_dc = rows["sh_dc"].detach().requires_grad_(True)
        sh_rest = rows["sh_rest"].detach().requires_grad_(True)
        params = {**rows, "sh_dc": sh_dc, "sh_rest": sh_rest}
        _, scr, _ = splat.project(params, live, cam, sh_degree)
        leaf = {k: scr[k].detach() for k in ("mean", "conic", "op")}
        leaf["color"] = scr["color"].detach().requires_grad_(True)
        pairs, start, count, ntx, nty = splat.tile_lists(
            leaf["mean"], scr["ext"], scr["z"].detach(), height, width)
        # d sum(image) / d image: 1 inside the image, 0 on the tiles' pad
        ones = torch.zeros(nty * splat.TILE, ntx * splat.TILE, 3, device=dev)
        ones[:height, :width] = 1.0
        ones = ones.reshape(nty, splat.TILE, ntx, splat.TILE, 3).transpose(
            1, 2).reshape(ntx * nty, splat.TILE * splat.TILE, 3)
        for tiles, k in splat._blocks(count):
            splat._blend_block(tiles, k, pairs, start, count, ntx,
                               leaf).backward(
                ones[torch.as_tensor(tiles, device=dev)])
        if leaf["color"].grad is None:
            continue
        scr["color"].backward(leaf["color"].grad)
        acc[:, :1] += sh_dc.grad.abs()
        acc[:, 1:] += sh_rest.grad.abs()
    return (acc.reshape(n, -1) / (len(frames) * height * width)).amax(1)


def prune(rows: Dict[str, torch.Tensor], imp: torch.Tensor, ratio: float,
          port_kept=None) -> Dict[str, torch.Tensor]:
    """The rows left when the ratio share with the lowest importance goes
    (ties: the lower row goes first); their order kept. A row whose
    importance lies within IMPORTANCE_TOL of the lowest kept one may go
    either way on the two sides, as its importance rounds: with port_kept
    ([n] bool, the rows the port kept) such a row goes as the port's
    did."""
    n = imp.shape[0]
    order = torch.sort(imp, stable=True)[1]
    k = int(n * ratio)
    keep = torch.ones(n, dtype=torch.bool, device=imp.device)
    keep[order[:k]] = False
    if port_kept is not None and k < n:
        edge = imp[order[k]]
        near = (imp - edge).abs() <= IMPORTANCE_TOL * edge
        keep = torch.where(near, port_kept, keep)
    return {f: x[keep] for f, x in rows.items()}


def _rows_key(rows: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[n, 14] int32: the bits of the fields a merge leaves as they are
    (rotation, scales, DC colour, opacity)."""
    return torch.cat([rows[f].reshape(rows[f].shape[0], -1) for f in
                      ("quats", "log_scales", "sh_dc", "opacity_logit")],
                     1).contiguous().view(torch.int32)


def kept_by(children: List[dict], merged: Dict[str, torch.Tensor]):
    """[n] bool for each child: which of its rows the merged rows hold."""
    key = _rows_key(merged)
    out = []
    for c in children:
        own = _rows_key(c["rows"])
        _, inv = torch.unique(torch.cat([own, key]), dim=0,
                              return_inverse=True)
        held = torch.zeros(int(inv.max()) + 1, dtype=torch.bool,
                           device=inv.device)
        held[inv[own.shape[0]:]] = True
        out.append(held[inv[:own.shape[0]]])
    return out


def merge(children: List[dict], root_poses: np.ndarray, ratio: float, K,
          height: int, width: int, sh_degree: int,
          port_merged=None) -> Dict[str, torch.Tensor]:
    """The root's rows from its two children: each pruned by importance,
    the second's means moved into the root's coordinates, concatenated.
    children: [{"rows", "poses" (in its own coordinates), "start",
    "frames"}]; port_merged: the port's merged rows, which decide only the
    rows at the prune's edge (`prune`)."""
    port_kept = (kept_by(children, port_merged) if port_merged is not None
                 else [None] * len(children))
    kept = [prune(c["rows"], importance(c["rows"], c["poses"], c["frames"],
                                        K, height, width, sh_degree), ratio,
                  pk)
            for c, pk in zip(children, port_kept)]
    # the second child's coordinates are those of its first frame: the
    # root's pose of that frame maps the root's into them, so its inverse
    # (float32, as the poses are held) maps the child's means into the
    # root's, in homogeneous coordinates
    inv = np.linalg.inv(np.asarray(root_poses[children[1]["start"]],
                                   np.float32))
    pts = kept[1]["means"].cpu().numpy()
    hom = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1) @ inv.T
    moved = dict(kept[1], means=torch.as_tensor(
        hom[:, :3] / hom[:, 3:4], device=kept[1]["means"].device))
    return {f: torch.cat([kept[0][f], moved[f]]) for f in kept[0]}


# ---------------------------------------------------------------------- #
# the steps
def draw(rng, indices: Sequence[int], ratio: float):
    """One step's draw: ("pseudo", f, alpha) or ("rgb", f)."""
    f = rng.choice(indices)
    if rng.random() < ratio:
        return ("pseudo", f, rng.random())
    return ("rgb", f)


def child_for(children: List[dict], f: int) -> int:
    """The index of the child that covers frame f: the last whose first
    frame is at or before f and whose frames hold f."""
    for i in range(len(children) - 1, -1, -1):
        c = children[i]
        if f >= c["start"] and f in c["frames"]:
            return i
    raise ValueError(f"no child covers frame {f}")


def pseudo_pose(poses: np.ndarray, indices: Sequence[int], f: int,
                alpha: float) -> np.ndarray:
    """The root's w2c of the pseudo-view of a draw of frame f."""
    if f == indices[-1]:
        f -= 1
    return interpolate(poses[f], poses[f + 1], alpha)


@torch.no_grad()
def render(params: Dict[str, torch.Tensor], cam: splat.Camera,
           sh_degree: int) -> torch.Tensor:
    """[H, W, 3] image of a model's rows (all live), every entry of every
    tile blended, clamped to [0, 1]."""
    live = torch.ones(params["means"].shape[0], dtype=torch.bool,
                      device=params["means"].device)
    _, scr, _ = splat.project(params, live, cam, sh_degree)
    H, W = cam.height, cam.width
    pairs, start, count, ntx, nty = splat.tile_lists(
        scr["mean"], scr["ext"], scr["z"], H, W)
    dev = scr["mean"].device
    rgb = torch.zeros(ntx * nty, splat.TILE * splat.TILE, 3, device=dev)
    for tiles, k in splat._blocks(count):
        rgb[torch.as_tensor(tiles, device=dev)] = splat._blend_block(
            tiles, k, pairs, start, count, ntx, scr)
    return torch.clamp(splat._untile(rgb, nty, ntx, H, W), 0.0, 1.0)


def pseudo_image(children: List[dict], poses: np.ndarray,
                 indices: Sequence[int], f: int, pose: np.ndarray, K,
                 height: int, width: int, sh_degree: int):
    """(the root's camera, the child's render) of the pseudo-view of a draw
    of frame f at the root's w2c `pose` (float32, as the trainer composes
    it with the inverse of the child's first frame's pose)."""
    if f == indices[-1]:
        f -= 1
    c = children[child_for(children, f)]
    pose_child = pose @ np.linalg.inv(poses[c["start"]].astype(np.float32))
    dev = c["rows"]["means"].device
    img = render(c["rows"], splat.Camera(pose_child, K, height, width, dev),
                 sh_degree)
    return splat.Camera(pose, K, height, width, dev), img


def pixels_off(image, ref_image: torch.Tensor) -> int:
    """Pixels of an [H, W, 3] image at which some channel differs from the
    reference's by more than PIXEL_TOL (every pixel, if there is no image
    of its shape)."""
    if image is None or image.shape != ref_image.shape:
        return int(ref_image.shape[0] * ref_image.shape[1])
    d = (image.to(ref_image.device) - ref_image).abs().amax(-1)
    return int((d > PIXEL_TOL).sum())


def target_pose(poses: np.ndarray, indices: Sequence[int], f: int,
                alpha: float, port_pose):
    """(the pose a pseudo-view is rendered at, the entries of the port's
    pose off the reference's): the port's pose where every entry agrees
    within POSE_TOL, so that the rasterizer's steps (the tile rectangles,
    the 1/255 gate, the 1e-4 stop) meet the same pose on both sides and a
    rounding of the pose does not reach the images; the reference's own
    where any entry is off (the pose's count then fails the run)."""
    own = pseudo_pose(poses, indices, f, alpha)
    off = poses_off(port_pose, own)
    return (own if off else np.asarray(port_pose, np.float32)), off


def steps(root: Dict[str, torch.Tensor], children: List[dict],
          poses: np.ndarray, frames: Dict[int, torch.Tensor], draws,
          port_poses, optim: dict, start: int, scale: float, K,
          height: int, width: int, sh_degree: int):
    """The readings of the root's steps over `draws` (`draw`'s) from
    iteration start + 1 (`train.view_steps`), and "count_pseudo_pose": the
    entries of the port's pseudo poses (port_poses, one a draw, None for a
    frame's) off the reference's."""
    indices = sorted({f for c in children for f in c["frames"]})
    dev = root["means"].device
    views, off = [], 0
    for d, port_pose in zip(draws, port_poses):
        if d[0] == "pseudo":
            pose, n = target_pose(poses, indices, d[1], d[2], port_pose)
            off += n
            views.append(pseudo_image(children, poses, indices, d[1], pose,
                                      K, height, width, sh_degree))
        else:
            views.append((splat.Camera(poses[d[1]], K, height, width, dev),
                          frames[d[1]]))
    r = ref.view_steps(root, views, optim, start, scale, sh_degree)
    r["count_pseudo_pose"] = off
    return r
