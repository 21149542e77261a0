"""Plain differentiable Gaussian splatting of one image.

The published method (Kerbl et al. 2023) with the constants of its CUDA
rasterizer: near cull at z 0.2, a 0.3 px blur on the 2D covariance, the
Jacobian's 1.3 tan(fov/2) clamp, alpha = min(0.99, o e^power) counted only
where power <= 0 and alpha >= 1/255, front-to-back blending in depth order
within 16x16 tiles, and a pixel that stops for good before the entry that
would take its transmittance below 1e-4. A Gaussian reaches the tiles of its
rectangle: the half-extents of its alpha >= 1/255 ellipse, capped by the
3-sigma radius of its larger axis, plus a pixel (the rasterizer's getRect
on those extents). Every tensor is float32, and so is every matrix
product, but for the control (`precision.tf32`).

The blend runs tile block by tile block: a forward pass without autograd
gives the image, the loss's gradient on the image comes from autograd, and
each block is then blended again with autograd and its share of that
gradient pushed back to the Gaussians' screen-space values, which carry it
on through the projection. So memory holds one block's intermediates.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .precision import einsum, matmul

NEAR = 0.2
BLUR = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_STOP = 1e-4
TILE = 16
# elements of one [tiles, entries, pixels] tensor in a block
BLOCK_ELEMS = 1 << 23

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """[N, 16] real SH basis of unit directions d [N, 3]; the columns of
    degree > `degree` are zero."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    one = torch.ones_like(x)
    cols = [C0 * one,
            -C1 * y, C1 * z, -C1 * x,
            C2[0] * x * y, C2[1] * y * z, C2[2] * (2 * zz - xx - yy),
            C2[3] * x * z, C2[4] * (xx - yy),
            C3[0] * y * (3 * xx - yy), C3[1] * x * y * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy)]
    n = (degree + 1) ** 2
    cols = cols[:n] + [torch.zeros_like(x)] * (16 - n)
    return torch.stack(cols, -1)


def quat_matrix(q: torch.Tensor) -> torch.Tensor:
    """[N, 4] quaternions [x, y, z, w] (normalised here) -> [N, 3, 3]."""
    q = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-8)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def se3_exp(tau: torch.Tensor):
    """Tangent [6] = [rho, phi] -> (R [3, 3], t [3]) by Rodrigues' formula
    and the left Jacobian, with their series near 0."""
    rho, phi = tau[:3], tau[3:]
    th2 = (phi * phi).sum()
    small = th2 < 1e-8
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = th2s.sqrt()
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / th2s)
    c = torch.where(small, 1.0 / 6 - th2 / 120, (th - torch.sin(th)) / (th2s * th))
    zero = torch.zeros_like(th2)
    Kx = torch.stack([zero, -phi[2], phi[1], phi[2], zero, -phi[0],
                      -phi[1], phi[0], zero]).reshape(3, 3)
    eye = torch.eye(3, device=tau.device)
    KK = matmul(Kx, Kx)
    R = eye + a * Kx + b * KK
    V = eye + b * Kx + c * KK
    return R, matmul(V, rho)


class Camera:
    """A pinhole camera: w2c [4, 4] (float32), intrinsics K [3, 3] (the
    trainer's), image size."""

    def __init__(self, w2c, K, height: int, width: int, device):
        self.w2c = torch.as_tensor(w2c, dtype=torch.float32, device=device)
        K = [float(v) for v in (K[0][0], K[1][1], K[0][2], K[1][2])]
        self.fx, self.fy, self.cx, self.cy = K
        self.height, self.width = int(height), int(width)


def _screen(means, quats, log_scales, opacity_logit, sh, cam: Camera,
            sh_degree: int, pose):
    """Projection of N rows (all of them; the caller selects). Returns a
    dict of [N] screen-space values; z, det and radius say which rows the
    image can hold."""
    R, t = cam.w2c[:3, :3], cam.w2c[:3, 3]
    sh_means = means
    if pose is not None:
        Rp, tp = pose
        means = matmul(means, Rp.T) + tp
        campos = -(Rp.T @ tp).detach()
    else:
        campos = -(R.T @ t)
    pv = matmul(means, R.T) + t
    x, y, z = pv.unbind(-1)
    zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    mx = cam.fx * x / zs + cam.cx - 0.5
    my = cam.fy * y / zs + cam.cy - 0.5
    limx = 1.3 * 0.5 * cam.width / cam.fx
    limy = 1.3 * 0.5 * cam.height / cam.fy
    tx = torch.clamp(x / zs, -limx, limx) * zs
    ty = torch.clamp(y / zs, -limy, limy) * zs
    zero = torch.zeros_like(zs)
    J = torch.stack([cam.fx / zs, zero, -cam.fx * tx / (zs * zs),
                     zero, cam.fy / zs, -cam.fy * ty / (zs * zs)],
                    -1).reshape(-1, 2, 3)
    s = torch.exp(log_scales)
    A = matmul(matmul(J, R), quat_matrix(quats)) * s[:, None, :]
    cov = matmul(A, A.mT)
    c00 = cov[:, 0, 0] + BLUR
    c01 = cov[:, 0, 1]
    c11 = cov[:, 1, 1] + BLUR
    det = c00 * c11 - c01 * c01
    dets = torch.where(det == 0, torch.ones_like(det), det)
    conic = torch.stack([c11 / dets, -c01 / dets, c00 / dets], -1)
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3 * torch.sqrt(torch.clamp(lam, min=0))).detach()
    op = torch.sigmoid(opacity_logit[:, 0])
    d = sh_means - campos
    d = d * torch.rsqrt((d * d).sum(-1, keepdim=True) + 1e-12)
    col = einsum("nk,nkc->nc", sh_basis(d, sh_degree), sh)
    col = torch.clamp(col + 0.5, min=0.0)
    with torch.no_grad():
        lvl = 2 * torch.clamp(torch.log(255 * op.clamp(min=1e-9)), min=0)
        ex = torch.minimum(torch.sqrt(lvl * c00.clamp(min=0)), radius) + 1
        ey = torch.minimum(torch.sqrt(lvl * c11.clamp(min=0)), radius) + 1
    return {"mean": torch.stack([mx, my], -1), "conic": conic, "color": col,
            "op": op, "z": z, "det": det, "radius": radius,
            "ext": torch.stack([ex, ey], -1)}


def project(params: Dict[str, torch.Tensor], live: torch.Tensor,
            cam: Camera, sh_degree: int, pose=None):
    """The rows the image holds (in front of the near plane, a positive
    determinant and radius, opacity >= 1/255), projected with autograd.
    Returns (rows [n] long, screen dict of [n] tensors, visible [N] bool:
    the rows with a radius, which the densify statistics count)."""
    sh = torch.cat([params["sh_dc"], params["sh_rest"]], 1)
    keys = ("means", "quats", "log_scales", "opacity_logit")
    with torch.no_grad():
        s = _screen(*(params[k] for k in keys), sh, cam, sh_degree,
                    None if pose is None else tuple(p.detach()
                                                   for p in pose))
        ok = (s["z"] > NEAR) & (s["det"] > 0) & live
        visible = ok & (s["radius"] > 0)
        rows = torch.nonzero(visible & (s["op"] >= ALPHA_MIN))[:, 0]
    scr = _screen(*(params[k][rows] for k in keys), sh[rows], cam,
                  sh_degree, pose)
    return rows, scr, visible


def tile_lists(mean, ext, z, height: int, width: int):
    """Each row's (row, tile) pairs over its rectangle, in tile order and
    within a tile in depth order (ties by row). Returns (rows of the pairs,
    start [T], count [T], tiles across, tiles down)."""
    ntx, nty = -(-width // TILE), -(-height // TILE)
    x0 = torch.floor((mean[:, 0] - ext[:, 0]) / TILE).clamp(0, ntx).long()
    x1 = torch.floor((mean[:, 0] + ext[:, 0] + TILE - 1) / TILE).clamp(
        0, ntx).long()
    y0 = torch.floor((mean[:, 1] - ext[:, 1]) / TILE).clamp(0, nty).long()
    y1 = torch.floor((mean[:, 1] + ext[:, 1] + TILE - 1) / TILE).clamp(
        0, nty).long()
    sx = (x1 - x0).clamp(min=0)
    span = sx * (y1 - y0).clamp(min=0)
    n = mean.shape[0]
    rank = torch.empty(n, dtype=torch.long, device=mean.device)
    rank[torch.sort(z, stable=True)[1]] = torch.arange(n, device=mean.device)
    row = torch.repeat_interleave(torch.arange(n, device=mean.device), span)
    first = torch.cumsum(span, 0) - span
    local = torch.arange(row.shape[0], device=mean.device) - first[row]
    sxr = sx[row].clamp(min=1)
    tile = (y0[row] + local // sxr) * ntx + x0[row] + local % sxr
    order = torch.sort(tile * n + rank[row])[1]
    T = ntx * nty
    count = torch.bincount(tile, minlength=T)
    start = torch.cumsum(count, 0) - count
    return row[order], start, count, ntx, nty


def _blocks(count: torch.Tensor):
    """Tiles in order of their counts, cut into blocks whose padded
    [tiles, entries, 256] tensors stay under BLOCK_ELEMS."""
    cnt, tiles = torch.sort(count, descending=True)
    cnt = cnt.tolist()
    tiles = tiles.tolist()
    out, i = [], 0
    while i < len(tiles) and cnt[i] > 0:
        k = cnt[i]
        nb = max(1, BLOCK_ELEMS // (k * TILE * TILE))
        out.append((tiles[i:i + nb], k))
        i += nb
    return out


def _blend_block(tiles, k, pairs, start, count, ntx, scr):
    """[nb, 256, 3] colours of a block of tiles, differentiable in scr."""
    dev = start.device
    tl = torch.as_tensor(tiles, device=dev)
    j = torch.arange(k, device=dev)
    m = j[None] < count[tl][:, None]
    g = pairs[(start[tl][:, None] + j[None]).clamp(max=pairs.shape[0] - 1)]
    p = torch.arange(TILE * TILE, device=dev)
    px = ((tl % ntx) * TILE)[:, None, None] + (p % TILE)[None, None]
    py = ((tl // ntx) * TILE)[:, None, None] + (p // TILE)[None, None]
    mean, conic = scr["mean"][g], scr["conic"][g]
    dx = px.float() - mean[..., 0:1]
    dy = py.float() - mean[..., 1:2]
    power = (-0.5 * (conic[..., 0:1] * dx * dx + conic[..., 2:3] * dy * dy)
             - conic[..., 1:2] * dx * dy)
    raw = scr["op"][g][..., None] * torch.exp(power)
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    gate = (power <= 0) & (alpha >= ALPHA_MIN) & m[..., None]
    alpha = torch.where(gate, alpha, torch.zeros_like(alpha))
    om = 1 - alpha
    after = torch.cumprod(om, 1)
    kept = (after >= T_STOP).detach()
    before = torch.cat([torch.ones_like(after[:, :1]), after[:, :-1]], 1)
    w = torch.where(kept, alpha * before, torch.zeros_like(alpha))
    return einsum("bkp,bkc->bpc", w, scr["color"][g])


def _untile(x, nty, ntx, height, width):
    c = x.shape[-1]
    x = x.reshape(nty, ntx, TILE, TILE, c).transpose(1, 2)
    return x.reshape(nty * TILE, ntx * TILE, c)[:height, :width]


def render_and_grad(params, live, cam: Camera, gt, loss_fn, sh_degree: int,
                    pose_tangent: Optional[torch.Tensor] = None):
    """One image's loss and its gradients. params: leaf tensors with
    requires_grad (or pose_tangent a [6] leaf, the model frozen). Adds the
    gradients to the leaves' .grad and returns (loss, image, screen-space
    mean gradient [N, 2] (zeros off the image), visible [N])."""
    pose = se3_exp(pose_tangent) if pose_tangent is not None else None
    rows, scr, visible = project(params, live, cam, sh_degree, pose)
    H, W = cam.height, cam.width
    leaf = {k: scr[k].detach().requires_grad_(True)
            for k in ("mean", "conic", "color", "op")}
    pairs, start, count, ntx, nty = tile_lists(
        scr["mean"].detach(), scr["ext"], scr["z"].detach(), H, W)
    blocks = _blocks(count)
    rgb = torch.zeros(ntx * nty, TILE * TILE, 3, device=gt.device)
    with torch.no_grad():
        for tiles, k in blocks:
            rgb[torch.as_tensor(tiles, device=gt.device)] = _blend_block(
                tiles, k, pairs, start, count, ntx, leaf)
    image = _untile(rgb, nty, ntx, H, W).requires_grad_(True)
    loss = loss_fn(torch.clamp(image, 0.0, 1.0), gt)
    (d_img,) = torch.autograd.grad(loss, [image])
    d_rgb = torch.zeros(nty * TILE, ntx * TILE, 3, device=gt.device)
    d_rgb[:H, :W] = d_img
    d_rgb = d_rgb.reshape(nty, TILE, ntx, TILE, 3).transpose(1, 2).reshape(
        ntx * nty, TILE * TILE, 3)
    for tiles, k in blocks:
        out = _blend_block(tiles, k, pairs, start, count, ntx, leaf)
        out.backward(d_rgb[torch.as_tensor(tiles, device=gt.device)])
    back = [(scr[k], leaf[k].grad) for k in leaf
            if leaf[k].grad is not None and scr[k].requires_grad]
    torch.autograd.backward([o for o, _ in back], [g for _, g in back])
    mean_grad = torch.zeros(live.shape[0], 2, device=gt.device)
    if leaf["mean"].grad is not None:
        mean_grad[rows] = leaf["mean"].grad
    return loss.detach(), image.detach(), mean_grad, visible
