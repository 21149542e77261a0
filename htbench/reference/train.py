"""The trainer's recipe, plainly: a model from one frame's depth, Adam, the
learning rates, and the steps of the cells (a fit of a model to its frame,
a pose fit against a frozen model, a step of a model through a posed
camera with the densification statistics).

Densification follows the adaptive density control of 3D Gaussian
splatting (Kerbl et al. 2023, densify_and_prune) as the trainer states it:
a row is hot where its mean screen-space gradient reaches the threshold;
a hot row no larger than percent_dense of the scene extent is cloned, a
larger one split into two children drawn from its own Gaussian at 1/1.6
of its size; rows of opacity under MIN_OPACITY are pruned (and, past the
first opacity reset, rows larger than a tenth of the extent), children by
their own size.

The init follows the reference trainer (3DGS_Hierarchical_Training,
trainer.py prepare_data_from_viewpoint): the depth map unprojected through
K on the integer pixel grid (in float64, then float32), coloured by the
frame, averaged per 0.01 voxel with the voxels in lexicographic order; each
point a Gaussian of isotropic size from the mean squared distance to its 3
nearest neighbours (at least 1e-7), identity rotation, opacity 0.1, SH DC
from its colour and the rest zero.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy.spatial import cKDTree

from . import splat
from .loss import photometric

FIELDS = ("means", "quats", "log_scales", "sh_dc", "sh_rest",
          "opacity_logit")
BETA1, BETA2, EPS = 0.9, 0.999, 1e-15
MIN_OPACITY = 0.005
SPLIT_SHRINK = 1.6


def cloud(rgb: torch.Tensor, depth: torch.Tensor, K, voxel: float = 0.01):
    """(points [n, 3], colours [n, 3]) of one frame, on its device."""
    H, W = depth.shape
    dev = depth.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float64),
                            torch.arange(W, device=dev, dtype=torch.float64),
                            indexing="ij")
    d = depth.double()
    fx, fy = float(np.float32(K[0][0])), float(np.float32(K[1][1]))
    cx, cy = float(np.float32(K[0][2])), float(np.float32(K[1][2]))
    pts = torch.stack([(xs - cx) / fx * d, (ys - cy) / fy * d, d],
                      -1).reshape(-1, 3).float()
    col = rgb.reshape(-1, 3).float()
    # a true division, as numpy's (a scalar divisor on the card would be
    # a multiplication by its reciprocal, which rounds otherwise)
    vox = torch.floor(pts / torch.full_like(pts, voxel)).long()
    _, inv, cnt = torch.unique(vox, dim=0, return_inverse=True,
                               return_counts=True)
    n = cnt.shape[0]
    p = torch.zeros(n, 3, dtype=torch.float64, device=dev).index_add_(
        0, inv, pts.double())
    c = torch.zeros(n, 3, dtype=torch.float64, device=dev).index_add_(
        0, inv, col.double())
    return (p / cnt[:, None]).float(), (c / cnt[:, None]).float()


def model(points: torch.Tensor, colors: torch.Tensor, max_degree: int = 3
          ) -> Dict[str, torch.Tensor]:
    """The init model of a cloud, one row a point (no padding)."""
    n, dev = points.shape[0], points.device
    pts = points.cpu().numpy()
    d, _ = cKDTree(pts).query(pts, k=4, workers=-1)
    dist2 = np.maximum((d[:, 1:] ** 2).mean(axis=1).astype(np.float32), 1e-7)
    ls = torch.as_tensor(0.5 * np.log(dist2), device=dev)
    quats = torch.zeros(n, 4, device=dev)
    quats[:, 3] = 1
    return {
        "means": points.clone(), "quats": quats,
        "log_scales": ls[:, None].repeat(1, 3),
        "sh_dc": ((colors - 0.5) / splat.C0)[:, None, :],
        "sh_rest": torch.zeros(n, (max_degree + 1) ** 2 - 1, 3, device=dev),
        "opacity_logit": torch.full((n, 1), math.log(0.1 / 0.9), device=dev),
    }


def radius(points: torch.Tensor) -> float:
    """The scene extent a model's position learning rate is scaled by."""
    return float(points.norm(dim=1).max())


def expon_lr(step: int, lr_init: float, lr_final: float,
             max_steps: int) -> float:
    """Log-linear from lr_init at step 0 to lr_final at max_steps."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


class Adam:
    """torch.optim.Adam's arithmetic (eps 1e-15) with per-group rates."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params, grads, lrs) -> Dict[str, torch.Tensor]:
        self.t += 1
        b1, b2 = 1 - BETA1 ** self.t, 1 - BETA2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = BETA1 * self.m[k] + (1 - BETA1) * g
            self.v[k] = BETA2 * self.v[k] + (1 - BETA2) * g * g
            out[k] = p - lrs[k] * (self.m[k] / b1) / (
                torch.sqrt(self.v[k] / b2) + EPS)
        return out


def lrs(optim: dict, it: int, scale: float) -> dict:
    """The learning rates of a step at iteration `it` (1-based) for a
    model of extent `scale`."""
    o = optim
    means = expon_lr(it, o["position_lr_init"] * scale,
                     o["position_lr_final"] * scale,
                     o["position_lr_max_steps"])
    return {"means": means,
            "sh_dc": o["feature_lr"], "sh_rest": o["feature_lr"] / 20.0,
            "opacity_logit": o["opacity_lr"],
            "log_scales": o["scaling_lr"], "quats": o["rotation_lr"]}


def grad_step(params, live, cam, gt, sh_degree, lambda_dssim):
    """(loss, grads {field: tensor}, mean gradient [N, 2], visible [N]) of
    one image."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    loss, _, mg, vis = splat.render_and_grad(
        leaves, live, cam, gt, lambda i, g: photometric(i, g, lambda_dssim),
        sh_degree)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return loss, grads, mg, vis


def finite(g: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def fit(models: List[dict], cams, gts, optim: dict, n_steps: int,
        lambda_dssim: float):
    """n_steps of Phase A's fit of each model to its frame (sh degree 0,
    non-finite gradients zeroed, the position rate at the 1-based step).
    Returns (models after, per-step losses [n_steps][B], first gradients
    [B] of {field: tensor})."""
    B = len(models)
    losses = [[0.0] * B for _ in range(n_steps)]
    first, out = [], []
    for b in range(B):
        p = {k: models[b][k] for k in FIELDS}
        live = torch.ones(p["means"].shape[0], dtype=torch.bool,
                          device=p["means"].device)
        opt = Adam(p)
        scale = models[b]["radius"]
        for s in range(n_steps):
            loss, g, _, _ = grad_step(p, live, cams[b], gts[b], 0,
                                      lambda_dssim)
            g = {k: finite(v) for k, v in g.items()}
            if s == 0:
                first.append(g)
            losses[s][b] = float(loss)
            p = opt.step(p, g, lrs(optim, s + 1, scale))
        out.append(dict(p, radius=scale))
    return out, losses, first


def pose_fit(models: List[dict], cams, gts, lr: float, n_steps: int,
             lambda_dssim: float):
    """n_steps of the pose fit of each frozen model against its frame from
    the identity. Returns (tangents [B, 6], per-step losses, first
    gradients [B, 6])."""
    B = len(models)
    losses = [[0.0] * B for _ in range(n_steps)]
    taus, first = [], []
    for b in range(B):
        p = {k: models[b][k] for k in FIELDS}
        live = torch.ones(p["means"].shape[0], dtype=torch.bool,
                          device=p["means"].device)
        tau = torch.zeros(6, device=p["means"].device)
        opt = Adam({"pose": tau})
        for s in range(n_steps):
            leaf = tau.clone().requires_grad_(True)
            loss, _, _, _ = splat.render_and_grad(
                p, live, cams[b], gts[b],
                lambda i, g: photometric(i, g, lambda_dssim), 0,
                pose_tangent=leaf)
            g = finite(leaf.grad)
            if s == 0:
                first.append(g)
            losses[s][b] = float(loss)
            tau = opt.step({"pose": tau}, {"pose": g}, {"pose": lr})["pose"]
        taus.append(tau)
    return torch.stack(taus), losses, torch.stack(first)


@torch.no_grad()
def densify(p: Dict[str, torch.Tensor], accum: torch.Tensor,
            denom: torch.Tensor, optim: dict, extent: float, screen: bool,
            gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The rows after one densify/prune of rows p with statistics
    (accum, denom): the kept rows, their clones and the split children."""
    grads = torch.where(denom > 0, accum / denom.clamp(min=1.0), 0.0)
    scales = torch.exp(p["log_scales"])
    size = scales.amax(-1)
    big = size > optim["percent_dense"] * extent
    low = torch.sigmoid(p["opacity_logit"][:, 0]) < MIN_OPACITY
    hot = grads >= optim["densify_grad_threshold"]
    prune = low | (size > 0.1 * extent) if screen else low
    split = hot & big
    keep, clone = ~split & ~prune, hot & ~big & ~prune
    child = dict(p, log_scales=p["log_scales"] - math.log(SPLIT_SHRINK))
    child_big = torch.exp(child["log_scales"]).amax(-1) > 0.1 * extent
    child_keep = split & ~(low | child_big if screen else low)
    R = splat.quat_matrix(p["quats"])
    out = {f: [p[f][keep], p[f][clone]] for f in p}
    for _ in range(2):
        noise = torch.randn(p["means"].shape, generator=gen,
                            device=p["means"].device)
        offset = (R @ (noise * scales)[..., None])[..., 0]
        for f in p:
            x = p[f] + offset if f == "means" else child[f]
            out[f].append(x[child_keep])
    return {f: torch.cat(v) for f, v in out.items()}


def view_steps(params: Dict[str, torch.Tensor], views, optim: dict,
               start: int, scale: float, sh_degree: int,
               densify_gen: Optional[torch.Generator] = None):
    """Steps of one model over views [(camera, frame)] from iteration
    start + 1, with the densification statistics the trainer keeps
    (|dL/d mean| in its NDC-scaled units and the count of steps a row had
    a radius). Returns the readings: per-step losses, the first step's
    gradient norms, the change after the last step and the statistics.
    With densify_gen the last step is a densify step: it updates no
    parameter, and its statistics densify the model (`densify`, the split
    noise drawn from densify_gen); the readings then hold the densify
    step's (`compare.densify_readings`)."""
    from ..compare import densify_readings, norm

    n = params["means"].shape[0]
    dev = params["means"].device
    p = {f: params[f].clone() for f in FIELDS}
    live = torch.ones(n, dtype=torch.bool, device=dev)
    opt = Adam(p)
    accum = torch.zeros(n, device=dev)
    denom = torch.zeros(n, device=dev)
    r = {"loss": []}
    for s, (cam, gt) in enumerate(views):
        loss, g, mg, vis = grad_step(p, live, cam, gt, sh_degree,
                                     optim["lambda_dssim"])
        half = torch.tensor([0.5 * cam.width, 0.5 * cam.height], device=dev)
        accum += torch.where(vis, (mg * half).norm(dim=1), 0.0)
        denom += vis.float()
        if s == 0:
            r["grad"] = {f: norm(g[f]) for f in FIELDS}
        r["loss"].append([float(loss)])
        if densify_gen is None or s + 1 < len(views):
            p = opt.step(p, g, lrs(optim, start + s + 1, scale))
    r["change"] = {f: norm(p[f] - params[f]) for f in FIELDS}
    r["stats"] = {"accum": norm(accum), "denom": norm(denom)}
    if densify_gen is not None:
        it = start + len(views)
        after = densify(p, accum, denom, optim, scale,
                        it > optim["opacity_reset_interval"], densify_gen)
        r["densify"] = densify_readings(p, after)
    return r
