"""Phase A: fits of B local models and B relative poses, model by model.

Counterpart of `ht3dgs.train.phase_a`. The JAX package vmaps the B models
of a batch through one compiled loop; the blend kernels here do not vmap,
so one iteration steps each model in turn, with the same semantics:
- a model's early stop (PSNR > 35 after `stop_after` iterations) is
  decided every iteration from that iteration's render, on the device, and
  a stopped model keeps its parameters, moments and step from then on;
- non-finite gradients are zeroed before Adam;
- the xyz learning rate follows the 1-based iteration, as the sequential
  `fit_single_image` does.
The batch is a Python list of models (no stacking). The host reads the
stop flags every `poll` iterations, only to skip the work of stopped
models, whose results the selection already keeps.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..core import adam as adam_lib
from ..core.camera import Camera
from ..core.gaussians import PARAM_FIELDS, GaussianState
from ..core.se3 import se3_retr
from ..raster import render
from .losses import compute_loss, psnr

# iterations between the host's reads of the early-stop flags
POLL = 25


def _finite(g: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if g is None:
        return torch.zeros_like(like)
    return torch.where(torch.isfinite(g), g, 0.0)


def _fit_step(state: GaussianState, opt: adam_lib.AdamState, camera: Camera,
              gt: torch.Tensor, lrs, *, mode, tile_args, lambda_dssim):
    params = {f: getattr(state, f).detach().requires_grad_(True)
              for f in PARAM_FIELDS}
    out = render(state.replace_params(params), camera, mode=mode,
                 tile_args=tile_args)
    ld = compute_loss(out["image"], gt, lambda_dssim=lambda_dssim)
    g = torch.autograd.grad(ld["loss"], list(params.values()),
                            allow_unused=True)
    grads = {f: _finite(gx, params[f]) for f, gx in zip(PARAM_FIELDS, g)}
    new_params, new_opt = adam_lib.apply(
        {f: p.detach() for f, p in params.items()}, grads, opt, lrs)
    with torch.no_grad():
        ps = psnr(out["image"], gt)
    return state.replace_params(new_params), new_opt, ps


@torch.no_grad()
def _select(active: torch.Tensor, new_state, new_opt, state, opt):
    def sel(n, o):
        return torch.where(active, n, o)

    params = {f: sel(getattr(new_state, f), getattr(state, f))
              for f in PARAM_FIELDS}
    return state.replace_params(params), adam_lib.AdamState(
        m={k: sel(new_opt.m[k], opt.m[k]) for k in opt.m},
        v={k: sel(new_opt.v[k], opt.v[k]) for k in opt.v},
        step=sel(new_opt.step, opt.step))


def batched_fit(states: Sequence[GaussianState],
                opts: Sequence[adam_lib.AdamState],
                cameras: Sequence[Camera], gts: Sequence[torch.Tensor],
                lr_args, *, mode="auto", tile_args=None, lambda_dssim=0.2,
                n_iters=1000, early_stop=True, stop_after=None, poll=POLL):
    """Fit B local models to their target frames.

    lr_args: (lr_init_xyz [B], lr_final_xyz [B], max_steps, fixed_lrs dict
    of [B] per-group learning rates for the other groups).
    Returns (states, opts) as lists.
    """
    states, opts = list(states), list(opts)
    B = len(states)
    lr_init, lr_final, max_steps, fixed = lr_args
    if stop_after is None:
        # early stop after min(500, iterations // 2), as the sequential path
        stop_after = min(500, n_iters // 2)
    dev = states[0].device
    active = [torch.ones((), dtype=torch.bool, device=dev) for _ in range(B)]
    running = [True] * B
    for g in range(n_iters):
        for b in range(B):
            if not running[b]:
                continue
            lrs = {k: float(v[b]) for k, v in fixed.items()}
            lrs["means"] = adam_lib.expon_lr(g + 1, float(lr_init[b]),
                                             float(lr_final[b]),
                                             max_steps=max_steps)
            new_s, new_o, ps = _fit_step(
                states[b], opts[b], cameras[b], gts[b], lrs, mode=mode,
                tile_args=tile_args, lambda_dssim=lambda_dssim)
            states[b], opts[b] = _select(active[b], new_s, new_o, states[b],
                                         opts[b])
            if early_stop and g + 1 > stop_after:
                active[b] = active[b] & ~(ps > 35.0)
        if early_stop and (g + 1) % poll == 0:
            running = torch.stack(active).tolist()
    return states, opts


def _pose_step(state, delta, base, opt, camera, gt, lr, *, mode, tile_args,
               lambda_dssim):
    delta = delta.detach().requires_grad_(True)
    out = render(state, camera, pose=se3_retr(delta, base), mode=mode,
                 tile_args=tile_args)
    ld = compute_loss(out["image"], gt, lambda_dssim=lambda_dssim)
    (g,) = torch.autograd.grad(ld["loss"], [delta])
    params, new_opt = adam_lib.apply({"pose": delta.detach()},
                                     {"pose": _finite(g, delta)}, opt,
                                     {"pose": lr})
    return params["pose"], new_opt


def batched_pose_fit(states, bases: torch.Tensor,
                     cameras: Sequence[Camera], gts: Sequence[torch.Tensor],
                     lr, *, mode="auto", tile_args=None, lambda_dssim=0.2,
                     n_iters=300, shared_state=False,
                     deltas0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Optimize B SE(3) tangents against B frozen models. Returns [B, 6].

    shared_state=True: `states` is ONE frozen model that serves every pose.
    deltas0: warm-start tangents (the coarse-to-fine wrapper's fine stage).
    """
    B = len(gts)
    models = [states] * B if shared_state else list(states)
    dev = bases.device
    deltas: List[torch.Tensor] = (
        [torch.zeros(6, device=dev) for _ in range(B)] if deltas0 is None
        else list(deltas0.detach().unbind(0)))
    opts = [adam_lib.init({"pose": torch.zeros(6, device=dev)})
            for _ in range(B)]
    for _ in range(n_iters):
        for b in range(B):
            deltas[b], opts[b] = _pose_step(
                models[b], deltas[b], bases[b], opts[b], cameras[b], gts[b],
                lr, mode=mode, tile_args=tile_args,
                lambda_dssim=lambda_dssim)
    return torch.stack(deltas)


def downscale_camera(cam: Camera, f: int) -> Camera:
    """Integer-divisor pyramid camera: same FoV, 1/f resolution."""
    if cam.height % f or cam.width % f:
        raise ValueError(f"{cam.height}x{cam.width} is not divisible by {f}")
    return dataclasses.replace(
        cam, fx=cam.fx / f, fy=cam.fy / f, cx=cam.cx / f, cy=cam.cy / f,
        height=cam.height // f, width=cam.width // f)


def downscale_images(imgs: torch.Tensor, f: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, H/f, W/f, 3] box average (antialiased)."""
    B, H, W, C = imgs.shape
    return imgs.reshape(B, H // f, f, W // f, f, C).mean(dim=(2, 4))


def batched_pose_fit_c2f(states, bases, cameras, gts, lr, *, mode="auto",
                         tile_args=None, lambda_dssim=0.2, n_iters=300,
                         shared_state=False, stages=((4, 0.4), (1, 0.6))):
    """Coarse-to-fine pose fit: run `frac` of the budget at 1/f resolution
    (box-averaged targets, FoV-preserving pyramid cameras), each finer
    stage warm-started from the coarser tangents. gts: [B, H, W, 3]."""
    deltas = None
    total = sum(frac for (_, frac) in stages)
    H, W = int(gts.shape[1]), int(gts.shape[2])
    for (f, frac) in stages:
        # fall back to the largest divisor <= f of both image sides
        while f > 1 and (H % f or W % f):
            f -= 1
        it = max(1, int(round(n_iters * frac / total)))
        if f > 1:
            cams_f = [downscale_camera(c, f) for c in cameras]
            gts_f = downscale_images(gts, f)
        else:
            cams_f, gts_f = cameras, gts
        deltas = batched_pose_fit(
            states, bases, cams_f, gts_f, lr, mode=mode,
            tile_args=tile_args, lambda_dssim=lambda_dssim, n_iters=it,
            shared_state=shared_state, deltas0=deltas)
    return deltas
