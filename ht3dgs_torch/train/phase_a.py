"""Phase A: fits of B local models and B relative poses, as one batch.

Counterpart of `ht3dgs.train.phase_a`. As the JAX package vmaps the B
models of a batch through one compiled loop, one iteration here is one
batched step: the B models are stacked (`stack_states`, `stack_cameras`)
and rendered by `render_batched`, so the blend kernels launch once per
step over the B images' tiles. Per model the semantics are the
single-model step's:
- a model's early stop (PSNR > 35 after `stop_after` iterations) is
  decided every iteration from that iteration's render, on the device, and
  a stopped model keeps its parameters, moments and step from then on;
- non-finite gradients are zeroed before Adam;
- the xyz learning rate follows the 1-based iteration, as the sequential
  `fit_single_image` does;
- the backward differentiates the sum of the B losses, so each model gets
  its own loss's gradient.
The host reads the stop flags every `poll` iterations, only to take the
stopped models out of the stack, whose results the selection already
keeps.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..core import adam as adam_lib
from ..core.camera import Camera
from ..core.gaussians import PARAM_FIELDS, GaussianState
from ..core.se3 import se3_retr
from ..raster import render_batched
from ..utils.profiling import span, traced
from .losses import compute_loss, leaf_grads, psnr

# iterations between the host's reads of the early-stop flags
POLL = 25


def _stack(items, what: str):
    """Stack equal-shaped tensors (and dicts and dataclasses of them) on a
    new leading axis; every other field must be equal across the items."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        if any(not isinstance(x, torch.Tensor) or x.shape != first.shape
               for x in items):
            raise ValueError(f"{what}: shapes differ "
                             f"{sorted({tuple(x.shape) for x in items})}")
        return torch.stack(items)
    if isinstance(first, dict):
        return {k: _stack([x[k] for x in items], f"{what}.{k}")
                for k in first}
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _stack([getattr(x, f.name) for x in items],
                           f"{what}.{f.name}")
            for f in dataclasses.fields(first)})
    if all(x == first for x in items):
        return first
    raise ValueError(f"{what}: differs across the stack")


def _index(tree, rows):
    """Rows `rows` (an index, or an index tensor) of every stacked tensor
    of a tensor, tuple, dict or dataclass; other fields pass through."""
    if isinstance(tree, torch.Tensor):
        return tree[rows]
    if isinstance(tree, tuple):
        return tuple(_index(x, rows) for x in tree)
    if isinstance(tree, dict):
        return {k: _index(v, rows) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _index(getattr(tree, f.name), rows)
            for f in dataclasses.fields(tree)})
    return tree


def stack_states(states: Sequence[GaussianState]) -> GaussianState:
    """B models of one capacity, SH degree (active and max) -> one
    GaussianState with a leading [B] on every tensor field. Raises
    ValueError when they differ."""
    degrees = {int(s.active_sh_degree) for s in states}
    if len(degrees) > 1:
        raise ValueError(f"stack_states: active SH degrees differ {degrees}")
    return _stack(list(states), "stack_states")


def unstack_states(state: GaussianState) -> List[GaussianState]:
    return [_index(state, b) for b in range(state.means.shape[0])]


def stack_cameras(cams: Sequence[Camera]) -> Camera:
    """B cameras of one image size -> one Camera with world_view [B, 4, 4]
    and fx..cy [B]. Raises ValueError when the sizes differ."""
    return _stack(list(cams), "stack_cameras")


def stack_opts(opts: Sequence[adam_lib.AdamState]) -> adam_lib.AdamState:
    """B Adam states of one shape -> moments [B, ...] and step [B]."""
    return _stack(list(opts), "stack_opts")


def _finite(g: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if g is None:
        return torch.zeros_like(like)
    return torch.where(torch.isfinite(g), g, 0.0)


@traced("step")
def fit_step(state: GaussianState, opt: adam_lib.AdamState,
             cameras: Camera, gts: torch.Tensor, lrs, active: torch.Tensor,
             *, mode, tile_args, lambda_dssim):
    """One batched step of B stacked models against gts [B, H, W, 3]:
    render, per-model loss, backward of their sum, Adam with per-model
    rates, and the models with active[b] False keep their parameters and
    moments. Returns (state, opt, {"loss": [B], "psnr": [B]})."""
    params = {f: getattr(state, f).detach().requires_grad_(True)
              for f in PARAM_FIELDS}
    out = render_batched(state.replace_params(params), cameras, mode=mode,
                         tile_args=tile_args)
    with span("loss"):
        ld = compute_loss(out["image"], gts, lambda_dssim=lambda_dssim)
    with span("backward"):
        g = leaf_grads(ld["loss"].sum(), list(params.values()))
    grads = {f: _finite(gx, params[f]) for f, gx in zip(PARAM_FIELDS, g)}
    with span("adam"):
        new_params, new_opt = adam_lib.apply(
            {f: p.detach() for f, p in params.items()}, grads, opt, lrs)
    with torch.no_grad():
        with span("loss"):
            ps = psnr(out["image"], gts)
        state, opt = _select(active, state.replace_params(new_params),
                             new_opt, state, opt)
    return state, opt, {"loss": ld["loss"].detach(), "psnr": ps}


def _select(active: torch.Tensor, new_state, new_opt, state, opt):
    def sel(n, o):
        return torch.where(active.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)

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
    """Fit B local models of one capacity to their target frames, one
    batched step per iteration.

    lr_args: (lr_init_xyz [B], lr_final_xyz [B], max_steps, fixed_lrs dict
    of [B] per-group learning rates for the other groups).
    Returns (states, opts) as lists.
    """
    B = len(states)
    lr_init, lr_final, max_steps, fixed = lr_args
    if stop_after is None:
        # early stop after min(500, iterations // 2), as the sequential path
        stop_after = min(500, n_iters // 2)
    dev = states[0].device
    # per model: the fixed rates, and the xyz rate of every 1-based
    # iteration, made once (a host value per step would be a copy each)
    per_model = {k: torch.tensor([float(x) for x in v], device=dev)
                 for k, v in fixed.items()}
    per_model["means"] = torch.tensor(
        [[adam_lib.expon_lr(g + 1, float(lr_init[b]), float(lr_final[b]),
                            max_steps=max_steps) for g in range(n_iters)]
         for b in range(B)], device=dev)                     # [B, n_iters]
    batch = (stack_states(states), stack_opts(opts),
             stack_cameras(cameras), torch.stack(list(gts)), per_model,
             torch.ones(B, dtype=torch.bool, device=dev))
    ids = list(range(B))          # the models still in the stack
    results = [None] * B
    for g in range(n_iters):
        with span("iteration"):
            state, opt, cams, gt, rates, active = batch
            lrs = dict(rates, means=rates["means"][:, g])
            state, opt, m = fit_step(state, opt, cams, gt, lrs, active,
                                     mode=mode, tile_args=tile_args,
                                     lambda_dssim=lambda_dssim)
            if early_stop and g + 1 > stop_after:
                active = active & ~(m["psnr"] > 35.0)
            batch = (state, opt, cams, gt, rates, active)
            if early_stop and (g + 1) % poll == 0:
                keep = active.tolist()
                if not all(keep):
                    # a stopped model's results are final: out of the stack
                    for j in range(len(ids)):
                        if not keep[j]:
                            results[ids[j]] = _index((state, opt), j)
                    rows = torch.tensor(
                        [j for j, k in enumerate(keep) if k], device=dev)
                    ids = [b for b, k in zip(ids, keep) if k]
                    if not ids:
                        break
                    batch = tuple(_index(x, rows) for x in batch)
    for j, b in enumerate(ids):
        results[b] = _index(batch[:2], j)
    return [r[0] for r in results], [r[1] for r in results]


@traced("step")
def pose_step(state, deltas, bases, opt, cameras, gts, lr, *,
              shared_state=False, mode, tile_args, lambda_dssim):
    """One batched pose step: B SE(3) tangents [B, 6] on bases [B, 7]
    against B frozen stacked models (or one, shared_state=True) and gts
    [B, H, W, 3]. Returns (deltas, opt, per-model losses [B])."""
    deltas = deltas.detach().requires_grad_(True)
    out = render_batched(state, cameras, se3_retr(deltas, bases),
                         shared_state=shared_state, mode=mode,
                         tile_args=tile_args)
    with span("loss"):
        ld = compute_loss(out["image"], gts, lambda_dssim=lambda_dssim)
    with span("backward"):
        (g,) = leaf_grads(ld["loss"].sum(), [deltas])
    with span("adam"):
        params, new_opt = adam_lib.apply({"pose": deltas.detach()},
                                         {"pose": _finite(g, deltas)}, opt,
                                         {"pose": lr})
    return params["pose"], new_opt, ld["loss"].detach()


def init_pose_opts(B: int, device) -> adam_lib.AdamState:
    """B pose optimizers stacked: moments [B, 6], step [B]."""
    return stack_opts([adam_lib.init({"pose": torch.zeros(6, device=device)})
                       for _ in range(B)])


def batched_pose_fit(states, bases: torch.Tensor,
                     cameras: Sequence[Camera], gts: Sequence[torch.Tensor],
                     lr, *, mode="auto", tile_args=None, lambda_dssim=0.2,
                     n_iters=300, shared_state=False,
                     deltas0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Optimize B SE(3) tangents against B frozen models, one batched step
    per iteration. Returns [B, 6].

    shared_state=True: `states` is ONE frozen model that serves every pose.
    deltas0: warm-start tangents (the coarse-to-fine wrapper's fine stage).
    """
    B = len(gts)
    state = states if shared_state else stack_states(states)
    cams = stack_cameras(cameras)
    gts = torch.stack(list(gts))
    deltas = (torch.zeros(B, 6, device=bases.device) if deltas0 is None
              else deltas0.detach())
    opt = init_pose_opts(B, bases.device)
    for _ in range(n_iters):
        with span("iteration"):
            deltas, opt, _ = pose_step(
                state, deltas, bases, opt, cams, gts, lr,
                shared_state=shared_state, mode=mode, tile_args=tile_args,
                lambda_dssim=lambda_dssim)
    return deltas


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
