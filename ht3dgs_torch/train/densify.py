"""Adaptive density control as fixed-capacity masked compaction.

Counterpart of `ht3dgs.train.densify`, with its semantics:
- candidates form a 4 x cap table [survivors | clones | split-a | split-b];
  a stable sort brings the kept rows to the front, in that order, and the
  first `cap` rows are taken, parameters and Adam moments together (new rows
  get zero moments, the shared step is kept);
- clone: grad >= threshold and max scale <= percent_dense * extent;
- split: grad >= threshold and max scale > percent_dense * extent; two
  children at x + R(q) (noise * scale), scales / 1.6, the parent pruned;
- prune: opacity < min_opacity, and with the screen test max scale >
  0.1 * extent (no screen-radius term); children are tested with their own
  scales;
- the densification stats are reset afterwards; the count of kept rows past
  the capacity is returned so the caller can grow it.

The split noise is an argument: the caller draws it from its generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..core import adam as adam_lib
from ..core.gaussians import PARAM_FIELDS, GaussianState
from ..core.se3 import quat_normalize, quat_rotate


@torch.no_grad()
def accumulate_stats(state: GaussianState, probe_grad: torch.Tensor,
                     radii: torch.Tensor) -> GaussianState:
    """Add |dL/dmeans2D| of visible Gaussians to grad_accum, count them in
    grad_denom, and track max_radii2d."""
    visible = radii > 0
    gnorm = torch.linalg.norm(probe_grad[:, :2], dim=-1)
    return dataclasses.replace(
        state,
        grad_accum=state.grad_accum + torch.where(visible, gnorm, 0.0),
        grad_denom=state.grad_denom + visible.float(),
        max_radii2d=torch.where(
            visible, torch.maximum(state.max_radii2d, radii.float()),
            state.max_radii2d))


@torch.no_grad()
def densify_and_prune(
    state: GaussianState,
    opt: adam_lib.AdamState,
    noise: Tuple[torch.Tensor, torch.Tensor],
    max_grad: float,
    min_opacity: float,
    extent: float,
    percent_dense: float,
    max_screen_size: float,
    use_screen_test: bool,
) -> Tuple[GaussianState, adam_lib.AdamState, torch.Tensor]:
    """noise: two [cap, 3] standard-normal draws, one per split child.
    Returns (state, opt, n_dropped_for_capacity) with the count a 0-dim
    tensor. max_screen_size is accepted for the reference's signature and
    unused (see the module docstring)."""
    cap = state.capacity
    live = state.live

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=state.device)

    max_grad, min_opacity, extent, percent_dense = map(
        f32, (max_grad, min_opacity, extent, percent_dense))
    grads = torch.where(state.grad_denom > 0,
                        state.grad_accum / state.grad_denom.clamp(min=1.0),
                        0.0)
    scales = state.scales()
    max_scale = scales.amax(dim=-1)
    opacity = state.opacities()

    hot = live & (grads >= max_grad)
    clone_sel = hot & (max_scale <= percent_dense * extent)
    split_sel = hot & (max_scale > percent_dense * extent)

    low = opacity < min_opacity
    prune = low | (max_scale > 0.1 * extent) if use_screen_test else low
    survivors_keep = live & ~split_sel & ~prune
    clone_keep = clone_sel & ~prune
    # children: the prune test sees their own (smaller) scales
    child_max_scale = (scales / (0.8 * 2.0)).amax(dim=-1)
    child_prune = (low | (child_max_scale > 0.1 * extent)
                   if use_screen_test else low)
    split_keep = split_sel & ~child_prune

    q = quat_normalize(state.quats)
    child_means = [state.means + quat_rotate(q, n * scales) for n in noise]
    child_log_scales = state.log_scales - math.log(0.8 * 2.0)

    keep = torch.cat([survivors_keep, clone_keep, split_keep, split_keep])
    # stable: kept rows first, in candidate order (survivors, clones, splits)
    order = torch.argsort((~keep).to(torch.int32), stable=True)[:cap]
    n_dropped = (keep.sum() - cap).clamp(min=0)

    new_params, new_m, new_v = {}, {}, {}
    for f in PARAM_FIELDS:
        x = getattr(state, f)
        if f == "means":
            rows = [x, x] + child_means
        elif f == "log_scales":
            rows = [x, x, child_log_scales, child_log_scales]
        else:
            rows = [x] * 4
        new_params[f] = torch.cat(rows)[order]
        zm, zv = torch.zeros_like(opt.m[f]), torch.zeros_like(opt.v[f])
        new_m[f] = torch.cat([opt.m[f], zm, zm, zm])[order]
        new_v[f] = torch.cat([opt.v[f], zv, zv, zv])[order]

    zeros = torch.zeros(cap, device=state.device)
    new_state = dataclasses.replace(
        state, **new_params, live=keep[order], max_radii2d=zeros,
        grad_accum=zeros, grad_denom=zeros.clone())
    return (new_state, adam_lib.AdamState(m=new_m, v=new_v, step=opt.step),
            n_dropped)


@torch.no_grad()
def reset_opacity(state: GaussianState, opt: adam_lib.AdamState
                  ) -> Tuple[GaussianState, adam_lib.AdamState]:
    """Clamp opacity to <= 0.01 and zero its Adam moments."""
    new_op = torch.clamp(state.opacities(), max=0.01)
    logit = torch.log(new_op / (1.0 - new_op))[:, None]
    zm = torch.zeros_like(opt.m["opacity_logit"])
    return (dataclasses.replace(state, opacity_logit=logit),
            adam_lib.AdamState(m={**opt.m, "opacity_logit": zm},
                               v={**opt.v, "opacity_logit": zm.clone()},
                               step=opt.step))


@torch.no_grad()
def importance_prune(state: GaussianState, opt: adam_lib.AdamState,
                     importance: torch.Tensor, prune_ratio
                     ) -> Tuple[GaussianState, adam_lib.AdamState]:
    """Drop the `prune_ratio` share of live Gaussians with the lowest
    importance; ties go to the lower row index, as JAX's stable argsort
    ranks them."""
    ratio = torch.tensor(prune_ratio, dtype=torch.float32,
                         device=state.device)
    k = (state.n_live().float() * ratio).to(torch.int64)
    score = torch.where(state.live, importance.float(), torch.inf)
    rank = torch.argsort(torch.argsort(score, stable=True), stable=True)
    drop = (rank < k) & state.live
    return dataclasses.replace(state, live=state.live & ~drop), opt
