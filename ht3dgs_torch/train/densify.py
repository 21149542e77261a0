"""Densification statistics.

Counterpart of `ht3dgs.train.densify.accumulate_stats`; densify/prune,
opacity reset and importance pruning are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.gaussians import GaussianState


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
