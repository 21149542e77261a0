"""Adam with explicit state that row surgery can edit.

Counterpart of `ht3dgs.core.adam`: the reference's torch.Adam (eps 1e-15,
default betas) with one step count shared by all groups, per-group learning
rates (0 freezes a group), and moments that densify can zero or permute
row-wise. Updates return new tensors; nothing is modified in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15


@dataclasses.dataclass
class AdamState:
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: torch.Tensor  # 0-dim int32, shared by every group


def init(params: Dict[str, torch.Tensor]) -> AdamState:
    some = next(iter(params.values()))
    return AdamState(
        m={k: torch.zeros_like(p) for k, p in params.items()},
        v={k: torch.zeros_like(p) for k, p in params.items()},
        step=torch.tensor(0, dtype=torch.int32, device=some.device))


@torch.no_grad()
def apply(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
          state: AdamState, lrs: Dict[str, object]):
    """One Adam step; returns (new_params, new_state)."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - BETA1 ** t
    bc2 = 1.0 - BETA2 ** t
    new_params, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = BETA1 * state.m[k] + (1.0 - BETA1) * g
        v = BETA2 * state.v[k] + (1.0 - BETA2) * (g * g)
        update = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        new_params[k] = p - lrs[k] * update
        new_m[k] = m
        new_v[k] = v
    return new_params, AdamState(m=new_m, v=new_v, step=step)


def zero_rows(state: AdamState, mask: torch.Tensor) -> AdamState:
    """Zero the moments of the first-axis rows where mask is True."""

    def z(x):
        return torch.where(mask.reshape((-1,) + (1,) * (x.ndim - 1)),
                           torch.zeros_like(x), x)

    return AdamState(m={k: z(x) for k, x in state.m.items()},
                     v={k: z(x) for k, x in state.v.items()},
                     step=state.step)


def permute_rows(state: AdamState, perm: torch.Tensor) -> AdamState:
    return AdamState(m={k: x[perm] for k, x in state.m.items()},
                     v={k: x[perm] for k, x in state.v.items()},
                     step=state.step)


def expon_lr(step: float, lr_init: float, lr_final: float, max_steps: int,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0) -> float:
    """Log-linear learning-rate schedule of the reference's
    `get_expon_lr_func`; 0 before step 0 or when either end is not > 0."""
    if step < 0 or not (lr_init > 0.0 and lr_final > 0.0):
        return 0.0
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1.0 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(lr_init) * (1.0 - t)
                            + math.log(lr_final) * t)
