"""Gaussian scene state: a fixed capacity of rows with a `live` mask.

Counterpart of `ht3dgs.core.gaussians`, with the same fields, shapes and
parameter activations (scales = exp, opacities = sigmoid, quats stored
`[x, y, z, w]` and normalised at use). A stack of B states
(`train.phase_a.stack_states`) carries a leading [B] on every tensor
field; `capacity` and the activations read both layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from scipy.spatial import cKDTree

from . import sh as sh_lib

PARAM_FIELDS = ("means", "quats", "log_scales", "sh_dc", "sh_rest",
                "opacity_logit")


@dataclasses.dataclass
class GaussianState:
    # optimized parameters, capacity-padded
    means: torch.Tensor          # [cap, 3]
    quats: torch.Tensor          # [cap, 4] [x, y, z, w]
    log_scales: torch.Tensor     # [cap, 3]
    sh_dc: torch.Tensor          # [cap, 1, 3]
    sh_rest: torch.Tensor        # [cap, K-1, 3]
    opacity_logit: torch.Tensor  # [cap, 1]
    # capacity and densification stats
    live: torch.Tensor           # [cap] bool
    max_radii2d: torch.Tensor    # [cap] f32
    grad_accum: torch.Tensor     # [cap] f32, sum of |dL/dmeans2D| (NDC)
    grad_denom: torch.Tensor     # [cap] f32
    active_sh_degree: torch.Tensor  # 0-dim int32
    max_sh_degree: int

    @property
    def capacity(self) -> int:
        return self.means.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.means.device

    def n_live(self) -> torch.Tensor:
        return self.live.sum()

    def params(self) -> Dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in PARAM_FIELDS}

    def replace_params(self, params: Dict[str, torch.Tensor]
                       ) -> "GaussianState":
        return dataclasses.replace(self, **params)

    def _activate(self, fn, x: torch.Tensor) -> torch.Tensor:
        """fn(x), elementwise. A stack on the CPU runs model by model: the
        CPU's SIMD loops compute a tensor's last elements apart from its
        body, with another rounding of exp, so one op over the stack would
        give a model other bits than its own render. On the card an
        elementwise op computes every element alike."""
        if self.means.ndim == 3 and x.device.type == "cpu":
            return torch.stack([fn(m) for m in x.unbind(0)])
        return fn(x)

    def scales(self) -> torch.Tensor:
        return self._activate(torch.exp, self.log_scales)

    def opacities(self) -> torch.Tensor:
        return self._activate(torch.sigmoid, self.opacity_logit[..., 0])

    def sh(self) -> torch.Tensor:
        return torch.cat([self.sh_dc, self.sh_rest], dim=-2)


def inverse_sigmoid(x):
    return np.log(x / (1.0 - x))


def mean_sq_dist_to_3nn(points: np.ndarray) -> np.ndarray:
    """Mean squared distance of each point to its 3 nearest neighbours (the
    reference's `distCUDA2` at init; host-side, once per model)."""
    d, _ = cKDTree(points).query(points, k=4, workers=-1)
    return (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)


def create_from_pcd(points: np.ndarray, colors: np.ndarray, capacity: int,
                    max_sh_degree: int = 3, view_dependent: bool = True,
                    device="cuda") -> GaussianState:
    """Init from a point cloud: SH DC from RGB, rest zero, isotropic
    log-scale from the 3-NN distance, identity rotation, opacity 0.1."""
    n = points.shape[0]
    cap = max(capacity, n)
    K = sh_lib.num_sh_coeffs(max_sh_degree)

    dist2 = np.maximum(mean_sq_dist_to_3nn(points), 1e-7)
    log_scale = 0.5 * np.log(dist2)

    means = np.zeros((cap, 3), np.float32)
    means[:n] = points
    quats = np.zeros((cap, 4), np.float32)
    quats[:, 3] = 1.0
    log_scales = np.full((cap, 3), -10.0, np.float32)
    log_scales[:n] = log_scale[:, None]
    sh_dc = np.zeros((cap, 1, 3), np.float32)
    if view_dependent:
        sh_dc[:n, 0] = sh_lib.rgb2sh(colors.astype(np.float32))
    else:
        sh_dc[:n, 0] = colors.astype(np.float32)
    live = np.zeros((cap,), bool)
    live[:n] = True

    def t(x):
        return torch.as_tensor(x, device=device)

    return GaussianState(
        means=t(means), quats=t(quats), log_scales=t(log_scales),
        sh_dc=t(sh_dc),
        sh_rest=torch.zeros((cap, K - 1, 3), device=device),
        opacity_logit=torch.full((cap, 1), float(inverse_sigmoid(0.1)),
                                 device=device),
        live=t(live),
        max_radii2d=torch.zeros((cap,), device=device),
        grad_accum=torch.zeros((cap,), device=device),
        grad_denom=torch.zeros((cap,), device=device),
        active_sh_degree=torch.tensor(0, dtype=torch.int32, device=device),
        max_sh_degree=max_sh_degree)


def oneup_sh_degree(state: GaussianState) -> GaussianState:
    return dataclasses.replace(
        state, active_sh_degree=torch.clamp(state.active_sh_degree + 1,
                                            max=state.max_sh_degree))
