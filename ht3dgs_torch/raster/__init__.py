"""Differentiable Gaussian rasterization.

`render()` is the entry point, the counterpart of `ht3dgs.raster.render`: it
projects a GaussianState through a camera, optionally moved by an SE(3) pose
that acts on the means only, and blends with the tiled path or the oracle.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.camera import Camera
from ..core.gaussians import GaussianState
from ..core.se3 import se3_act, se3_inv
from .projection import Projected, project
from .reference import rasterize_oracle
from .tiled import rasterize_tiled


def render(state: GaussianState, camera: Camera,
           pose: Optional[torch.Tensor] = None,
           bg_color: Optional[torch.Tensor] = None,
           means2d_probe: Optional[torch.Tensor] = None,
           scale_modifier: float = 1.0, view_dependent: bool = True,
           mode: str = "auto",
           tile_args: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Render `state` through `camera`.

    pose: optional SE(3) 7-vector applied to the means only.
    means2d_probe: optional [cap, 2] zeros whose gradient is the screen-space
      mean gradient in the reference's NDC * (0.5 * size) convention.
    mode: "oracle", "tiled" (alias "pallas"), or "auto" (tiled for large
      scenes or images, else oracle).
    Returns image [H,W,3], depth [H,W], alpha [H,W], radii [cap],
    valid [cap], and for the tiled path the entry and drop counters.
    """
    dev = state.device
    if bg_color is None:
        bg_color = torch.zeros(3, device=dev)

    means = state.means
    campos_override = None
    sh_means_override = None
    if pose is not None:
        means_render = se3_act(pose, means)
        # SH view directions: model-frame means and the detached
        # pose-inverse camera center
        campos_override = se3_inv(pose)[..., :3].detach()
        sh_means_override = means
    else:
        means_render = means

    proj = project(means_render, state.scales(), state.quats,
                   state.opacities(), state.sh(), state.live, camera,
                   state.active_sh_degree, state.max_sh_degree,
                   campos_override=campos_override,
                   sh_means_override=sh_means_override,
                   scale_modifier=scale_modifier)
    if not view_dependent:
        proj = proj._replace(colors=torch.clamp(state.sh_dc[:, 0, :],
                                                min=0.0))
    if means2d_probe is not None:
        scale = torch.tensor([0.5 * camera.width, 0.5 * camera.height],
                             device=dev)
        proj = proj._replace(means2d=proj.means2d + means2d_probe * scale)

    if mode == "auto":
        big = (state.capacity >= 8192
               or camera.height * camera.width >= 128 * 128)
        mode = "tiled" if big else "oracle"
    if mode == "oracle":
        out = rasterize_oracle(proj, camera.height, camera.width, bg_color)
    elif mode in ("tiled", "pallas"):
        out = rasterize_tiled(proj, camera.height, camera.width, bg_color,
                              **dict(tile_args or {}))
    else:
        raise ValueError(f"unknown render mode: {mode}")
    out["radii"] = proj.radii
    out["valid"] = proj.valid
    return out


__all__ = ["render", "project", "Projected", "rasterize_oracle"]
