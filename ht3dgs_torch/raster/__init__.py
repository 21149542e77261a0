"""Differentiable Gaussian rasterization.

`render()` is the entry point, the counterpart of `ht3dgs.raster.render`: it
projects a GaussianState through a camera, optionally moved by an SE(3) pose
that acts on the means only, and blends with the tiled path or the oracle.
`render_batched()` is its counterpart under `jax.vmap`: B images in one
pass, from B stacked models or from one model under B cameras or poses,
with one blend launch over the B images' tiles.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.camera import Camera
from ..core.gaussians import GaussianState
from ..core.se3 import se3_act, se3_inv
from ..utils.profiling import count, span
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
    return _render(state, camera, pose, bg_color, means2d_probe,
                   scale_modifier, view_dependent, mode, tile_args)


def render_batched(states_or_state: GaussianState, cameras: Camera,
                   poses: Optional[torch.Tensor] = None, *,
                   shared_state: bool = False, mode: str = "auto",
                   tile_args: Optional[dict] = None
                   ) -> Dict[str, torch.Tensor]:
    """Render B images in one pass: `render` of each model b through
    camera b (and pose b), as `jax.vmap(render)` does.

    states_or_state: B models stacked by `train.phase_a.stack_states`
      (leading [B] on every field), or with shared_state=True one model
      that serves every camera and pose: its means are posed per image,
      never copied B times as a state.
    cameras: B cameras stacked by `train.phase_a.stack_cameras`.
    poses: optional [B, 7]. A black background, as the batched fits use.
    Returns image [B,H,W,3], depth and alpha [B,H,W], radii and valid
    [B,cap], and for the tiled path the counters [B].
    """
    B = cameras.world_view.shape[0]
    if cameras.world_view.ndim != 3 or (poses is not None
                                        and poses.shape != (B, 7)):
        raise ValueError("render_batched: cameras stacked to [B] and poses "
                         "[B, 7] expected")
    if shared_state != (states_or_state.means.ndim == 2):
        raise ValueError("render_batched: a stacked state with "
                         "shared_state=False, one state with True")
    if not shared_state and states_or_state.means.shape[0] != B:
        raise ValueError(f"render_batched: {states_or_state.means.shape[0]} "
                         f"models for {B} cameras")
    return _render(states_or_state, cameras, poses, None, None, 1.0, True,
                   mode, tile_args)


def _project_views(state, camera, pose, means2d_probe, scale_modifier,
                   view_dependent) -> Projected:
    """The projection of _render: the model's rows posed (if a pose is
    given), projected with their colours, and the densify probe's offset
    added to the 2D means."""
    means = state.means
    campos_override = None
    sh_means_override = None
    if pose is not None:
        means_render = se3_act(pose[..., None, :], means)
        # SH view directions: model-frame means and the detached
        # pose-inverse camera center
        campos_override = se3_inv(pose)[..., :3].detach()
        sh_means_override = means
    else:
        means_render = means

    # equal across a stack (stack_states checks it)
    sh_degree = state.active_sh_degree.reshape(-1)[0]
    proj = project(means_render, state.scales(), state.quats,
                   state.opacities(), state.sh(), state.live, camera,
                   sh_degree, state.max_sh_degree,
                   campos_override=campos_override,
                   sh_means_override=sh_means_override,
                   scale_modifier=scale_modifier)
    if not view_dependent:
        proj = proj._replace(colors=torch.clamp(state.sh_dc[:, 0, :],
                                                min=0.0))
    if means2d_probe is not None:
        # column by column with host scalars: no copy to the device
        offset = torch.stack([means2d_probe[:, 0] * (0.5 * camera.width),
                              means2d_probe[:, 1] * (0.5 * camera.height)],
                             dim=-1)
        proj = proj._replace(means2d=proj.means2d + offset)
    return proj


def _render(state, camera, pose, bg_color, means2d_probe, scale_modifier,
            view_dependent, mode, tile_args) -> Dict[str, torch.Tensor]:
    """Both entry points: the projection broadcasts the model's rows over
    the cameras' and poses' leading [B], if any, and the rasterizers take
    the batched Projected as it comes."""
    # the rows the render projects: live ones against the capacity
    count("live_rows", state.live)
    count("capacity_rows", state.live.numel())
    with span("projection"):
        if bg_color is None:
            bg_color = torch.zeros(3, device=state.device)
        proj = _project_views(state, camera, pose, means2d_probe,
                              scale_modifier, view_dependent)

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


__all__ = ["render", "render_batched", "project", "Projected",
           "rasterize_oracle"]
