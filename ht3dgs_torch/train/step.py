"""Training steps: render -> loss -> backward -> stats -> Adam.

Counterpart of `ht3dgs.train.step`, run eagerly:
- `gaussian_train_step` optimizes the Gaussian parameters through a camera
  whose pose is baked into world_view;
- `pose_train_step` optimizes one SE(3) tangent against frozen Gaussians.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core import adam as adam_lib
from ..core.camera import Camera
from ..core.gaussians import PARAM_FIELDS, GaussianState
from ..core.se3 import se3_retr
from ..raster import render
from ..utils.profiling import span, traced
from . import densify as densify_lib
from .losses import compute_loss, leaf_grads, psnr

_APPLY_ADAM = ("all", "skip", "no_opacity")


@traced("step")
def gaussian_train_step(
    state: GaussianState,
    opt: adam_lib.AdamState,
    camera: Camera,
    gt_image: torch.Tensor,
    lrs: Dict[str, object],
    depth_gt: Optional[torch.Tensor] = None,
    *,
    mode: str = "auto",
    apply_adam: str = "all",
    track_stats: bool = True,
    lambda_dssim: float = 0.2,
    lambda_depth: float = 0.0,
    tile_args: Optional[dict] = None,
) -> Tuple[GaussianState, adam_lib.AdamState, Dict[str, torch.Tensor]]:
    """One step. apply_adam: "all"; "skip" (no update, as on the
    reference's densify iterations); "no_opacity" (the opacity gradient is
    zeroed before Adam, as after an opacity reset)."""
    if apply_adam not in _APPLY_ADAM:
        raise ValueError(f"apply_adam must be one of {_APPLY_ADAM}")
    params = {f: getattr(state, f).detach().requires_grad_(True)
              for f in PARAM_FIELDS}
    probe = torch.zeros(state.capacity, 2, device=state.device,
                        requires_grad=True)
    out = render(state.replace_params(params), camera, means2d_probe=probe,
                 mode=mode, tile_args=tile_args)
    with span("loss"):
        ld = compute_loss(out["image"], gt_image, lambda_dssim=lambda_dssim,
                          lambda_depth=lambda_depth,
                          depth_pred=out["depth"] if lambda_depth else None,
                          depth_gt=depth_gt)
    leaves = list(params.values()) + [probe]
    with span("backward"):
        g = leaf_grads(ld["loss"], leaves)
    grads = dict(zip(PARAM_FIELDS, g[:-1]))
    probe_grad = g[-1]

    state = state.replace_params({f: p.detach() for f, p in params.items()})
    if track_stats:
        with span("stats"):
            state = densify_lib.accumulate_stats(state, probe_grad,
                                                 out["radii"])
    if apply_adam == "skip":
        new_opt = opt
    else:
        if apply_adam == "no_opacity":
            grads["opacity_logit"] = torch.zeros_like(grads["opacity_logit"])
        with span("adam"):
            new_params, new_opt = adam_lib.apply(state.params(), grads, opt,
                                                 lrs)
        state = state.replace_params(new_params)

    zero = torch.zeros((), dtype=torch.int64, device=state.device)
    with torch.no_grad():
        with span("loss"):
            ps = psnr(out["image"], gt_image)
        metrics = {
            "loss": ld["loss"].detach(),
            "loss_rgb": ld["loss_rgb"].detach(),
            "loss_dssim": ld["loss_dssim"].detach(),
            "loss_depth": ld["loss_depth"].detach(),
            "psnr": ps,
            "n_visible": (out["radii"] > 0).sum(),
            "n_dropped": out.get("n_dropped", zero),
            "n_dropped_m": out.get("n_dropped_m", zero),
            "n_dropped_tile": out.get("n_dropped_tile", zero),
        }
    return state, new_opt, metrics


@traced("step")
def pose_train_step(
    state: GaussianState,
    pose_delta: torch.Tensor,       # [6] tangent
    pose_base: torch.Tensor,        # [7] frozen base pose
    pose_opt: adam_lib.AdamState,
    camera: Camera,                 # identity extrinsics
    gt_image: torch.Tensor,
    lr,
    *,
    mode: str = "auto",
    lambda_dssim: float = 0.2,
    lambda_depth: float = 0.0,
    tile_args: Optional[dict] = None,
    update_pose: bool = True,
) -> Tuple[torch.Tensor, adam_lib.AdamState, Dict[str, torch.Tensor]]:
    delta = pose_delta.detach().requires_grad_(True)
    out = render(state, camera, pose=se3_retr(delta, pose_base), mode=mode,
                 tile_args=tile_args)
    with span("loss"):
        ld = compute_loss(out["image"], gt_image, lambda_dssim=lambda_dssim,
                          lambda_depth=lambda_depth)
    with span("backward"):
        (g,) = leaf_grads(ld["loss"], [delta])
    if update_pose:
        with span("adam"):
            params, new_opt = adam_lib.apply({"pose": delta.detach()},
                                             {"pose": g}, pose_opt,
                                             {"pose": lr})
        pose_delta = params["pose"]
    else:
        new_opt = pose_opt
    with torch.no_grad():
        with span("loss"):
            ps = psnr(out["image"], gt_image)
        metrics = {"loss": ld["loss"].detach(),
                   "psnr": ps,
                   "grad_norm": torch.linalg.norm(g)}
    return pose_delta, new_opt, metrics


def init_pose_opt(device="cuda") -> adam_lib.AdamState:
    return adam_lib.init({"pose": torch.zeros(6, device=device)})


@torch.no_grad()
def render_eval(state: GaussianState, camera: Camera,
                pose: Optional[torch.Tensor] = None, *, mode: str = "auto",
                tile_args: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    return render(state, camera, pose=pose, mode=mode, tile_args=tile_args)


# the compaction ops under the names the trainer calls (nothing to compile)
densify_and_prune = densify_lib.densify_and_prune
reset_opacity = densify_lib.reset_opacity
jit_importance_prune = densify_lib.importance_prune
