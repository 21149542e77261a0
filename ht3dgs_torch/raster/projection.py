"""Projection stage of the rasterizer: frustum cull, EWA 2D covariance,
conic, screen radius, tight binning extents and SH -> RGB.

Counterpart of `ht3dgs.raster.projection.project`, differentiable by torch
autograd. Float32 matrix products run at full precision on the card
(`torch.backends.cuda.matmul.allow_tf32` is False by default); the port
does not change that default.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import sh as sh_lib
from ..core.camera import Camera
from ..core.se3 import quat_normalize, quat_to_matrix

# CUDA-reference constants
NEAR_CULL = 0.2
COV2D_BLUR = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


class Projected(NamedTuple):
    """Per-Gaussian screen-space quantities; N is the capacity."""

    means2d: torch.Tensor    # [N, 2] pixels
    depths: torch.Tensor     # [N] camera z, +inf where not valid
    conics: torch.Tensor     # [N, 3] inverse 2D covariance (a, b, c)
    radii: torch.Tensor      # [N] int32, 0 => culled
    colors: torch.Tensor     # [N, 3]
    opacities: torch.Tensor  # [N]
    valid: torch.Tensor      # [N] bool: live, in frustum, radius > 0
    extents: torch.Tensor    # [N, 2] per-axis binning half-extents (px)


def project(means3d: torch.Tensor, scales: torch.Tensor, quats: torch.Tensor,
            opacities: torch.Tensor, sh: torch.Tensor, live: torch.Tensor,
            camera: Camera, active_sh_degree, max_sh_degree: int,
            campos_override: Optional[torch.Tensor] = None,
            sh_means_override: Optional[torch.Tensor] = None,
            scale_modifier: float = 1.0) -> Projected:
    """Project N Gaussians into the screen space of `camera`.

    means3d are in the render frame (already moved by a pose, if any).
    campos_override / sh_means_override replace the camera center and the
    means used for the SH view direction (pose fitting evaluates SH at the
    detached pose-inverse center with model-frame means)."""
    W = camera.world_view
    Rcw = W[:3, :3]
    tcw = W[:3, 3]
    p_view = means3d @ Rcw.T + tcw
    depths = p_view[:, 2]

    full_proj = camera.full_proj
    p_hom = means3d @ full_proj[:, :3].T + full_proj[:, 3]
    inv_w = 1.0 / (p_hom[:, 3] + 1e-7)
    ndc = p_hom[:, :3] * inv_w[:, None]
    px = ((ndc[:, 0] + 1.0) * camera.width - 1.0) * 0.5
    py = ((ndc[:, 1] + 1.0) * camera.height - 1.0) * 0.5
    means2d = torch.stack([px, py], dim=-1)

    # EWA: cov2d = A A^T, A = (J Rcw) (Rq diag(s)), J the 2x3 perspective
    # Jacobian with the reference's 1.3 * tan(fov/2) clamp
    tz = p_view[:, 2]
    tz_safe = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    limx = 1.3 * camera.tan_half_fovx
    limy = 1.3 * camera.tan_half_fovy
    tx = torch.clamp(p_view[:, 0] / tz_safe, -limx, limx) * tz_safe
    ty = torch.clamp(p_view[:, 1] / tz_safe, -limy, limy) * tz_safe
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([camera.fx * inv_z, zeros, -camera.fx * tx * inv_z2], -1),
        torch.stack([zeros, camera.fy * inv_z, -camera.fy * ty * inv_z2], -1),
    ], dim=1)                                               # [N, 2, 3]
    Rq = quat_to_matrix(quat_normalize(quats))              # [N, 3, 3]
    s = scales * scale_modifier
    A = (J @ Rcw) @ Rq * s[:, None, :]                      # [N, 2, 3]
    c00 = (A[:, 0] * A[:, 0]).sum(-1) + COV2D_BLUR
    c01 = (A[:, 0] * A[:, 1]).sum(-1)
    c11 = (A[:, 1] * A[:, 1]).sum(-1) + COV2D_BLUR

    det = c00 * c11 - c01 * c01
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conics = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], -1)

    mid = 0.5 * (c00 + c11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))

    # Tight per-axis extents of the alpha >= 1/255 ellipse, capped by the
    # 3-sigma radius, +1 px for the tile rounding. Detached: they only gate
    # discrete tile decisions, and sqrt has an infinite gradient at 0
    # (opacity at the cutoff), which would turn a 0 cotangent into NaN.
    with torch.no_grad():
        lvl2 = 2.0 * torch.clamp(
            torch.log(255.0 * torch.clamp(opacities, min=1e-9)), min=0.0)
        ex = torch.minimum(torch.sqrt(lvl2 * torch.clamp(c00, min=0.0)),
                           radius_f) + 1.0
        ey = torch.minimum(torch.sqrt(lvl2 * torch.clamp(c11, min=0.0)),
                           radius_f) + 1.0
        extents = torch.stack([ex, ey], dim=-1)

    in_front = depths > NEAR_CULL
    ok = in_front & (det > 0.0) & live
    radii = torch.where(ok, radius_f, torch.zeros_like(radius_f)).to(
        torch.int32)
    # exact cull: alpha <= op, so op below the cutoff never passes the blend
    valid = ok & (radii > 0) & (opacities >= ALPHA_MIN)

    campos = camera.camera_center if campos_override is None \
        else campos_override
    sh_means = means3d if sh_means_override is None else sh_means_override
    dirs = sh_means - campos[None, :]
    # rsqrt(|d|^2 + eps): the norm's gradient is NaN at 0, and a dead slot
    # can sit exactly at the camera center
    dirs = dirs * torch.rsqrt((dirs * dirs).sum(-1, keepdim=True) + 1e-12)
    band_mask = sh_lib.sh_degree_mask(active_sh_degree, max_sh_degree,
                                      device=sh.device)
    color = sh_lib.eval_sh(max_sh_degree, sh * band_mask[None, :, None],
                           dirs)
    colors = torch.clamp(color + 0.5, min=0.0)

    # sanitize culled and dead rows so no NaN leaks through masked
    # arithmetic downstream (0 * NaN = NaN)
    v1 = valid[:, None]
    return Projected(
        means2d=torch.where(v1, means2d, 0.0),
        depths=torch.where(valid, depths, torch.inf),
        conics=torch.where(v1, conics, 0.0),
        radii=radii,
        colors=torch.where(v1, colors, 0.0),
        opacities=torch.where(valid, opacities, 0.0),
        valid=valid,
        extents=torch.where(v1, extents, 0.0),
    )
