"""Real spherical harmonics (degrees 0..3) for view-dependent color.

Same basis and constants as `ht3dgs.core.sh`.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def num_sh_coeffs(deg: int) -> int:
    return (deg + 1) ** 2


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh [..., K, 3] with K >= (deg+1)^2, dirs [..., 3] unit vectors.
    Returns [..., 3] color before the +0.5 offset."""
    if not 0 <= deg <= 3:
        raise ValueError(f"SH degree {deg} not in 0..3")
    result = C0 * sh[..., 0, :]
    if deg >= 1:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (result
                  - C1 * y * sh[..., 1, :]
                  + C1 * z * sh[..., 2, :]
                  - C1 * x * sh[..., 3, :])
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (result
                  + C2[0] * xy * sh[..., 4, :]
                  + C2[1] * yz * sh[..., 5, :]
                  + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                  + C2[3] * xz * sh[..., 7, :]
                  + C2[4] * (xx - yy) * sh[..., 8, :])
    if deg >= 3:
        result = (result
                  + C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                  + C3[1] * xy * z * sh[..., 10, :]
                  + C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                  + C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
                  * sh[..., 12, :]
                  + C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                  + C3[5] * z * (xx - yy) * sh[..., 14, :]
                  + C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :])
    return result


def sh_degree_mask(active_deg, max_deg: int, device=None) -> torch.Tensor:
    """[K] float 0/1 mask keeping the coefficients of degree <= active_deg.
    `active_deg` may be an int or a 0-dim tensor."""
    K = num_sh_coeffs(max_deg)
    deg_of = torch.arange(K, device=device).float().sqrt().floor()
    if isinstance(active_deg, torch.Tensor):
        active_deg = active_deg.to(device)
    return (deg_of <= active_deg).float()


def rgb2sh(rgb):
    return (rgb - 0.5) / C0


def sh2rgb(sh):
    return sh * C0 + 0.5
