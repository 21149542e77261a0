"""Oracle renderer: every pixel composites every depth-sorted Gaussian.

Counterpart of `ht3dgs.raster.reference.rasterize_oracle`. O(N·H·W), so it
serves small scenes (`render(mode="auto")` picks it for them) and tests; it
is differentiable by autograd and has the blend's semantics (1/255 cutoff,
0.99 clamp, sticky stop below 1e-4 transmittance). A batched Projected
([B, N] fields) composites its images one after another: the oracle is the
per-image reference, launches no kernel, and so gives each image of a
batch the very numbers of its single render.
"""

from __future__ import annotations

from typing import Dict

import torch

from .projection import ALPHA_MAX, ALPHA_MIN, T_EPS, Projected


def rasterize_oracle(proj: Projected, height: int, width: int,
                     bg_color: torch.Tensor,
                     chunk: int = 256) -> Dict[str, torch.Tensor]:
    """Returns image [H,W,3], depth [H,W], alpha [H,W], with a leading [B]
    for a batched Projected."""
    if proj.depths.ndim == 2:
        outs = [rasterize_oracle(Projected(*(x[b] for x in proj)), height,
                                 width, bg_color, chunk)
                for b in range(proj.depths.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    dev = proj.means2d.device
    order = torch.argsort(proj.depths, stable=True)   # invalid (+inf) last
    # invalid rows add nothing (alpha 0): composite the valid ones only
    order = order[:int(proj.valid.sum())]
    depth_col = torch.where(torch.isfinite(proj.depths), proj.depths, 0.0)
    py, px = torch.meshgrid(torch.arange(height, device=dev).float(),
                            torch.arange(width, device=dev).float(),
                            indexing="ij")
    trans = torch.ones(height, width, device=dev)
    rgb = torch.zeros(height, width, 3, device=dev)
    dep = torch.zeros(height, width, device=dev)
    done = torch.zeros(height, width, dtype=torch.bool, device=dev)
    for s in range(0, order.shape[0], chunk):
        idx = order[s:s + chunk]
        m2 = proj.means2d[idx]
        a, b, c = proj.conics[idx].unbind(-1)
        dx = px[None] - m2[:, 0, None, None]                 # [C, H, W]
        dy = py[None] - m2[:, 1, None, None]
        power = (-0.5 * (a[:, None, None] * dx * dx
                         + c[:, None, None] * dy * dy)
                 - b[:, None, None] * dx * dy)
        alpha = torch.clamp(proj.opacities[idx, None, None]
                            * torch.exp(power), max=ALPHA_MAX)
        alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN)
                            & proj.valid[idx, None, None], alpha, 0.0)
        one_minus = 1.0 - alpha
        t_within = torch.cumprod(one_minus, dim=0)
        t_before = trans[None] * torch.cat(
            [torch.ones_like(t_within[:1]), t_within[:-1]], dim=0)
        t_after = trans[None] * t_within
        kept = (t_after >= T_EPS) & ~done[None]
        w = torch.where(kept, alpha * t_before, 0.0)
        rgb = rgb + torch.einsum("chw,cd->hwd", w, proj.colors[idx])
        dep = dep + torch.einsum("chw,c->hw", w, depth_col[idx])
        trans = trans * torch.prod(torch.where(kept, one_minus, 1.0), dim=0)
        done = done | (t_after[-1] < T_EPS)
    image = rgb + trans[..., None] * bg_color[None, None, :]
    return {"image": torch.clamp(image, 0.0, 1.0), "depth": dep,
            "alpha": 1.0 - trans}
