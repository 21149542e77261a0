"""Range-partitioned Gaussians: the model's rows split over the tile ranks.

Counterpart of `ht3dgs.parallel.gauss_shard`. Rank t of a segment owns rows
[t * cap / n, (t + 1) * cap / n) of the state, its Adam moments and its
statistics. A step projects only the owned rows (in the full image's frame),
packs them, optionally keeps the `cull_cap` rows that pass the frustum
cull, gathers the packed rows of every rank, and renders its own row block
from them (`rasterize_from_rows`, the loss share of the sharded SSIM). The
gather's backward hands each rank the sum of its rows' cotangents over all
the blocks, which is its rows' full gradient: Adam and the statistics stay
local, with no collective on the parameters.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..core import adam as adam_lib
from ..core.camera import Camera
from ..core.gaussians import PARAM_FIELDS, GaussianState
from ..raster.projection import project
from ..raster.tiled import _pack_attr_rows, rasterize_from_rows
from ..train import densify as densify_lib
from ..train.losses import ssim_sharded
from .comm import gather_rows, pack_counts, unpack_counts
from .mesh import Mesh

_ROW_FIELDS = PARAM_FIELDS + ("live", "max_radii2d", "grad_accum",
                              "grad_denom")


def shard_state(state: GaussianState, n_shards: int
                ) -> List[GaussianState]:
    """[cap] rows -> n_shards states of cap / n_shards rows each."""
    cap = state.capacity
    if cap % n_shards:
        raise ValueError(f"capacity {cap} does not split into {n_shards}")
    parts = {f: getattr(state, f).chunk(n_shards) for f in _ROW_FIELDS}
    return [dataclasses.replace(state, **{f: parts[f][i].clone()
                                          for f in _ROW_FIELDS})
            for i in range(n_shards)]


def unshard_state(shards: List[GaussianState]) -> GaussianState:
    return dataclasses.replace(shards[0], **{
        f: torch.cat([getattr(s, f) for s in shards]) for f in _ROW_FIELDS})


def shard_opt(opt: adam_lib.AdamState, n_shards: int
              ) -> List[adam_lib.AdamState]:
    m = {k: v.chunk(n_shards) for k, v in opt.m.items()}
    v = {k: x.chunk(n_shards) for k, x in opt.v.items()}
    return [adam_lib.AdamState(m={k: m[k][i].clone() for k in m},
                               v={k: v[k][i].clone() for k in v},
                               step=opt.step.clone())
            for i in range(n_shards)]


def unshard_opt(shards: List[adam_lib.AdamState]) -> adam_lib.AdamState:
    return adam_lib.AdamState(
        m={k: torch.cat([s.m[k] for s in shards]) for k in shards[0].m},
        v={k: torch.cat([s.v[k] for s in shards]) for k in shards[0].v},
        step=shards[0].step)


def build_gauss_sharded_step(mesh: Mesh, height: int, width: int, *,
                             cull_cap: Optional[int],
                             tile_args: Optional[dict] = None,
                             lambda_dssim: float = 0.2):
    """The train step of a Gaussian-row-sharded model over the tile axis
    (which also splits the image into row blocks).

    step(state_sh, opt_sh, camera, gt [H, W, 3], lrs) -> (state_sh',
    opt_sh', metrics), with this rank's shard and the full image's camera
    and gt. cull_cap=None gathers every packed row (pair it with a
    block-sized tile_args["compact_n"]); otherwise each rank sends its first
    cull_cap frustum survivors (stable), and survivors past it are counted
    in n_culled_dropped."""
    axis = mesh.tile_axis
    n = axis.size
    if height % n:
        raise ValueError(f"image height {height} must divide {n} shards")
    block_h = height // n
    row0 = mesh.tile * block_h
    n_rgb = height * width * 3
    targs = dict(tile_args or {})

    def step(state: GaussianState, opt: adam_lib.AdamState, camera: Camera,
             gt: torch.Tensor, lrs):
        gt_b = gt[row0:row0 + block_h]
        params = {f: getattr(state, f).detach().requires_grad_(True)
                  for f in PARAM_FIELDS}
        probe = torch.zeros(state.capacity, 2, device=state.device,
                            requires_grad=True)
        s = state.replace_params(params)
        proj = project(s.means, s.scales(), s.quats, s.opacities(), s.sh(),
                       s.live, camera, s.active_sh_degree, s.max_sh_degree)
        # the probe in the full image's NDC * (0.5 * size) units
        proj = proj._replace(means2d=proj.means2d + torch.stack(
            [probe[:, 0] * (0.5 * width), probe[:, 1] * (0.5 * height)],
            dim=-1))
        attrs = _pack_attr_rows(proj)
        valid, depths = proj.valid, proj.depths
        if cull_cap is not None:
            order = torch.argsort((~valid).to(torch.int8),
                                  stable=True)[:cull_cap]
            attrs, valid, depths = attrs[order], valid[order], depths[order]
            n_lost = (proj.valid.sum() - cull_cap).clamp(min=0)
        else:
            n_lost = torch.zeros((), dtype=torch.int64, device=state.device)
        # one gather: the validity and the depth key ride in the unused
        # columns 12 and 13 of the packed rows
        rows = torch.cat([attrs[:, :12], valid[:, None].float(),
                          depths[:, None].detach(),
                          attrs.new_zeros(attrs.shape[0], 2)], dim=1)
        g = gather_rows(rows, axis)
        attrs_g = torch.cat([g[:, :1], g[:, 1:2] - float(row0), g[:, 2:12],
                             g.new_zeros(g.shape[0], 4)], dim=1)
        out = rasterize_from_rows(
            attrs_g, g[:, 12].detach() > 0.5, g[:, 13].detach(), block_h,
            width, torch.zeros(3, device=state.device), **targs)
        img = out["image"]
        share = (1.0 - lambda_dssim) * (img - gt_b).abs().sum() / n_rgb
        if lambda_dssim:
            share = share + lambda_dssim * (
                1.0 / n - ssim_sharded(img, gt_b, axis, n_rgb))
        leaves = list(params.values()) + [probe]
        gr = torch.autograd.grad(share, leaves, allow_unused=True)
        gr = [torch.zeros_like(x) if gx is None else gx
              for x, gx in zip(leaves, gr)]
        with torch.no_grad():
            red = axis.all_reduce_(torch.cat([
                share.detach().reshape(1),
                (((img - gt_b) ** 2).sum() / n_rgb).reshape(1),
                pack_counts([out["n_dropped"], n_lost,
                             out["n_dropped_compact"]])]))
            n_dropped, n_culled, n_compact = unpack_counts(red[2:])
            state = densify_lib.accumulate_stats(
                state.replace_params({f: p.detach()
                                      for f, p in params.items()}),
                gr[-1], proj.radii)
            new_params, opt = adam_lib.apply(
                state.params(), dict(zip(PARAM_FIELDS, gr[:-1])), opt, lrs)
            metrics = {
                "loss": red[0],
                "psnr": -10.0 * torch.log10(torch.clamp(red[1], min=1e-12)),
                "n_dropped": n_dropped,
                "n_culled_dropped": n_culled,
                "n_dropped_compact": n_compact,
            }
        return state.replace_params(new_params), opt, metrics

    return step


def build_sharded_densify(mesh: Mesh):
    """Shard-local `densify_and_prune`. Every rank draws the split noise of
    all n shards from `gen`, in shard order, and uses its own; returns the
    rows dropped for capacity summed over the shards.

    densify(state_sh, opt_sh, gen, max_grad, min_opacity, extent,
            percent_dense, max_screen_size, use_screen_test)"""
    axis = mesh.tile_axis

    @torch.no_grad()
    def densify(state, opt, gen, max_grad, min_opacity, extent,
                percent_dense, max_screen_size, use_screen_test):
        noise = None
        for i in range(axis.size):
            draw = tuple(torch.randn((state.capacity, 3), generator=gen,
                                     device=state.device) for _ in range(2))
            if i == axis.index:
                noise = draw
        state, opt, dropped = densify_lib.densify_and_prune(
            state, opt, noise, max_grad, min_opacity, extent, percent_dense,
            max_screen_size, use_screen_test)
        return state, opt, unpack_counts(
            axis.all_reduce_(pack_counts([dropped])))[0]

    return densify
