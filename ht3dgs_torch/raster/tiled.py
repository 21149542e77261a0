"""Tile-binned rasterizer: binning into per-tile entry lists, blend, untile.

Counterpart of `ht3dgs.raster.tiled`. The binning keeps the JAX package's
fixed capacities and drop policy:
1. pack the per-Gaussian attributes into one [N, 16] row table;
2. stable-sort the Gaussians by depth (zero-span rows last);
3. expand each Gaussian into one entry per covered tile into M =
   round(N * dup_factor) slots, carrying the ORIGINAL row id;
4. stable-sort the entries by tile id, which keeps the depth order within
   a tile;
5. cut each tile's list to max_per_tile = K rows: ent [T, K, 16] and
   meta [T, 4] (count, origin_x, origin_y, 0).
Entries past M and lists past K drop farthest-first; the counters
n_dropped_m and n_dropped_tile report them. Rows k >= count of a tile alias
the next tile's entries; the blend never reads them and its backward gives
them exact zeros.
"""

from __future__ import annotations

from typing import Dict

import torch

from .blend import ATTRS, blend
from .projection import Projected


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pack_attr_rows(proj: Projected) -> torch.Tensor:
    """[N, 16]: mx, my, ca, cb, cc, r, g, b, op, depth, ex, ey, 0..."""
    depths = torch.where(torch.isfinite(proj.depths), proj.depths, 0.0)
    cols = [proj.means2d[:, 0], proj.means2d[:, 1],
            proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
            proj.colors[:, 0], proj.colors[:, 1], proj.colors[:, 2],
            proj.opacities, depths, proj.extents[:, 0], proj.extents[:, 1]]
    pad = torch.zeros_like(depths)
    return torch.stack(cols + [pad] * (ATTRS - len(cols)), dim=-1)


def _binning_impl(attrs, valid, depths, height, width, tile_h, tile_w,
                  max_per_tile, dup_factor):
    """Returns (ent [T,K,16], meta [T,4] i32, total, n_dropped_m,
    n_dropped_tile, csrc [T,K] int64 original row of every entry)."""
    N = attrs.shape[0]
    dev = attrs.device
    ntx = _cdiv(width, tile_w)
    nty = _cdiv(height, tile_h)
    T = ntx * nty
    M = max(int(round(N * dup_factor)), 1)
    K = max_per_tile

    # tile rectangles from the tight per-axis extents (getRect semantics)
    mx, my, ex, ey = attrs[:, 0], attrs[:, 1], attrs[:, 10], attrs[:, 11]
    x0 = torch.floor((mx - ex) / tile_w).clamp(0, ntx).long()
    x1 = torch.floor((mx + ex + tile_w - 1) / tile_w).clamp(0, ntx).long()
    y0 = torch.floor((my - ey) / tile_h).clamp(0, nty).long()
    y1 = torch.floor((my + ey + tile_h - 1) / tile_h).clamp(0, nty).long()
    span_x = (x1 - x0).clamp(min=0)
    span = torch.where(valid, span_x * (y1 - y0).clamp(min=0), 0)

    # depth order; zero-span rows go last (they emit no entries)
    dkey = torch.where(span > 0, depths, torch.inf)
    _, order = torch.sort(dkey, stable=True)
    span_s = span[order]
    cum = torch.cumsum(span_s, 0)
    total = cum[-1]

    # slot m -> the depth-sorted Gaussian whose segment holds it
    m = torch.arange(M, device=dev)
    seg = torch.searchsorted(cum, m, right=True).clamp(max=N - 1)
    local = m - (cum[seg] - span_s[seg])
    sx = span_x[order][seg].clamp(min=1)
    tx = x0[order][seg] + local % sx
    ty = y0[order][seg] + local // sx
    tile_id = torch.where(m < total, ty * ntx + tx, T)
    src = order[seg]

    # stable: ties keep the depth order
    sorted_tile, perm = torch.sort(tile_id, stable=True)
    sorted_src = src[perm]

    tids = torch.arange(T, device=dev, dtype=sorted_tile.dtype)
    starts = torch.searchsorted(sorted_tile, tids, side="left")
    ends = torch.searchsorted(sorted_tile, tids, side="right")
    counts = torch.clamp(ends - starts, max=K)
    tid = torch.arange(T, device=dev)
    meta = torch.stack([counts, (tid % ntx) * tile_w, (tid // ntx) * tile_h,
                        torch.zeros_like(tid)], dim=1).to(torch.int32)

    # each tile's list is a contiguous K-slice of the sorted entries
    src_pad = torch.cat([sorted_src, sorted_src.new_zeros(K)])
    csrc = src_pad[starts[:, None] + torch.arange(K, device=dev)]
    ent = attrs[csrc]
    nd_m = torch.clamp(total - M, min=0)
    nd_tile = torch.clamp(ends - starts - K, min=0).sum()
    return ent, meta, total, nd_m, nd_tile, csrc


class _Binning(torch.autograd.Function):
    """Binning, differentiable in `attrs`: the backward sums the entry
    cotangents into their original rows with `index_add_`, which runs on
    atomics on the card, so the summation order varies from run to run."""

    @staticmethod
    def forward(ctx, attrs, valid, depths, geom):
        ent, meta, total, nd_m, nd_tile, csrc = _binning_impl(
            attrs, valid, depths, *geom)
        ctx.save_for_backward(csrc)
        ctx.n_rows = attrs.shape[0]
        ctx.mark_non_differentiable(meta, total, nd_m, nd_tile)
        return ent, meta, total, nd_m, nd_tile

    @staticmethod
    def backward(ctx, d_ent, *_):
        (csrc,) = ctx.saved_tensors
        d_attrs = d_ent.new_zeros(ctx.n_rows, ATTRS)
        d_attrs.index_add_(0, csrc.reshape(-1), d_ent.reshape(-1, ATTRS))
        return d_attrs, None, None, None


def build_tile_lists_from_rows(attrs, valid, depths, height: int, width: int,
                               tile_h: int = 16, tile_w: int = 16,
                               max_per_tile: int = 1024, dup_factor=16,
                               route_bf16: bool = False, compact_n=None):
    """Binning of a packed [N, 16] row table. Returns (ent [T,K,16],
    meta [T,4] int32, total, n_dropped_m, n_dropped_tile)."""
    if route_bf16 or compact_n:
        raise NotImplementedError(
            "route_bf16 and compact_n are not ported yet")
    geom = (height, width, tile_h, tile_w, max_per_tile, dup_factor)
    return _Binning.apply(attrs, valid, depths, geom)


def build_tile_lists(proj: Projected, height: int, width: int,
                     tile_h: int = 16, tile_w: int = 16,
                     max_per_tile: int = 1024, dup_factor=16,
                     route_bf16: bool = False, compact_n=None):
    return build_tile_lists_from_rows(
        _pack_attr_rows(proj), proj.valid, proj.depths, height, width,
        tile_h, tile_w, max_per_tile, dup_factor, route_bf16, compact_n)


def rasterize_tiled(proj: Projected, height: int, width: int,
                    bg_color: torch.Tensor, tile_h: int = 16,
                    tile_w: int = 16, max_per_tile: int = 1024,
                    dup_factor=16, route_bf16: bool = False,
                    compact_n=None) -> Dict[str, torch.Tensor]:
    ent, meta, total, nd_m, nd_tile = build_tile_lists(
        proj, height, width, tile_h, tile_w, max_per_tile, dup_factor,
        route_bf16, compact_n)
    rgb_t, t_t, dep_t = blend(ent, meta, tile_h, tile_w)
    return _assemble(rgb_t, t_t, dep_t, height, width, tile_h, tile_w,
                     bg_color, total, nd_m, nd_tile)


def _assemble(rgb, t_buf, dep, height, width, tile_h, tile_w, bg_color,
              total, nd_m, nd_tile) -> Dict[str, torch.Tensor]:
    ntx = _cdiv(width, tile_w)
    nty = _cdiv(height, tile_h)

    def untile(x):
        ch = x.shape[2:]
        x = x.reshape((nty, ntx, tile_h, tile_w) + ch).transpose(1, 2)
        return x.reshape((nty * tile_h, ntx * tile_w) + ch)[:height, :width]

    t_img = untile(t_buf)
    image = untile(rgb) + t_img[..., None] * bg_color[None, None, :]
    zero = torch.zeros_like(nd_m)
    return {
        "image": torch.clamp(image, 0.0, 1.0),
        "depth": untile(dep),
        "alpha": 1.0 - t_img,
        "n_entries": total,
        "n_dropped": nd_m + nd_tile,
        "n_dropped_m": nd_m,
        "n_dropped_tile": nd_tile,
        "n_dropped_compact": zero,
    }
