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

compact_n keeps only the nearest `compact_n` rows that emit entries (the
zero-span rows already sort last, so this is a slice of the depth order)
and sizes M from it: under tile sharding each rank's row-block camera rejects
the Gaussians outside its block, so the expansion shrinks with the block.
The entries of the live rows past it are counted in n_dropped_compact.
route_bf16 rounds each entry's cotangent to bfloat16 before the float32
sums of the backward, as the JAX package's option does (its int32 pair
packing is a TPU sort workaround and is not ported).

The binning is batched: B models' (or B views') rows [B, N, 16] give one
entry list ent [B*T, K, 16] and meta [B*T, 4] (image b's tiles at rows
b*T..b*T+T-1, each with its own pixel origin), so one blend launch serves
the batch. Every model keeps the semantics of `jax.vmap` over the binning:
its own depth order, its own M and compact_n cut and its own counters
([B]); the tile sort key b*T + tile keeps the images apart, and a stable
sort keeps each model's depth order within a tile. An unbatched [N, 16]
table runs as B = 1.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..utils.profiling import count, span, traced
from .blend import ATTRS, blend
from .projection import Projected


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@traced("binning")
def _pack_attr_rows(proj: Projected) -> torch.Tensor:
    """[..., N, 16]: mx, my, ca, cb, cc, r, g, b, op, depth, ex, ey, 0..."""
    depths = torch.where(torch.isfinite(proj.depths), proj.depths, 0.0)
    cols = [proj.means2d[..., 0], proj.means2d[..., 1],
            proj.conics[..., 0], proj.conics[..., 1], proj.conics[..., 2],
            proj.colors[..., 0], proj.colors[..., 1], proj.colors[..., 2],
            proj.opacities, depths, proj.extents[..., 0],
            proj.extents[..., 1]]
    pad = torch.zeros_like(depths)
    return torch.stack(cols + [pad] * (ATTRS - len(cols)), dim=-1)


def _slots(N: int, dup_factor, compact_n) -> int:
    """M, the entry slots of one table of N rows."""
    Nc = min(compact_n, N) if compact_n else N
    return max(int(round(Nc * dup_factor)), 1)


def _binning_impl(attrs, valid, depths, height, width, tile_h, tile_w,
                  max_per_tile, dup_factor, compact_n):
    """attrs [B, N, 16], valid and depths [B, N]. Returns (ent [B*T,K,16],
    meta [B*T,4] i32, total [B], n_dropped_m [B], n_dropped_tile [B],
    n_dropped_compact [B], csrc [B*T,K] int64 row of every entry in the
    flattened [B*N] table)."""
    B, N = attrs.shape[:2]
    dev = attrs.device
    ntx = _cdiv(width, tile_w)
    nty = _cdiv(height, tile_h)
    T = ntx * nty
    Nc = min(compact_n, N) if compact_n else N
    M = _slots(N, dup_factor, compact_n)
    K = max_per_tile

    # tile rectangles from the tight per-axis extents (getRect semantics)
    mx, my = attrs[..., 0], attrs[..., 1]
    ex, ey = attrs[..., 10], attrs[..., 11]
    x0 = torch.floor((mx - ex) / tile_w).clamp(0, ntx).long()
    x1 = torch.floor((mx + ex + tile_w - 1) / tile_w).clamp(0, ntx).long()
    y0 = torch.floor((my - ey) / tile_h).clamp(0, nty).long()
    y1 = torch.floor((my + ey + tile_h - 1) / tile_h).clamp(0, nty).long()
    span_x = (x1 - x0).clamp(min=0)
    span = torch.where(valid, span_x * (y1 - y0).clamp(min=0), 0)

    # each model's depth order; zero-span rows go last (no entries)
    dkey = torch.where(span > 0, depths, torch.inf)
    _, order = torch.sort(dkey, dim=-1, stable=True)
    if Nc < N:
        # the rows with entries lead the order: keep the nearest Nc
        total_all = span.sum(-1)
        order = order[:, :Nc]
    span_s = span.gather(1, order)
    cum = torch.cumsum(span_s, 1)
    total = cum[:, -1]
    nd_compact = total_all - total if Nc < N else torch.zeros_like(total)

    # each model's slot m -> the depth-sorted Gaussian whose segment holds it
    m = torch.arange(M, device=dev)
    seg = torch.searchsorted(cum, m.expand(B, M).contiguous(),
                             right=True).clamp(max=Nc - 1)
    local = m - (cum.gather(1, seg) - span_s.gather(1, seg))
    src = order.gather(1, seg)
    sx = span_x.gather(1, src).clamp(min=1)
    tx = x0.gather(1, src) + local % sx
    ty = y0.gather(1, src) + local // sx
    b = torch.arange(B, device=dev)[:, None]
    key = torch.where(m < total[:, None], b * T + ty * ntx + tx, B * T)

    # stable: ties keep the depth order
    sorted_key, perm = torch.sort(key.reshape(-1), stable=True)
    sorted_src = (src + b * N).reshape(-1)[perm]

    tids = torch.arange(B * T, device=dev, dtype=sorted_key.dtype)
    starts = torch.searchsorted(sorted_key, tids, side="left")
    ends = torch.searchsorted(sorted_key, tids, side="right")
    counts = torch.clamp(ends - starts, max=K)
    tid = tids % T
    meta = torch.stack([counts, (tid % ntx) * tile_w, (tid // ntx) * tile_h,
                        torch.zeros_like(tid)], dim=1).to(torch.int32)

    # each tile's list is a contiguous K-slice of the sorted entries
    src_pad = torch.cat([sorted_src, sorted_src.new_zeros(K)])
    csrc = src_pad[starts[:, None] + torch.arange(K, device=dev)]
    ent = attrs.reshape(B * N, ATTRS)[csrc]
    nd_m = torch.clamp(total - M, min=0)
    nd_tile = torch.clamp(ends - starts - K, min=0).reshape(B, T).sum(1)
    return ent, meta, total, nd_m, nd_tile, nd_compact, csrc


class _Binning(torch.autograd.Function):
    """Binning, differentiable in `attrs`: the backward sums the entry
    cotangents into their original rows with `index_add_`, which runs on
    atomics on the card, so the summation order varies from run to run."""

    @staticmethod
    def forward(ctx, attrs, valid, depths, geom, compact_n, route_bf16):
        ent, meta, total, nd_m, nd_tile, nd_c, csrc = _binning_impl(
            attrs, valid, depths, *geom, compact_n)
        ctx.save_for_backward(csrc)
        ctx.rows_shape = attrs.shape
        ctx.route_bf16 = route_bf16
        ctx.mark_non_differentiable(meta, total, nd_m, nd_tile, nd_c)
        return ent, meta, total, nd_m, nd_tile, nd_c

    @staticmethod
    def backward(ctx, d_ent, *_):
        (csrc,) = ctx.saved_tensors
        if ctx.route_bf16:
            d_ent = d_ent.to(torch.bfloat16).to(d_ent.dtype)
        B, N, _ = ctx.rows_shape
        d_attrs = d_ent.new_zeros(B * N, ATTRS)
        d_attrs.index_add_(0, csrc.reshape(-1), d_ent.reshape(-1, ATTRS))
        return d_attrs.reshape(ctx.rows_shape), None, None, None, None, None


def build_tile_lists_from_rows(attrs, valid, depths, height: int, width: int,
                               tile_h: int = 16, tile_w: int = 16,
                               max_per_tile: int = 1024, dup_factor=16,
                               route_bf16: bool = False, compact_n=None):
    """Binning of a packed [N, 16] row table, or of B tables [B, N, 16].
    Returns (ent [B*T,K,16], meta [B*T,4] int32, total, n_dropped_m,
    n_dropped_tile, n_dropped_compact): the counters [B], or 0-dim for
    one table."""
    batched = attrs.ndim == 3
    if not batched:
        attrs, valid, depths = attrs[None], valid[None], depths[None]
    geom = (height, width, tile_h, tile_w, max_per_tile, dup_factor)
    compact_n = int(compact_n) if compact_n else 0
    with span("binning"):
        ent, meta, *counters = _Binning.apply(
            attrs, valid, depths, geom, compact_n, bool(route_bf16))
    B, N = attrs.shape[:2]
    for name, c in zip(("entries", "dropped_m", "dropped_k",
                        "dropped_compact"), counters):
        count(name, c)
    count("slots", B * _slots(N, dup_factor, compact_n))
    if not batched:
        counters = [c[0] for c in counters]
    return (ent, meta, *counters)


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
    return rasterize_from_rows(
        _pack_attr_rows(proj), proj.valid, proj.depths, height, width,
        bg_color, tile_h, tile_w, max_per_tile, dup_factor, route_bf16,
        compact_n)


def rasterize_from_rows(attrs, valid, depths, height: int, width: int,
                        bg_color: torch.Tensor, tile_h: int = 16,
                        tile_w: int = 16, max_per_tile: int = 1024,
                        dup_factor=16, route_bf16: bool = False,
                        compact_n=None) -> Dict[str, torch.Tensor]:
    """rasterize_tiled over a packed [N, 16] row table, or B of them
    [B, N, 16] in one blend (the Gaussian-sharded step hands it the rows
    gathered from every rank)."""
    ent, meta, total, nd_m, nd_tile, nd_c = build_tile_lists_from_rows(
        attrs, valid, depths, height, width, tile_h, tile_w, max_per_tile,
        dup_factor, route_bf16, compact_n)
    with span("blend"):
        rgb_t, t_t, dep_t = blend(ent, meta, tile_h, tile_w)
    with span("assemble"):
        return _assemble(rgb_t, t_t, dep_t, height, width, tile_h, tile_w,
                         bg_color, total, nd_m, nd_tile, nd_c)


def _assemble(rgb, t_buf, dep, height, width, tile_h, tile_w, bg_color,
              total, nd_m, nd_tile, nd_c) -> Dict[str, torch.Tensor]:
    """Untile the [B*T, P, ...] blend outputs into [B, H, W, ...] images,
    or [H, W, ...] when the counters are 0-dim (one image)."""
    ntx = _cdiv(width, tile_w)
    nty = _cdiv(height, tile_h)
    lead = tuple(total.shape)

    def untile(x):
        ch = x.shape[2:]
        x = x.reshape(lead + (nty, ntx, tile_h, tile_w) + ch).transpose(
            -3 - len(ch), -2 - len(ch))
        return x.reshape(lead + (nty * tile_h, ntx * tile_w) + ch)[
            ..., :height, :width, *([slice(None)] * len(ch))]

    t_img = untile(t_buf)
    image = untile(rgb) + t_img[..., None] * bg_color
    return {
        "image": torch.clamp(image, 0.0, 1.0),
        "depth": untile(dep),
        "alpha": 1.0 - t_img,
        "n_entries": total,
        "n_dropped": nd_m + nd_tile + nd_c,
        "n_dropped_m": nd_m,
        "n_dropped_tile": nd_tile,
        "n_dropped_compact": nd_c,
    }
