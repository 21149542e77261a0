"""Per-tile alpha blend of the packed entry lists, forward and backward.

Counterpart of `ht3dgs.raster.pallas_blend`. On a CUDA tensor each pass runs
its hand-written kernel (`csrc/blend_fwd.cu`, `csrc/blend_bwd.cu`); on a CPU
tensor it runs its plain PyTorch version below, which is also what the card
check holds the kernel against. There is no other fallback: a CUDA tensor
launches the kernel or raises.

Semantics (as the JAX blend): per entry and pixel
`power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy`, `alpha = min(0.99, op e^power)`,
gated by `power <= 0`, `alpha >= 1/255` and `k < count`; transmittance is a
running product, and a pixel stops for good (sticky `done`) at the first
entry that would take it below 1e-4, that entry excluded. The plain versions
walk the entries one at a time in the kernels' operation order, so kernel and
plain version round alike.
"""

from __future__ import annotations

import torch

from .. import kernels
from .projection import ALPHA_MAX, ALPHA_MIN, T_EPS

ATTRS = 16    # packed row: mx, my, ca, cb, cc, r, g, b, op, depth, unused...
N_GRAD = 10   # columns of d_ent that carry gradient


def _tile_pix(meta: torch.Tensor, tile_w: int, P: int):
    """Pixel centers [T, P] of every tile."""
    pix = torch.arange(P, device=meta.device)
    px = (meta[:, 1:2] + pix % tile_w).float()
    py = (meta[:, 2:3] + pix // tile_w).float()
    return px, py


def _entry_alpha(e, px, py):
    """Per-pixel quantities of entry rows e [T, 16] -> each [T, P]."""
    mx, my, ca, cb, cc, op = (e[:, i:i + 1] for i in (0, 1, 2, 3, 4, 8))
    dx = px - mx
    dy = py - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    ex = torch.exp(power)
    raw = op * ex
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    gate = (power <= 0.0) & (alpha >= ALPHA_MIN)
    return dx, dy, ex, raw, torch.where(gate, alpha, 0.0), gate


# --------------------------------------------------------------------------
# plain versions


def blend_fwd_plain(ent: torch.Tensor, meta: torch.Tensor, tile_h: int,
                    tile_w: int):
    """Returns (rgb [T,P,3], t_fin [T,P], depth [T,P], ncon [T,P]), ncon the
    kept-entry count over entries < count (f32)."""
    T, K, _ = ent.shape
    P = tile_h * tile_w
    px, py = _tile_pix(meta, tile_w, P)
    count = meta[:, 0:1].clamp(max=K)
    trans = torch.ones(T, P, device=ent.device)
    done = torch.zeros(T, P, dtype=torch.bool, device=ent.device)
    rgb = torch.zeros(T, P, 3, device=ent.device)
    dep = torch.zeros(T, P, device=ent.device)
    ncon = torch.zeros(T, P, device=ent.device)
    n_max = int(count.max()) if T else 0
    for k in range(n_max):
        e = ent[:, k]
        _, _, _, _, alpha, _ = _entry_alpha(e, px, py)
        t_after = trans * (1.0 - alpha)
        live = ~done & (k < count)
        stop = live & (t_after < T_EPS)
        kept = live & ~stop
        w = torch.where(kept, alpha * trans, 0.0)
        rgb = rgb + w[..., None] * e[:, None, 5:8]
        dep = dep + w * e[:, 9:10]
        trans = torch.where(kept, t_after, trans)
        done = done | stop
        ncon = ncon + kept.float()
    return rgb, trans, dep, ncon


def blend_bwd_plain(ent, meta, t_fin, ncon, d_rgb, d_t, d_depth,
                    tile_h: int, tile_w: int) -> torch.Tensor:
    """One back-to-front replay from t_fin and ncon. Returns d_ent
    [T, K, 16] with zeros in columns 10-15 and in every row nobody kept."""
    T, K, _ = ent.shape
    P = tile_h * tile_w
    px, py = _tile_pix(meta, tile_w, P)
    nc = torch.minimum(ncon, meta[:, 0:1].clamp(max=K).float())
    trans = t_fin
    tail = t_fin * d_t
    da = (d_rgb[..., 0], d_rgb[..., 1], d_rgb[..., 2], d_depth)
    suffix = torch.zeros_like(t_fin)
    d_ent = torch.zeros(T, K, ATTRS, device=ent.device)
    last = int(nc.max()) if T else 0
    for k in range(last - 1, -1, -1):
        e = ent[:, k]
        dx, dy, ex, raw, alpha, gate = _entry_alpha(e, px, py)
        kept = k < nc
        alpha = torch.where(kept, alpha, 0.0)
        one_minus = 1.0 - alpha
        t_before = torch.where(kept, trans / one_minus, trans)
        w = alpha * t_before
        r, g, b, dep = (e[:, i:i + 1] for i in (5, 6, 7, 9))
        adot = r * da[0] + g * da[1] + b * da[2] + dep * da[3]
        d_alpha = t_before * adot - (suffix + tail) / one_minus
        suffix = torch.where(kept, suffix + w * adot, suffix)
        trans = t_before
        on = kept & gate & (raw < ALPHA_MAX)
        d_power = torch.where(on, d_alpha * raw, 0.0)
        ca, cb, cc = e[:, 2:3], e[:, 3:4], e[:, 4:5]
        cols = [
            d_power * (ca * dx + cb * dy),
            d_power * (cc * dy + cb * dx),
            d_power * (-0.5 * dx * dx),
            d_power * (-dx * dy),
            d_power * (-0.5 * dy * dy),
            w * da[0], w * da[1], w * da[2],
            torch.where(on, d_alpha * ex, 0.0),
            w * da[3],
        ]
        d_ent[:, k, :N_GRAD] = torch.stack(cols, dim=-1).sum(dim=1)
    return d_ent


# --------------------------------------------------------------------------
# kernel wrappers


def _check(name, t, shape, dtype):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t.contiguous()


# tile shapes the kernels are compiled for (csrc/*.cu)
KERNEL_TILES = ((16, 16), (8, 16))


def _tile_pixels(tile_h: int, tile_w: int) -> int:
    if (tile_h, tile_w) not in KERNEL_TILES:
        raise ValueError(f"tile {tile_h}x{tile_w}: the kernels are built for "
                         f"tiles (h, w) in {KERNEL_TILES}")
    return tile_h * tile_w


def _check_ent(ent):
    ent = _check("ent", ent, (*ent.shape[:2], ATTRS), torch.float32)
    if ent.data_ptr() % 16:
        raise ValueError("ent: the kernels read rows as 16-byte vectors and "
                         "need a 16-byte aligned tensor")
    return ent


def blend_fwd(ent: torch.Tensor, meta: torch.Tensor, tile_h: int,
              tile_w: int):
    """Forward blend: the plain version for a CPU tensor, else kernel K1."""
    if ent.device.type == "cpu":
        return blend_fwd_plain(ent, meta, tile_h, tile_w)
    T, K, _ = ent.shape
    P = _tile_pixels(tile_h, tile_w)
    ent = _check_ent(ent)
    meta = _check("meta", meta, (T, 4), torch.int32)
    rgb = torch.empty(T, P, 3, device=ent.device)
    t_fin, dep, ncon = (torch.empty(T, P, device=ent.device)
                        for _ in range(3))
    lib = kernels.load("blend_fwd")
    err = lib.ht3dgs_blend_fwd(
        ent.data_ptr(), meta.data_ptr(), rgb.data_ptr(), t_fin.data_ptr(),
        dep.data_ptr(), ncon.data_ptr(), T, K, tile_h, tile_w,
        torch.cuda.current_stream(ent.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: cudaError {err}")
    blend_fwd.launches += 1
    return rgb, t_fin, dep, ncon


blend_fwd.launches = 0


def blend_bwd(ent, meta, t_fin, ncon, d_rgb, d_t, d_depth, tile_h: int,
              tile_w: int) -> torch.Tensor:
    """Backward blend: the plain version for a CPU tensor, else kernel K2."""
    if ent.device.type == "cpu":
        return blend_bwd_plain(ent, meta, t_fin, ncon, d_rgb, d_t, d_depth,
                               tile_h, tile_w)
    T, K, _ = ent.shape
    P = _tile_pixels(tile_h, tile_w)
    f32 = torch.float32
    ent = _check_ent(ent)
    meta = _check("meta", meta, (T, 4), torch.int32)
    t_fin, ncon, d_t, d_depth = (_check(n, x, (T, P), f32) for n, x in (
        ("t_fin", t_fin), ("ncon", ncon), ("d_t", d_t), ("d_depth", d_depth)))
    d_rgb = _check("d_rgb", d_rgb, (T, P, 3), f32)
    d_ent = torch.empty(T, K, ATTRS, device=ent.device)
    lib = kernels.load("blend_bwd")
    err = lib.ht3dgs_blend_bwd(
        ent.data_ptr(), meta.data_ptr(), t_fin.data_ptr(), ncon.data_ptr(),
        d_rgb.data_ptr(), d_t.data_ptr(), d_depth.data_ptr(),
        d_ent.data_ptr(), T, K, tile_h, tile_w,
        torch.cuda.current_stream(ent.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend_bwd kernel launch failed: cudaError {err}")
    blend_bwd.launches += 1
    return d_ent


blend_bwd.launches = 0


class _Blend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ent, meta, tile_h, tile_w):
        rgb, t_fin, dep, ncon = blend_fwd(ent, meta, tile_h, tile_w)
        ctx.save_for_backward(ent, meta, t_fin, ncon)
        ctx.tile = (tile_h, tile_w)
        return rgb, t_fin, dep

    @staticmethod
    def backward(ctx, d_rgb, d_t, d_depth):
        ent, meta, t_fin, ncon = ctx.saved_tensors
        d_ent = blend_bwd(ent, meta, t_fin, ncon, d_rgb, d_t, d_depth,
                          *ctx.tile)
        return d_ent, None, None, None


def blend(ent: torch.Tensor, meta: torch.Tensor, tile_h: int, tile_w: int):
    """ent [T, K, 16], meta [T, 4] int32 (count, origin_x, origin_y, 0).
    Returns (rgb [T,P,3], T_fin [T,P], depth [T,P]), differentiable in ent."""
    return _Blend.apply(ent, meta, tile_h, tile_w)
