#!/usr/bin/env python3
"""Drive ht3dgs_torch's training step on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed 0] [--profile PATH]

Phases (any failure exits non-zero):
1. build both blend kernels from csrc/ with nvcc for sm_90a, print
   ptxas's register / shared-memory / spill report and, from the SASS
   (cuobjdump), the instructions of each kernel's entry loop per
   evaluation;
2. set up the trained-statistics scene: 1,000,000 Gaussians at SH degree 3
   (random, from --seed), bimodal opacities, 1920x1080, fovx 1.2, 16x16
   tiles, max_per_tile 128, dup_factor 1.25;
3. hold kernel K1 (blend forward) against its plain PyTorch version on the
   scene's packed entries, and time both;
4. hold kernel K2 (blend backward) against its plain version on the same
   entries and random cotangents, per column and per entry (bwd_scale),
   and time both;
5. ragged edges: synthetic entries (numpy, from --seed) with per-tile counts
   at the kernels' chunk edges, a tile whose pixels all stop at entry 1 and
   garbage in the pad rows, for every tile shape the kernels are built for;
   both kernels against their plain versions, K2 twice for bitwise
   determinism;
6. the main path: with every launch count at 0, render a target from the
   true scene, take 10 gaussian_train_steps from a perturbed copy and 5
   pose_train_steps from a perturbed pose; the losses must be finite and
   fall, and each kernel must have run at least once per step;
7. on a small scene, the tiled render (kernels) against the oracle render
   (plain PyTorch, O(N*H*W)), image and means gradient.
It prints the card's name and power limit, one JSON line of kernel numbers,
and last the line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import subprocess
import time

import numpy as np

H, W, N = 1080, 1920, 1_000_000
TILE_ARGS = dict(tile_h=16, tile_w=16, max_per_tile=128, dup_factor=1.25)
LRS = dict(means=1e-3, quats=1e-3, log_scales=5e-3, sh_dc=2.5e-3,
           sh_rest=1.25e-4, opacity_logit=0.05)
# The pose fit runs at a dup_factor that drops no entry at M: at 1.25 the
# global M cut keeps only the nearest ~5% of this scene's entries, and which
# Gaussians fall past it jumps as the pose moves their depths, which makes
# the pose loss step-wise rather than smooth.
POSE_TILE_ARGS = dict(TILE_ARGS, dup_factor=32)
POSE_LR = 2e-3
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# float32 operations/s outside the tensor cores (an FMA counts as two)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations counted from the kernel sources, an FMA as two, exp, a
# reciprocal, a min or a compare as one: forward 26 per entry-pixel
# evaluation; backward 35 per kept entry-pixel in the replay and 14.5 per
# entry-pixel slot of a chunk in the moment pass
OPS_FWD = 26
OPS_BWD_KEPT = 35
OPS_BWD_SLOT = 14.5
# a warp scheduler dispatches one warp-instruction per clock, four per SM
WARP_INSTR_PER_SM_CLOCK = 4
# K2's error per entry, as a share of its bwd_scale: about the f32 rounding
# of a 128-entry replay chain (128 x 2^-24 = 7.6e-6)
ENTRY_TOL = 1e-5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_scene(seed: int, device):
    """The trained-statistics scene of bench.py, with SH degree 3 active."""
    import torch

    from ht3dgs_torch.core import gaussians as G

    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((N, 3)).astype(np.float32) * 1.5
    pts[:, 2] += 6.0
    colors = rng.random((N, 3)).astype(np.float32)
    state = G.create_from_pcd(pts, colors, capacity=N, device=device)
    u = rng.random(N)
    op = np.where(u < 0.45, rng.uniform(0.60, 0.99, N),
                  np.where(u < 0.75, rng.uniform(0.15, 0.60, N),
                           rng.uniform(0.01, 0.15, N))).astype(np.float32)
    sh_rest = 0.05 * rng.standard_normal(tuple(state.sh_rest.shape))
    return dataclasses.replace(
        state,
        opacity_logit=torch.tensor(np.log(op / (1 - op))[:, None],
                                   device=device),
        sh_rest=torch.tensor(sh_rest, dtype=torch.float32, device=device),
        active_sh_degree=torch.tensor(3, dtype=torch.int32, device=device))


def kernel_entries(state, cam):
    """Packed entries and meta the main path hands the blend."""
    import torch

    from ht3dgs_torch.raster.projection import project
    from ht3dgs_torch.raster.tiled import build_tile_lists

    with torch.no_grad():
        proj = project(state.means, state.scales(), state.quats,
                       state.opacities(), state.sh(), state.live, cam,
                       state.active_sh_degree, state.max_sh_degree)
        ent, meta, total, nd_m, nd_tile = build_tile_lists(
            proj, cam.height, cam.width, **TILE_ARGS)
    return ent, meta, int(total), int(nd_m), int(nd_tile)


def phase_fwd(B, ent, meta, P):
    """K1 vs its plain version: returns (record, ncon, t_fin, number of
    entry-pixel evaluations)."""
    import torch

    k = B.blend_fwd(ent, meta, 16, 16)
    p = B.blend_fwd_plain(ent, meta, 16, 16)
    torch.cuda.synchronize()
    names = ("rgb", "t_fin", "depth")
    errs = {n: (a - b).abs().max().item() for n, a, b in zip(names, k, p)}
    count = meta[:, :1].float()
    ncon_equal = torch.equal(torch.minimum(k[3], count),
                             torch.minimum(p[3], count))
    print(f"K1 vs plain: max|d| {errs}, min(ncon,count) equal: {ncon_equal}")
    check(errs["rgb"] <= 3e-5 and errs["t_fin"] <= 3e-5, "K1 image 3e-5")
    check(errs["depth"] <= 3e-4, "K1 depth 3e-4")
    check(ncon_equal, "K1 min(ncon, count) equal to the plain version's")

    ms = cuda_ms(lambda: B.blend_fwd(ent, meta, 16, 16), 20)
    plain_ms = cuda_ms(lambda: B.blend_fwd_plain(ent, meta, 16, 16), 3)
    cnt = meta[:, 0].long().clamp(max=ent.shape[1])
    ncon = k[3]
    n_eval = torch.minimum(cnt[:, None].float(), ncon + 1).sum().item()
    T = ent.shape[0]
    nbytes = cnt.sum().item() * 64 + T * 16 + T * P * 6 * 4
    rec = dict(name="blend_fwd", route="cuda",
               source="ht3dgs_torch/csrc/blend_fwd.cu",
               replaces="ht3dgs/raster/pallas_blend.py:167",
               max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
               **bound(nbytes, n_eval * OPS_FWD), library_ms=None)
    print(f"K1: {ms:.4f} ms/call, plain {plain_ms:.3f} ms, "
          f"{n_eval:.0f} entry-pixel evaluations, {nbytes / 1e6:.1f} MB")
    return rec, ncon, k[1], n_eval


def phase_bwd(B, ent, meta, t_fin, ncon, P, seed):
    import torch

    T, K, _ = ent.shape
    g = torch.Generator(device=ent.device).manual_seed(seed)
    cts = [torch.randn(s, generator=g, device=ent.device) / P
           for s in ((T, P, 3), (T, P), (T, P))]
    k = B.blend_bwd(ent, meta, t_fin, ncon, *cts, 16, 16)
    p = B.blend_bwd_plain(ent, meta, t_fin, ncon, *cts, 16, 16)
    scale = bwd_scale(B, ent, meta, t_fin, ncon, *cts, 16, 16)
    check_bwd(k, p, scale, meta, "K2")
    count = meta[:, :1].long()
    err = (k - p).abs()

    ms = cuda_ms(lambda: B.blend_bwd(ent, meta, t_fin, ncon, *cts, 16, 16),
                 20)
    plain_ms = cuda_ms(
        lambda: B.blend_bwd_plain(ent, meta, t_fin, ncon, *cts, 16, 16), 3)
    last = torch.minimum(ncon.amax(dim=1), count[:, 0].float())
    n_kept = ncon.sum().item()
    n_slot = last.sum().item() * P
    nbytes = last.sum().item() * 64 + T * 16 + T * P * 7 * 4 + T * K * 64
    rec = dict(name="blend_bwd", route="cuda",
               source="ht3dgs_torch/csrc/blend_bwd.cu",
               replaces="ht3dgs/raster/pallas_blend.py:291",
               max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
               **bound(nbytes, n_kept * OPS_BWD_KEPT
                       + n_slot * OPS_BWD_SLOT), library_ms=None)
    print(f"K2: {ms:.4f} ms/call, plain {plain_ms:.3f} ms, "
          f"{n_kept:.0f} kept entry-pixels, {n_slot:.0f} entry-pixel slots, "
          f"{nbytes / 1e6:.1f} MB")
    return rec, n_kept, n_slot


def bwd_scale(B, ent, meta, t_fin, ncon, d_rgb, d_t, d_depth, tile_h: int,
              tile_w: int):
    """Per entry and gradient column [T, K, 10], the size of what K2 sums:
    blend_bwd_plain's replay with every summand, and each term of d_alpha, by
    its absolute value, and the geometric columns in the moment form's terms
    (|u| + |mxl| in place of |dx| = |u - mxl|, u the pixel's tile-local
    offset, mxl the entry centre's). Rounding in any order of summation, the
    moment form's cancellation included, is a small multiple of f32 epsilon
    times this; it is at least the entry's |plain value|."""
    import torch

    T, K, _ = ent.shape
    P = tile_h * tile_w
    px, py = B._tile_pix(meta, tile_w, P)
    ox, oy = meta[:, 1:2].float(), meta[:, 2:3].float()
    au, av = (px - ox).abs(), (py - oy).abs()
    nc = torch.minimum(ncon, meta[:, 0:1].clamp(max=K).float())
    trans = t_fin
    tail = (t_fin * d_t).abs()
    da = [x.abs() for x in (d_rgb[..., 0], d_rgb[..., 1], d_rgb[..., 2],
                            d_depth)]
    suffix = torch.zeros_like(t_fin)
    scale = torch.zeros(T, K, B.N_GRAD, device=ent.device)

    def psum(x):
        return x.sum(dim=1, keepdim=True)

    for k in range(int(nc.max()) - 1, -1, -1):
        e = ent[:, k]
        _, _, ex, raw, alpha, gate = B._entry_alpha(e, px, py)
        kept = k < nc
        alpha = torch.where(kept, alpha, 0.0)
        one_minus = 1.0 - alpha
        t_before = torch.where(kept, trans / one_minus, trans)
        w = alpha * t_before
        adot = sum(e[:, i:i + 1].abs() * d for i, d in zip((5, 6, 7, 9), da))
        on = kept & gate & (raw < B.ALPHA_MAX)
        d_alpha = torch.where(
            on, t_before * adot + (suffix + tail) / one_minus, 0.0)
        suffix = torch.where(kept, suffix + w * adot, suffix)
        trans = t_before
        dp = d_alpha * raw
        ax = au + (e[:, 0:1] - ox).abs()
        ay = av + (e[:, 1:2] - oy).abs()
        ca, cb, cc = (e[:, i:i + 1].abs() for i in (2, 3, 4))
        sx, sy = psum(dp * ax), psum(dp * ay)
        scale[:, k] = torch.cat([
            ca * sx + cb * sy, cc * sy + cb * sx, 0.5 * psum(dp * ax * ax),
            psum(dp * ax * ay), 0.5 * psum(dp * ay * ay),
            *(psum(w * d) for d in da[:3]), psum(d_alpha * ex),
            psum(w * da[3])], dim=1)
    return scale


def check_bwd(got, ref, scale, meta, what: str) -> None:
    """K2's d_ent against the plain version's: per column within 1e-4 of the
    column's largest |ref| + 1e-6; per entry within ENTRY_TOL of its own
    scale (bwd_scale); exact zeros on rows k >= count and in columns
    10-15."""
    import torch

    n = scale.shape[-1]
    err = (got - ref).abs()[..., :n]
    ref = ref[..., :n].abs()
    col_err = err.amax(dim=(0, 1))
    col_tol = 1e-4 * ref.amax(dim=(0, 1)) + 1e-6
    ratio = torch.where(scale > 0, err / scale,
                        torch.where(err > 0, float("inf"), 0.0))
    col_ratio = ratio.amax(dim=(0, 1))
    med_ref, rel = [], []   # over the entries with ref != 0
    for c in range(n):
        nz = ref[..., c] > 0
        r = ref[..., c][nz]
        med_ref.append(r.median().item() if r.numel() else 0.0)
        q = torch.tensor([0.5, 0.99], device=r.device)
        rel.append((err[..., c][nz] / r).quantile(q).tolist()
                   if r.numel() else [0.0, 0.0])

    def fmt(xs):
        return [float(f"{x:.3g}") for x in xs]

    print(f"{what} vs plain, per column: max|d| {fmt(col_err.tolist())}; "
          f"limit 1e-4 max|ref| + 1e-6 {fmt(col_tol.tolist())}; "
          f"median |ref| {fmt(med_ref)}; |d| / |ref| at the 50th and 99th "
          f"percentile {[fmt(x) for x in rel]}; max over entries of "
          f"|d| / scale {fmt(col_ratio.tolist())} (limit {ENTRY_TOL})")
    check(bool((col_err <= col_tol).all()),
          f"{what} per column 1e-4 * max|ref| + 1e-6")
    check(bool((col_ratio <= ENTRY_TOL).all()),
          f"{what} per entry {ENTRY_TOL} * its scale")
    pad = (torch.arange(got.shape[1], device=got.device)[None, :]
           >= meta[:, :1])
    check(not got[pad].any().item(), f"{what} exact zeros on rows k >= count")
    check(not got[..., n:].any().item(),
          f"{what} exact zeros in columns 10-15")


def sass_loops(text: str, kernel: str) -> dict:
    """Instruction counts of a kernel's entry loops, from `cuobjdump -sass`.

    Takes the function whose name holds `kernel` (the 16x16 instance where
    the kernel is a template). A loop is the span from a backward branch's
    target address to the branch. `inner` is the smallest loop that holds
    an exp (MUFU.EX2, one per entry-pixel evaluation), `outer` the smallest
    loop around it. Returns the instruction counts of both and the exps in
    `inner`."""
    funcs = re.split(r"\n\s*Function : ", text)[1:]
    funcs = [f for f in funcs if kernel in f.split("\n", 1)[0]]
    funcs = ([f for f in funcs if "Li16ELi16E" in f.split("\n", 1)[0]]
             or funcs)
    if len(funcs) != 1:
        raise RuntimeError(f"SASS: {len(funcs)} functions match {kernel}")
    insns = [(int(a, 16), op.strip()) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", funcs[0])]
    loops = []
    for addr, op in insns:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)\s*$", op)
        if m and int(m.group(1), 16) <= addr:
            body = [o for a, o in insns if int(m.group(1), 16) <= a <= addr
                    and not o.startswith("NOP")]
            loops.append((int(m.group(1), 16), addr, len(body),
                          sum("MUFU.EX2" in o for o in body)))
    inner = min((lp for lp in loops if lp[3]), key=lambda lp: lp[2])
    outer = [lp for lp in loops if lp[0] <= inner[0] and lp[1] >= inner[1]
             and lp != inner]
    outer = min(outer, key=lambda lp: lp[2]) if outer else None
    return dict(inner=inner[2], exps=inner[3],
                outer=outer[2] if outer else None)


def sass_per_eval(text: str, chunk: int) -> dict:
    """{kernel: SASS instructions per entry-pixel evaluation} of a build's
    listings. K1: its entry loop over the exps in it (one per pixel).
    K2: the replay loop per kept evaluation ("blend_bwd_kernel"), and the
    rest of the chunk loop, the moment pass above all, per entry-pixel slot
    ("blend_bwd_kernel/slot": a thread takes `chunk` slots a chunk)."""
    out = {}
    for name in ("blend_fwd_kernel", "blend_bwd_kernel"):
        if name not in text:
            continue
        lp = sass_loops(text, name)
        out[name] = lp["inner"] / lp["exps"]
        print(f"sass [{name}] entry loop {lp['inner']} instructions, "
              f"{lp['exps']} exp; enclosing loop {lp['outer']}")
        if name == "blend_bwd_kernel" and lp["outer"]:
            out[name + "/slot"] = (lp["outer"] - lp["inner"]) / chunk
    return out


def instr_floor_ms(instr: float, clock_mhz: float, n_sm: int) -> float:
    """Least time to dispatch `instr` thread-instructions: 32 lanes a warp,
    WARP_INSTR_PER_SM_CLOCK warp-instructions per SM and clock."""
    return instr / 32 / (WARP_INSTR_PER_SM_CLOCK * n_sm * clock_mhz * 1e6) * 1e3


def ragged_entries(seed: int, tile_h: int, tile_w: int, C: int,
                   K: int = 128):
    """Synthetic ent [T, K, 16] / meta [T, 4] and cotangents, from numpy.

    Per-tile counts sit at the kernels' chunk edges C (0, 1, C - 1, C, C + 1,
    K - 1, K and one above K, which the kernels clamp), each on a few tiles
    at random origins of a 1080p frame, one of them the last tile
    (1904, 1072). Rows past a tile's count, and columns 10-15, hold finite
    garbage the kernels must ignore. The last tile's first two entries are
    opaque and cover it, so every pixel stops at entry 1, the earliest a
    pixel can stop (alpha <= 0.99 keeps entry 0)."""
    rng = np.random.default_rng(seed + 3)
    counts = [0, 1, C - 1, C, C + 1, K - 1, K, K + 5] * 3 + [K]
    T, P = len(counts), tile_h * tile_w
    ox = tile_w * rng.integers(0, 1920 // tile_w, T)
    oy = tile_h * rng.integers(0, 1080 // tile_h, T)
    ox[-2], oy[-2] = 1920 - tile_w, 1080 - tile_h
    mx = ox[:, None] + rng.uniform(-2 * tile_w, 3 * tile_w, (T, K))
    my = oy[:, None] + rng.uniform(-2 * tile_h, 3 * tile_h, (T, K))
    # conics of covariances with sigmas 1-20 px at random angles
    sx, sy = rng.uniform(1.0, 20.0, (2, T, K))
    th = rng.uniform(0.0, np.pi, (T, K))
    cs, sn = np.cos(th), np.sin(th)
    a = cs * cs * sx * sx + sn * sn * sy * sy
    b = cs * sn * (sx * sx - sy * sy)
    c = sn * sn * sx * sx + cs * cs * sy * sy
    det = a * c - b * b
    ent = rng.standard_normal((T, K, 16))
    ent[..., 0], ent[..., 1] = mx, my
    ent[..., 2], ent[..., 3], ent[..., 4] = c / det, -b / det, a / det
    ent[..., 5:8] = rng.random((T, K, 3))
    ent[..., 8] = rng.uniform(0.05, 0.99, (T, K))
    ent[..., 9] = rng.uniform(0.5, 10.0, (T, K))
    stop = ent[-1, :2]
    stop[:, 0], stop[:, 1] = ox[-1] + tile_w / 2, oy[-1] + tile_h / 2
    stop[:, 2], stop[:, 3], stop[:, 4], stop[:, 8] = 1e-5, 0.0, 1e-5, 1.0
    meta = np.stack([np.array(counts), ox, oy, np.zeros(T, np.int64)], 1)
    cts = [rng.standard_normal(sh).astype(np.float32) / P
           for sh in ((T, P, 3), (T, P), (T, P))]
    return ent.astype(np.float32), meta.astype(np.int32), cts


def phase_ragged(B, device, seed: int, chunk: int) -> None:
    """Both kernels against their plain versions on ragged_entries, for
    every tile shape the kernels are built for."""
    import torch

    for th, tw in B.KERNEL_TILES:
        ent, meta, cts = ragged_entries(seed, th, tw, chunk)
        ent, meta = (torch.from_numpy(x).to(device) for x in (ent, meta))
        cts = [torch.from_numpy(x).to(device) for x in cts]
        k = B.blend_fwd(ent, meta, th, tw)
        p = B.blend_fwd_plain(ent, meta, th, tw)
        errs = [(a - b).abs().max().item() for a, b in zip(k[:3], p[:3])]
        count = meta[:, :1].float()
        ncon_k, ncon_p = (torch.minimum(x[3], count) for x in (k, p))
        check(errs[0] <= 3e-5 and errs[1] <= 3e-5, f"ragged {th}x{tw}: K1 "
              "image 3e-5")
        check(errs[2] <= 3e-4, f"ragged {th}x{tw}: K1 depth 3e-4")
        check(torch.equal(ncon_k, ncon_p),
              f"ragged {th}x{tw}: K1 min(ncon, count) equal")
        check(bool((ncon_k[-1] == 1).all()),
              f"ragged {th}x{tw}: every pixel of the last tile stops at 1")
        d1 = B.blend_bwd(ent, meta, k[1], k[3], *cts, th, tw)
        d2 = B.blend_bwd(ent, meta, k[1], k[3], *cts, th, tw)
        dp = B.blend_bwd_plain(ent, meta, k[1], k[3], *cts, th, tw)
        print(f"ragged {th}x{tw}: counts {sorted(set(meta[:, 0].tolist()))},"
              f" K1 max|d| {errs}")
        check_bwd(d1, dp, bwd_scale(B, ent, meta, k[1], k[3], *cts, th, tw),
                  meta, f"ragged {th}x{tw}: K2")
        check(torch.equal(d1, d2), f"ragged {th}x{tw}: K2 bitwise "
              "deterministic")
        print(f"ragged {th}x{tw}: two K2 calls equal")


def bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def main_path(state, cam, device, seed):
    """Target render, 10 gaussian_train_steps, 5 pose_train_steps.
    Returns (gaussian losses, pose losses, median step ms, metrics)."""
    import torch

    from ht3dgs_torch.core import adam
    from ht3dgs_torch.core.se3 import se3_exp
    from ht3dgs_torch.train import step

    target = step.render_eval(state, cam, mode="tiled",
                              tile_args=TILE_ARGS)["image"]
    g = torch.Generator(device=device).manual_seed(seed + 1)
    pert = state.replace_params(dict(
        state.params(),
        means=state.means + 0.01 * torch.randn(
            state.means.shape, generator=g, device=device),
        opacity_logit=state.opacity_logit - 0.5))
    opt = adam.init(pert.params())
    losses, step_ms = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pert, opt, m = step.gaussian_train_step(
            pert, opt, cam, target, LRS, mode="tiled", tile_args=TILE_ARGS)
        loss = m["loss"].item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    drops = {k: int(m[k]) for k in ("n_dropped_m", "n_dropped_tile")}

    base = se3_exp(torch.tensor([0.05, -0.04, 0.03, 0.01, -0.008, 0.006],
                                device=device))
    pose_target = step.render_eval(state, cam, mode="tiled",
                                   tile_args=POSE_TILE_ARGS)["image"]
    delta = torch.zeros(6, device=device)
    pose_opt = step.init_pose_opt(device)
    pose_losses = []
    for _ in range(5):
        delta, pose_opt, pm = step.pose_train_step(
            state, delta, base, pose_opt, cam, pose_target, POSE_LR,
            mode="tiled", tile_args=POSE_TILE_ARGS)
        pose_losses.append(pm["loss"].item())
    return (losses, pose_losses, statistics.median(step_ms), drops,
            (pert, opt, target))


def profile_step(state, opt, cam, target, path, step_ms):
    """One gaussian_train_step under torch.profiler: device time by kernel
    written to `path`; printed: the kernels' total time, as a share of the
    profiled step and of the unprofiled median step `step_ms`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ht3dgs_torch.train import step

    def one():
        step.gaussian_train_step(state, opt, cam, target, LRS, mode="tiled",
                                 tile_args=TILE_ARGS)
        torch.cuda.synchronize()

    one()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    # device-side rows only (kernels, copies): the operator rows repeat
    # their kernels' time
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    with open(path, "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=60))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(f"profile: device busy {busy_us / 1e3:.3f} ms = "
          f"{100 * busy_us / wall_us:.1f}% of the profiled step "
          f"({wall_us / 1e3:.2f} ms), {100 * busy_us / 1e3 / step_ms:.1f}% "
          f"of the median step ({step_ms:.2f} ms); table in {path}")
    for e in top:
        print(f"profile: {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<4d} {e.key[:90]}")


def small_reference(device, seed):
    """Tiled render (kernels) vs the oracle render on a small scene."""
    import torch

    from ht3dgs_torch.core.camera import intrinsics_from_fov, make_camera
    from ht3dgs_torch.core.gaussians import create_from_pcd
    from ht3dgs_torch.raster import render

    rng = np.random.default_rng(seed + 2)
    n, h, w = 2000, 96, 128
    pts = rng.standard_normal((n, 3)).astype(np.float32) * 0.6
    pts[:, 2] += 3.0
    st = create_from_pcd(pts, rng.random((n, 3)).astype(np.float32), n,
                         device=device)
    # opacities <= 0.29: above ~0.35 the tiled path's 3-sigma cap on the
    # binning extents (projection.py) drops a tail the oracle still draws
    st = dataclasses.replace(st, opacity_logit=torch.tensor(
        rng.uniform(-3.0, -0.9, (n, 1)), dtype=torch.float32, device=device))
    cam = make_camera(h, w, intrinsics_from_fov(1.2, h, w), device=device)
    outs, grads = {}, {}
    for mode in ("tiled", "oracle"):
        means = st.means.detach().requires_grad_(True)
        out = render(st.replace_params(dict(st.params(), means=means)), cam,
                     mode=mode, tile_args=dict(TILE_ARGS, dup_factor=48,
                                               max_per_tile=n)
                     if mode == "tiled" else None)
        (out["image"].pow(2).mean() + 0.01 * out["depth"].mean()).backward()
        outs[mode], grads[mode] = out, means.grad
    errs = {k: (outs["tiled"][k] - outs["oracle"][k]).abs().max().item()
            for k in ("image", "depth", "alpha")}
    g_err = (grads["tiled"] - grads["oracle"]).abs().max().item()
    g_max = grads["oracle"].abs().max().item()
    print(f"small scene tiled vs oracle: max|d| {errs}, means grad "
          f"{g_err:.3e} of max {g_max:.3e}")
    check(int(outs["tiled"]["n_dropped"]) == 0, "small scene: no drops")
    check(errs["image"] <= 3e-5 and errs["alpha"] <= 3e-5,
          "small scene image 3e-5")
    check(errs["depth"] <= 3e-4, "small scene depth 3e-4")
    check(g_err <= 1e-4 * g_max, "small scene means grad 1e-4 of max")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="PATH",
                    help="also profile one train step with torch.profiler "
                    "and write its table of device time by kernel to PATH")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from ht3dgs_torch import kernels
    from ht3dgs_torch.core.camera import intrinsics_from_fov, make_camera
    from ht3dgs_torch.raster import blend as B

    device = torch.device("cuda")
    t_start = time.perf_counter()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    for name, log in kernels.build().items():
        for line in log.splitlines():
            if any(s in line for s in ("registers", "spill", "smem")):
                print(f"ptxas [{name}] {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s")
    # entry rows per chunk, from the build (blend_common.cuh)
    chunk = kernels.load("blend_bwd").ht3dgs_blend_chunk()
    per_eval = {}
    for name in kernels.SOURCES:
        per_eval.update(sass_per_eval(kernels.sass(name), chunk))

    # 2. scene
    t0 = time.perf_counter()
    state = make_scene(args.seed, device)
    cam = make_camera(H, W, intrinsics_from_fov(1.2, H, W), device=device)
    ent, meta, total, nd_m, nd_tile = kernel_entries(state, cam)
    T, K, _ = ent.shape
    P = 16 * 16
    print(f"scene: {N} Gaussians, {W}x{H}, T={T} tiles, K={K}, "
          f"{total} entries, dropped m={nd_m} tile={nd_tile}, "
          f"{time.perf_counter() - t0:.1f} s")

    # 3-4. kernels vs plain versions
    rec_fwd, ncon, t_fin, n_eval = phase_fwd(B, ent, meta, P)
    rec_bwd, n_kept, n_slot = phase_bwd(B, ent, meta, t_fin, ncon, P,
                                        args.seed)
    del ent, meta, ncon, t_fin

    # 5. ragged edges
    phase_ragged(B, device, args.seed, chunk)

    # 6. main path
    B.blend_fwd.launches = 0
    B.blend_bwd.launches = 0
    losses, pose_losses, step_ms, drops, trained = main_path(
        state, cam, device, args.seed)
    launches = {"blend_fwd": B.blend_fwd.launches,
                "blend_bwd": B.blend_bwd.launches}
    print(f"gaussian_train_step losses: {losses}")
    print(f"pose_train_step losses: {pose_losses}")
    print(f"drops in the last step: {drops}; launches on the main path: "
          f"{launches}")
    for name, seq in (("gaussian", losses), ("pose", pose_losses)):
        check(all(np.isfinite(seq)), f"{name} losses finite")
        check(seq[-1] < seq[0], f"{name} loss falls")
    n_steps = len(losses) + len(pose_losses)
    check(launches["blend_fwd"] >= n_steps, "K1 launched every step")
    check(launches["blend_bwd"] >= n_steps, "K2 launched every step")
    rec_fwd["launches"] = launches["blend_fwd"]
    rec_bwd["launches"] = launches["blend_bwd"]

    # 7. small scene against the oracle
    small_reference(device, args.seed)
    if args.profile:
        os.makedirs(os.path.dirname(os.path.abspath(args.profile)),
                    exist_ok=True)
        profile_step(*trained[:2], cam, trained[2], args.profile, step_ms)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gpu = smi.splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    floors = {
        "blend_fwd": instr_floor_ms(
            n_eval * per_eval["blend_fwd_kernel"], clock_mhz, n_sm),
        "blend_bwd": instr_floor_ms(
            n_kept * per_eval["blend_bwd_kernel"]
            + n_slot * per_eval["blend_bwd_kernel/slot"], clock_mhz, n_sm)}
    print(f"instruction floor (SASS instructions / ({WARP_INSTR_PER_SM_CLOCK} per SM and "
          f"clock x {n_sm} SMs x {clock_mhz:.0f} MHz max SM clock)): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in floors.items())
          + f"; instructions per evaluation {per_eval}")
    print(f"step: median {step_ms:.2f} ms, {H * W / 1e6 / (step_ms / 1e3):.3f}"
          f" MP/s fwd+bwd+Adam ({N} Gaussians, {W}x{H}; {gpu})")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    recs = [rec_fwd, rec_bwd]
    print("kernels " + json.dumps([
        {"name": r["name"], "launches": r["launches"],
         "max_dev": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]} for r in recs]))
    print(gpu)
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
