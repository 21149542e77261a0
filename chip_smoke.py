#!/usr/bin/env python3
"""Drive ht3dgs_torch's training step on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed 0] [--profile PATH]

Phases (any failure exits non-zero):
1. build both blend kernels from csrc/ with nvcc for sm_90a and print
   ptxas's register / shared-memory / spill report;
2. set up the trained-statistics scene: 1,000,000 Gaussians at SH degree 3
   (random, from --seed), bimodal opacities, 1920x1080, fovx 1.2, 16x16
   tiles, max_per_tile 128, dup_factor 1.25;
3. hold kernel K1 (blend forward) against its plain PyTorch version on the
   scene's packed entries, and time both;
4. hold kernel K2 (blend backward) against its plain version on the same
   entries and random cotangents, and time both;
5. the main path: with every launch count at 0, render a target from the
   true scene, take 10 gaussian_train_steps from a perturbed copy and 5
   pose_train_steps from a perturbed pose; the losses must be finite and
   fall, and each kernel must have run at least once per step;
6. on a small scene, the tiled render (kernels) against the oracle render
   (plain PyTorch, O(N*H*W)), image and means gradient.
It prints the card's name and power limit, one JSON line of kernel numbers,
and last the line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
# float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations per entry-pixel evaluation, counted from the kernel sources
# (exp counted as one): forward ~28; backward ~55 per kept entry-pixel plus
# ~10 adds per entry-pixel for the pixel reduction
OPS_FWD = 28
OPS_BWD_KEPT = 55
OPS_BWD_REDUCE = 10


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
    """K1 vs its plain version: returns (record, ncon)."""
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
    return rec, ncon, k[1]


def phase_bwd(B, ent, meta, t_fin, ncon, P, seed):
    import torch

    T, K, _ = ent.shape
    g = torch.Generator(device=ent.device).manual_seed(seed)
    cts = [torch.randn(s, generator=g, device=ent.device) / P
           for s in ((T, P, 3), (T, P), (T, P))]
    k = B.blend_bwd(ent, meta, t_fin, ncon, *cts, 16, 16)
    p = B.blend_bwd_plain(ent, meta, t_fin, ncon, *cts, 16, 16)
    torch.cuda.synchronize()
    err = (k - p).abs()
    col_err = err.amax(dim=(0, 1))
    col_tol = 1e-4 * p.abs().amax(dim=(0, 1)) + 1e-6
    print(f"K2 vs plain: max|d| per column {col_err[:10].tolist()}")
    check(bool((col_err <= col_tol).all()),
          "K2 per column 1e-4 * max|ref| + 1e-6")
    count = meta[:, :1].long()
    pad = torch.arange(K, device=ent.device)[None, :] >= count
    check(not k[pad].any().item(), "K2 exact zeros on rows k >= count")
    check(not k[..., 10:].any().item(), "K2 exact zeros in columns 10-15")

    ms = cuda_ms(lambda: B.blend_bwd(ent, meta, t_fin, ncon, *cts, 16, 16),
                 20)
    plain_ms = cuda_ms(
        lambda: B.blend_bwd_plain(ent, meta, t_fin, ncon, *cts, 16, 16), 3)
    last = torch.minimum(ncon.amax(dim=1), count[:, 0].float())
    n_kept = ncon.sum().item()
    n_reduce = last.sum().item() * P
    nbytes = last.sum().item() * 64 + T * 16 + T * P * 7 * 4 + T * K * 64
    rec = dict(name="blend_bwd", route="cuda",
               source="ht3dgs_torch/csrc/blend_bwd.cu",
               replaces="ht3dgs/raster/pallas_blend.py:291",
               max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
               **bound(nbytes, n_kept * OPS_BWD_KEPT
                       + n_reduce * OPS_BWD_REDUCE), library_ms=None)
    print(f"K2: {ms:.4f} ms/call, plain {plain_ms:.3f} ms, "
          f"{n_kept:.0f} kept entry-pixels, {nbytes / 1e6:.1f} MB")
    return rec


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
    rec_fwd, ncon, t_fin = phase_fwd(B, ent, meta, P)
    rec_bwd = phase_bwd(B, ent, meta, t_fin, ncon, P, args.seed)
    del ent, meta, ncon, t_fin

    # 5. main path
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

    # 6. small scene against the oracle
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
