#!/usr/bin/env python3
"""Drive ht3dgs_torch's training step, hierarchical trainer, eval modes,
viewer bridge, networks and multi-device path on one NVIDIA card and
check them.

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
   garbage in the pad rows, for every tile shape the kernels are built for
   at K = 128, and for 16x16 tiles at K = 2048 (counts 2047 and 2048, the
   hierarchy's preset); both kernels against their plain versions, K2 twice
   for bitwise determinism;
6. the main path: with every launch count at 0, render a target from the
   true scene, take 10 gaussian_train_steps from a perturbed copy and 5
   pose_train_steps from a perturbed pose; the losses must be finite and
   fall, and each kernel (K1, K2, P1, P2) must have run at least once per
   step;
7. on a small scene, the tiled render (kernels) against the oracle render
   (plain PyTorch, O(N*H*W)), image and means gradient;
8. the hierarchical trainer: HTGaussianTrainer.hierarchical_training on the
   repo's "full" tier (a synthetic 16-frame video at 256x192 from 4,000
   Gaussians, frames and depths in memory, the tier's recipe, its budgets
   cut to HIER_CUTS and the root's MSS budgets cut, see tier_configs):
   Phase A (batched steps of 4 models), two leaves with densify/prune, a
   merge, the root's MSS phase 1 and 2, the eval sweep (batched renders)
   and the checkpoint. Checks: finite relative poses within 3 degrees of
   the truth, the root covering every frame, train-view PSNR above 18 dB,
   model.npz reloading to a bit-equal render, each kernel launched at
   least once per step in every trainer phase, and in Phase A K2 once per
   batched step; it prints steps and model-steps per trainer phase, and
   the root's step timed at the last training step's tile arguments and at
   the eval sweep's, which grows K after training;
9. the eval path on phase 8's root, with every launch count at 0 first:
   eval_pose (ATE/RPE equal to phase 8's to 1e-6), eval_nvs (16 frames x
   50 test-time pose steps as 50 batched steps of one shared model under
   16 poses, mean PSNR above 18 dB, K1 and K2 once per batched step),
   render_nvs (120 PNGs, each the render it holds,
   finite and not constant), the SIBR viewer bridge on a loopback port (4
   requests at 256x192 and 4 at 1920x1080, each reply byte for byte the
   uint8 of render_eval at the same camera) and a PLY round trip that
   renders frame 0 bit for bit; then the host share of one batched pose
   step;
10. IFRNet and LPIPS with seeded random weights: the card (float32, no
   TF32) against the CPU on a 256x192 pair (IFRNet max |d| <= 1e-4, LPIPS
   relative <= 1e-5), then the median ms, peak memory and kernel launches
   at 1920x1080 (IFRNet also on cuDNN's convolutions, for comparison);
11. multi-device (torch.distributed, one process per rank): (a) the
   hierarchy step on a (1, 1) mesh of one NCCL rank, and (b) on a (1, 4)
   mesh of 4 gloo ranks sharing the card, without and with compact_n, and
   the Gaussian-sharded step, each held to gaussian_train_step on the
   trained-stats scene (rotated, anisotropic: mesh_scene) at tile arguments
   that drop no entry; (c) the full tier's hierarchical_training, at
   phase 13's depth (FILES_CUTS), on a (2, 2) mesh of 4 gloo ranks, each
   rank in a working directory of its own and with deterministic
   algorithms after Phase A: poses within 3
   degrees, PSNR above 18 dB, the root covering every frame and bit-equal
   on every rank (SHA-256), K1 and K2 launched once per step in every
   trainer phase of every rank; it prints the phase table, all-reduce and
   broadcast times and the host share of a root step on a (1, 4) mesh,
   with and without deterministic algorithms. Then the same run
   again from rank 0's Phase A poses, ended where the root would start,
   and resumed from the crumbs and poses in rank 0's directory alone
   under a process-group timeout of half the root's seconds, which ranks
   2 and 3 wait out: the resumed root equals the uninterrupted one on
   every rank (digest, poses, generator);
12. the batch axis at the operating point: 4 perturbed copies of phase 2's
   scene at one capacity. One batched Phase A step (phase_a.fit_step)
   against gaussian_train_step on each model, and one batched pose step
   of one model under 4 poses against pose_train_step on each, under
   deterministic algorithms (phase 11's tolerances); K1 and K2 launched
   once per batched step; the batched K1/K2 outputs equal to one launch
   per image's tiles bit for bit; K1/K2 against their plain versions and
   timed at the 4 x 8160-tile launch; the batched step's time against the
   4 single steps (batched, singles, singles, batched), its host share and
   the peak memory;
13. the normal entry point from files on disk, as a user with a video
   runs it: (a) every fixture of tests/torch_images/ decoded by the port's
   own decoder (csrc/imgdec.cc, built in phase 1 with the host compiler)
   to the SHA-256 of Pillow's arrays in its manifest, the 1080p frame's
   LANCZOS 1600x900 resize included; (b) the host time of a 1080p JPEG
   and PNG decode and of that resize (median of 10); (c) phase 8's tier
   and cuts, at a smaller training depth (FILES_CUTS), written as 16 PNG
   frames with .npy depths, a
   transforms_train.json of the true poses and a cfg.yml, then
   `run.main(["--mode", "train", "--config", cfg.yml])`, eval_pose and
   eval_nvs in-process and eval_pose once more as `python -m
   ht3dgs_torch`: phase 8's gates (poses within 3 degrees, train-view PSNR
   above 18 dB), K1 and K2 launched, pose_eval.txt and test/test.txt
   written; it prints one `files` line. It runs right after phase 8, so
   that the two trainings of the tier are timed in the same state of the
   process and the host;
14. the paper's hierarchy depth from files ("scale"): the photo scene at
   the scale tier's size (48 frames at 208x160, exact depths) with the
   tier's recipe (train_level 2, partition v1; budgets cut, SCALE_CUTS)
   as a cfg.yml, trained by `run.main(["--mode", "train", "--config",
   cfg.yml])`: 4 leaves, 2 merged level-1 non-leaves, the root, MSS phase
   1 at both non-leaf levels. Checks: PSNR above 18 dB, rotations within
   3 degrees, the root covering frames 0-47, 3 merges and 3 MSS phase 1
   runs, K1 and K2 once per step in every trainer phase; it prints the
   partition, each bundle's live rows, capacity and M, the per-phase
   table with drops and tile arguments, and the peak memory. Then the
   root's step at the last training step's tile arguments (checked to be
   its K) and at the eval sweep's, each timed with its host share; the
   first under torch.profiler: device ms by kernel (top 12) and by layer
   (projection + SH, binning, K1, K2, assemble, loss, Adam, densify
   stats), and the binning's filled slots against M with the kept entries
   and the drops at K; and K1 and K2 at the root's training shape (frame
   0's entry lists, T = 130 tiles, K as trained) against their plain
   versions under phases 3-4's tolerances, timed, with their bound and
   instruction floor, and Phase A's shape (B x T tiles);
15. the published configs ("published"): configs/tanks/Family.yml and
   configs/co3d/hydrant_106_12648_23157.yml through `run.main(["--config",
   ...])` with the configs' own recipe (train_level 2, partition v1, VFI
   pose mode, base+vfi MSS, render_mode auto, no init cap, the renderer's
   default tile arguments with auto-grow, Phase A batch 8, opacity resets)
   and only the iteration budgets cut (PUBLISHED_CUTS) and the precomputed
   VFI provider on the CLI, each override printed with its reason. The
   photo scene is written where each config reads it: Family as 24 frames
   at 1600x900 with a COLMAP eval set (12 train, 12 test frames), the CO3D
   sequence as 16 frames at 1200x900 with frame annotations (14 train, 2
   test), exact depths and midpoint frames as the VFI frames. Family runs
   train, eval_pose, eval_nvs and render; the CO3D config train, eval_nvs
   and render (its eval_pose raises ValueError in both packages, which is
   checked). Family's scene is written by a process on the host during
   phases 12 and 14; the CO3D config runs in a second process (this
   script with --published), which writes its scene during Family's Phase
   A and trains after it, so the two share the card from then on and
   their per-phase times are those of a shared card. Gates per config: the
   recipe kept, PNG frames at their size,
   every VFI-frame depth read from its file, train-view PSNR above 18 dB,
   rotations within 3 degrees, eval_nvs PSNR above 18 dB, 120 rendered
   frames, model.npz, K1 and K2 once per step in every trainer phase. It
   prints the seconds, steps, ms per step, drops, tile arguments, opacity
   resets and peak memory per trainer phase, every change of the tile
   arguments, each bundle's live rows, capacity and M, the init points per
   frame and the host seconds rendering the scene and decoding frames.
   Then K1 and K2 at Family's trained root (frame 0's entry lists at the
   training's last tile arguments, T = 5,700 tiles) against their plain
   versions under phases 3-4's tolerances, timed, with bound and
   instruction floor, and Phase A's launch shape (B x T tiles).
16. the projection kernels ("project", right after phase 5): P1 and P2
   (csrc/project.cu) against their plain versions (project_fwd_plain,
   project_bwd_plain) on seeded random raw fields at the cells' shapes:
   the leaf's 4,194,304 rows (10% live, at the front as the trainer keeps
   them) and Phase A's 8 x 1,048,576 stacked rows (39% live), both under
   1600x900 cameras at SH degree 3; at Phase A's shape also one model
   shared by the 8 views with a posed render frame per view (the pose
   fits' call). Radii, valid and extents are compared exactly, the other
   outputs and every gradient within PROJECT_TOL; the means gradient alone
   (a pose step's call) bit for bit the full call's. Each kernel is timed
   with its bytes bound, against the layer as autograd ran it (the plain
   forward and its autograd backward);
It prints the wall seconds of each group of phases (`wall:` lines), the
card's name and power limit, one JSON line of kernel numbers
(each kernel's 1080p figures, under "scale_root" phase 14's and under
"published_root" phase 15's), and last the line {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# f32 operations of the projection kernels per live (P1) and valid (P2)
# row at SH degree 3, counted roughly from csrc/project.cu; both are bound
# by bytes by three orders of magnitude
OPS_P1 = 300
OPS_P2 = 800
# Projection + SH at the cells' shapes: rows a model, stacked models (None:
# one), the share of live rows (the cells' live_rows_pct), height, width
PROJECT_SHAPES = {"leaf": (4_194_304, None, 0.101, 900, 1600),
                  "phase_a": (1_048_576, 8, 0.386, 900, 1600)}
# P1/P2 against their plain versions: |k - p| <= PROJECT_TOL * (|p| + the
# tensor's largest |p|). P1 computes in the plain version's order, its
# products and sums included (csrc/project.cu), and read 0 on every output
# of phase 16; P2 differs by f32 rounding of products and sums taken in
# other orders, up to 1.1e-7 in phase 16 (measured on one H100)
PROJECT_TOL = 1e-5
# a warp scheduler dispatches one warp-instruction per clock, four per SM
WARP_INSTR_PER_SM_CLOCK = 4
# K2's error per entry, as a share of its bwd_scale: about the f32 rounding
# of a 128-entry replay chain (128 x 2^-24 = 7.6e-6)
ENTRY_TOL = 1e-5
# the longest tile lists phase 5 checks: the hierarchy's preset max_per_tile
LONG_K = 2048


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


def phase_fwd(B, ent, meta, P, what: str = "K1", plain_reps: int = 3):
    """K1 vs its plain version, both timed (the plain one over plain_reps
    calls): returns (record, ncon, t_fin, blend_work's counts)."""
    import torch

    from ht3dgs_torch.utils.profiling import blend_work

    k = B.blend_fwd(ent, meta, 16, 16)
    p = B.blend_fwd_plain(ent, meta, 16, 16)
    torch.cuda.synchronize()
    names = ("rgb", "t_fin", "depth")
    errs = {n: (a - b).abs().max().item() for n, a, b in zip(names, k, p)}
    count = meta[:, :1].float()
    ncon_equal = torch.equal(torch.minimum(k[3], count),
                             torch.minimum(p[3], count))
    print(f"{what} vs plain: max|d| {errs}, min(ncon,count) equal: "
          f"{ncon_equal}")
    check(errs["rgb"] <= 3e-5 and errs["t_fin"] <= 3e-5, f"{what} image 3e-5")
    check(errs["depth"] <= 3e-4, f"{what} depth 3e-4")
    check(ncon_equal, f"{what} min(ncon, count) equal to the plain version's")

    ms = cuda_ms(lambda: B.blend_fwd(ent, meta, 16, 16), 20)
    plain_ms = cuda_ms(lambda: B.blend_fwd_plain(ent, meta, 16, 16),
                       plain_reps)
    work = blend_work(ent, meta, k[3], P)
    rec = dict(name="blend_fwd", route="cuda",
               source="ht3dgs_torch/csrc/blend_fwd.cu",
               replaces="ht3dgs/raster/pallas_blend.py:167",
               max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
               **bound(work["fwd_bytes"], work["n_eval"] * OPS_FWD),
               library_ms=None)
    print(f"{what}: {ms:.4f} ms/call, plain {plain_ms:.3f} ms, "
          f"{work['n_eval']:.0f} entry-pixel evaluations, "
          f"{work['fwd_bytes'] / 1e6:.1f} MB")
    return rec, k[3], k[1], work


def phase_bwd(B, ent, meta, t_fin, ncon, P, seed, what: str = "K2",
              plain_reps: int = 3):
    """K2 vs its plain version on seeded random cotangents, per column and
    per entry (bwd_scale), both timed: returns the record."""
    import torch

    from ht3dgs_torch.utils.profiling import blend_work

    T, K, _ = ent.shape
    g = torch.Generator(device=ent.device).manual_seed(seed)
    cts = [torch.randn(s, generator=g, device=ent.device) / P
           for s in ((T, P, 3), (T, P), (T, P))]
    k = B.blend_bwd(ent, meta, t_fin, ncon, *cts, 16, 16)
    p = B.blend_bwd_plain(ent, meta, t_fin, ncon, *cts, 16, 16)
    scale = bwd_scale(B, ent, meta, t_fin, ncon, *cts, 16, 16)
    check_bwd(k, p, scale, meta, what)
    err = (k - p).abs()
    del p, scale

    ms = cuda_ms(lambda: B.blend_bwd(ent, meta, t_fin, ncon, *cts, 16, 16),
                 20)
    plain_ms = cuda_ms(
        lambda: B.blend_bwd_plain(ent, meta, t_fin, ncon, *cts, 16, 16),
        plain_reps)
    work = blend_work(ent, meta, ncon, P)
    rec = dict(name="blend_bwd", route="cuda",
               source="ht3dgs_torch/csrc/blend_bwd.cu",
               replaces="ht3dgs/raster/pallas_blend.py:291",
               max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
               **bound(work["bwd_bytes"], work["n_kept"] * OPS_BWD_KEPT
                       + work["n_slot"] * OPS_BWD_SLOT), library_ms=None)
    print(f"{what}: {ms:.4f} ms/call, plain {plain_ms:.3f} ms, "
          f"{work['n_kept']:.0f} kept entry-pixels, {work['n_slot']:.0f} "
          f"entry-pixel slots, {work['bwd_bytes'] / 1e6:.1f} MB")
    return rec


def project_scene(device, seed: int, shape: str, shared: bool = False):
    """Raw fields, live rows, cameras and the SH degree (3) at one of
    PROJECT_SHAPES, from seed: points in the cameras' frustum at depths
    0.5-12 (2% behind the near plane), log-scales around -4.5, opacity
    logits N(0, 2) (a few under 1/255), SH degree 3. shared: model 0 alone
    under the views, with a posed render frame per view, the model's means
    for the SH direction and a pose-inverse center per view. Returns
    (fields, live, camera, degree, project keywords)."""
    import torch

    from ht3dgs_torch.core.camera import intrinsics_from_fov, make_camera
    from ht3dgs_torch.train.phase_a import stack_cameras

    n, models, live_share, h, w = PROJECT_SHAPES[shape]
    lead = () if models is None else (models,)
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*s):
        return torch.randn(*lead, n, *s, generator=g, device=device)

    def uni(*s):
        return torch.rand(*lead, n, *s, generator=g, device=device)

    z = 0.5 + 11.5 * uni()
    z = torch.where(uni() < 0.02, 0.15 * uni(), z)
    xy = (2.0 * uni(2) - 1.0) * 0.75 * z[..., None]
    fields = dict(means=torch.cat([xy, z[..., None]], -1),
                  log_scales=0.7 * rnd(3) - 4.5, quats=rnd(4),
                  opacity_logit=2.0 * rnd(1), sh_dc=rnd(1, 3),
                  sh_rest=0.1 * rnd(15, 3))
    # the trainer keeps its live rows at the front of the capacity
    # (densify's compaction), with a few pruned ones among them
    row = torch.arange(n, device=device)
    live = (row < int(live_share * n)) & (uni() > 0.01)
    K = intrinsics_from_fov(1.2, h, w)
    rng = np.random.default_rng(seed)
    cams = []
    for _ in range(models or 1):
        a, b = rng.normal(0.0, 0.05, 2)
        wv = np.eye(4, dtype=np.float32)
        wv[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]]
        wv[:3, 3] = [b, 0.0, 0.0]
        cams.append(make_camera(h, w, K, world_view=wv, device=device))
    cam = cams[0] if models is None else stack_cameras(cams)
    degree = torch.tensor(3, dtype=torch.int32, device=device)
    kw = {}
    if shared:
        fields = {k: v[0] for k, v in fields.items()}
        live = live[0]
        kw = dict(sh_means_override=fields["means"],
                  campos_override=torch.tensor(
                      rng.normal(0.0, 0.1, (models, 3)), dtype=torch.float32,
                      device=device))
        fields["means"] = fields["means"] + torch.tensor(
            rng.normal(0.0, 0.01, (models, 1, 3)), dtype=torch.float32,
            device=device)
    return fields, live, cam, degree, kw


def project_close(k, p, what: str, exact: bool = False) -> dict:
    """How far kernel output k is from the plain version's p: for a float
    tensor the largest |k - p| and the largest |k - p| / (|p| + max |p|)
    (checked <= PROJECT_TOL), for an exact comparison the elements that
    differ (checked 0)."""
    import torch

    if exact:
        bad = int((k != p).sum()) if k.dtype == torch.bool else int(
            (~((k == p) | (torch.isnan(k) & torch.isnan(p)))).sum())
        return {"what": what, "differ": bad}
    # equal values (the sanitised rows' +inf depths among them) differ by 0
    d = torch.where(k == p, 0.0, (k - p).abs())
    fin = torch.isfinite(p)
    scale = p.abs() + p.abs()[fin].max()
    rel = (d / scale.clamp(min=1e-30)).max().item() if d.numel() else 0.0
    return {"what": what, "max_abs": d.max().item() if d.numel() else 0.0,
            "rel": rel}


def project_check(device, seed: int, shape: str, shared: bool = False,
                  reps: int = 20) -> dict:
    """P1 and P2 against their plain versions at one of PROJECT_SHAPES
    (module docstring, phase 16), each timed with its bytes bound; the
    layer as autograd ran it, forward and backward, timed beside them.
    Returns the records and the comparisons."""
    import torch

    from ht3dgs_torch.raster import projection as PR

    fields, live, cam, degree, kw = project_scene(device, seed, shape,
                                                  shared)
    raw = [fields[k] for k in ("means", "log_scales", "quats",
                               "opacity_logit", "sh_dc", "sh_rest")]
    shm, campos = kw.get("sh_means_override"), kw.get("campos_override")
    rows = PR._camera_rows(cam, campos)
    hw = (cam.height, cam.width)

    def p1():
        return PR.project_fwd(*raw, shm, live, rows, degree, 3, 1.0, *hw)

    k = p1()
    p = PR.project_fwd_plain(*raw, live, cam, degree, 3, campos, shm)
    torch.cuda.synchronize()
    checks = [project_close(getattr(k, f), getattr(p, f), f, exact=f in (
        "radii", "valid", "extents")) for f in PR.Projected._fields]

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    diff = ("means2d", "depths", "conics", "colors", "opacities")
    cts = [torch.randn(getattr(k, f).shape, generator=gen, device=device)
           for f in diff]
    valid = k.valid
    inputs = (*raw, shm, live, rows, degree, 3, 1.0, *hw, valid, *cts)

    def p2(needs=(True,) * 7):
        return PR.project_bwd(*inputs, needs=needs)

    kg = p2()
    pg = PR.project_bwd_plain(*raw, shm, live, cam, degree, 3, campos, 1.0,
                              valid, *cts)
    names = ("d_means", "d_log_scales", "d_quats", "d_opacity_logit",
             "d_sh_dc", "d_sh_rest", "d_sh_means")
    checks += [project_close(a, b, n) for n, a, b in zip(names, kg, pg)
               if a is not None]
    means_only = p2((True,) + (False,) * 6)[0]
    checks.append(project_close(means_only, kg[0], "d_means alone",
                                exact=True))
    del pg, p
    for c in checks:
        print(f"project {shape}{' shared' if shared else ''} {c}")
    for c in checks:
        if "differ" in c:
            check(c["differ"] == 0, f"P1/P2 {shape} {c['what']} exact")
        else:
            check(c["rel"] <= PROJECT_TOL,
                  f"P1/P2 {shape} {c['what']} within {PROJECT_TOL}")

    # bytes each kernel must move, each once: P1 reads the live bytes and a
    # live row's parameters and writes every output; P2 reads the valid
    # bytes and a valid row's cotangents and parameters and writes every
    # gradient (the zero fill included)
    # (a shared model's row once, its render-frame means once a view)
    views = cam.world_view.shape[0] if shared else 1
    n_live = int(live.sum()) * views
    n_valid = int(valid.sum())
    row_bytes = 4 * (3 + 3 + 4 + 1 + 3 * 16) + (12 if shm is not None
                                                  else 0)
    means_bytes = 12 * (views - 1)
    out_bytes = sum(t.numel() * t.element_size() for t in k)
    fwd_bytes = (live.numel() + out_bytes
                 + int(live.sum()) * (row_bytes + means_bytes))
    bwd_bytes = (valid.numel() + sum(g.numel() * 4 for g in kg
                                     if g is not None)
                 + n_valid * 4 * 10
                 + int(valid.reshape(views, -1).any(0).sum())
                 * (row_bytes + means_bytes))
    p1_ms = cuda_ms(p1, reps)
    p2_ms = cuda_ms(p2, reps)

    leaves = [t.detach().clone().requires_grad_() for t in raw]

    def layer_before():
        out = PR.project_fwd_plain(*leaves, live, cam, degree, 3, campos,
                                   shm)
        loss = sum((torch.where(torch.isfinite(getattr(out, f)),
                                getattr(out, f), 0.0) * c).sum()
                   for f, c in zip(diff, cts))
        torch.autograd.grad(loss, leaves)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    plain_ms = cuda_ms(layer_before, 3)
    plain_mem = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()

    def layer_after():
        lv = [t.detach().requires_grad_() for t in raw]
        out = PR.project(*lv, live, cam, degree, 3, **kw)
        loss = sum((getattr(out, f) * c).sum() for f, c in zip(diff, cts))
        torch.autograd.grad(loss, lv)

    after_ms = cuda_ms(layer_after, 3)
    after_mem = torch.cuda.max_memory_allocated() - base
    tag = f"{shape}{'/shared' if shared else ''}"
    recs = []
    for name, ms, nbytes, ops in (
            ("project_fwd", p1_ms, fwd_bytes, n_live * OPS_P1),
            ("project_bwd", p2_ms, bwd_bytes, n_valid * OPS_P2)):
        rec = dict(name=name, shape=tag, route="cuda",
                   source="ht3dgs_torch/csrc/project.cu", replaces=None,
                   ms=ms, bytes=nbytes, **bound(nbytes, ops),
                   library_ms=None)
        recs.append(rec)
        print(f"{name} {tag}: {ms:.4f} ms/call, bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bound_by']}, {nbytes / 1e6:.1f} MB), "
              f"{100 * rec['bound_ms'] / ms:.1f}% of it")
    print(f"projection layer {tag} (forward + backward): before "
          f"{plain_ms:.3f} ms, {plain_mem / 2**30:.2f} GiB above the inputs; "
          f"after {after_ms:.3f} ms, {after_mem / 2**30:.2f} GiB; rows "
          f"{live.numel()} x views, live {n_live}, valid {n_valid}")
    return dict(records=recs, checks=checks, layer_before_ms=plain_ms,
                layer_after_ms=after_ms, before_gib=plain_mem / 2**30,
                after_gib=after_mem / 2**30, live=n_live, valid=n_valid)


def phase_project(device, seed: int) -> list:
    """Phase 16: project_check at the leaf's and Phase A's shapes, and the
    shared model under Phase A's views. Returns the kernel records."""
    import torch

    recs = []
    for shape, shared in (("leaf", False), ("phase_a", False),
                          ("phase_a", True)):
        recs += project_check(device, seed, shape, shared)["records"]
        torch.cuda.empty_cache()
    return recs


def floors(work: dict, per_eval: dict, clock_mhz: float, n_sm: int) -> dict:
    """Each blend kernel's instruction floor for blend_work's counts."""
    return {
        "blend_fwd": instr_floor_ms(
            work["n_eval"] * per_eval["blend_fwd_kernel"], clock_mhz, n_sm),
        "blend_bwd": instr_floor_ms(
            work["n_kept"] * per_eval["blend_bwd_kernel"]
            + work["n_slot"] * per_eval["blend_bwd_kernel/slot"], clock_mhz,
            n_sm)}


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


def check_bwd(got, ref, scale, meta, what: str,
              tol: float = ENTRY_TOL) -> None:
    """K2's d_ent against the plain version's: per column within 1e-4 of the
    column's largest |ref| + 1e-6; per entry within `tol` of its own scale
    (bwd_scale); exact zeros on rows k >= count and in columns 10-15."""
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
          f"|d| / scale {fmt(col_ratio.tolist())} (limit {tol:.3g})")
    check(bool((col_err <= col_tol).all()),
          f"{what} per column 1e-4 * max|ref| + 1e-6")
    check(bool((col_ratio <= tol).all()),
          f"{what} per entry {tol:.3g} * its scale")
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
                   K: int = 128, opacity=(0.05, 0.99)):
    """Synthetic ent [T, K, 16] / meta [T, 4] and cotangents, from numpy.

    Per-tile counts sit at the kernels' chunk edges C (0, 1, C - 1, C, C + 1,
    K - 1, K and one above K, which the kernels clamp), each on a few tiles
    at random origins of a 1080p frame, one of them the last tile
    (1904, 1072). Rows past a tile's count, and columns 10-15, hold finite
    garbage the kernels must ignore. The last tile's first two entries are
    opaque and cover it, so every pixel stops at entry 1, the earliest a
    pixel can stop (alpha <= 0.99 keeps entry 0). Opacities are uniform in
    `opacity`: low ones keep most pixels going to the end of a long list."""
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
    ent[..., 8] = rng.uniform(*opacity, (T, K))
    ent[..., 9] = rng.uniform(0.5, 10.0, (T, K))
    stop = ent[-1, :2]
    stop[:, 0], stop[:, 1] = ox[-1] + tile_w / 2, oy[-1] + tile_h / 2
    stop[:, 2], stop[:, 3], stop[:, 4], stop[:, 8] = 1e-5, 0.0, 1e-5, 1.0
    meta = np.stack([np.array(counts), ox, oy, np.zeros(T, np.int64)], 1)
    cts = [rng.standard_normal(sh).astype(np.float32) / P
           for sh in ((T, P, 3), (T, P), (T, P))]
    return ent.astype(np.float32), meta.astype(np.int32), cts


def entry_tol(K: int) -> float:
    """K2's per-entry limit for lists of up to K entries: ENTRY_TOL, or the
    f32 rounding of a K-entry chain (K x 2^-24) where that is larger."""
    return max(ENTRY_TOL, K * 2.0 ** -24)


def phase_ragged(B, device, seed: int, chunk: int) -> None:
    """Both kernels against their plain versions on ragged_entries, for
    every tile shape the kernels are built for at K = 128, and for 16x16 at
    K = LONG_K, the hierarchy's preset (mostly low opacities, so pixels
    blend through the whole list)."""
    import torch

    sets = [(th, tw, 128, (0.05, 0.99)) for th, tw in B.KERNEL_TILES]
    sets.append((16, 16, LONG_K, (0.004, 0.03)))
    for th, tw, K, opacity in sets:
        ent, meta, cts = ragged_entries(seed, th, tw, chunk, K, opacity)
        ent, meta = (torch.from_numpy(x).to(device) for x in (ent, meta))
        cts = [torch.from_numpy(x).to(device) for x in cts]
        k = B.blend_fwd(ent, meta, th, tw)
        p = B.blend_fwd_plain(ent, meta, th, tw)
        errs = [(a - b).abs().max().item() for a, b in zip(k[:3], p[:3])]
        count = meta[:, :1].float()
        ncon_k, ncon_p = (torch.minimum(x[3], count) for x in (k, p))
        what = f"ragged {th}x{tw} K={K}"
        check(errs[0] <= 3e-5 and errs[1] <= 3e-5, f"{what}: K1 image 3e-5")
        check(errs[2] <= 3e-4, f"{what}: K1 depth 3e-4")
        check(torch.equal(ncon_k, ncon_p), f"{what}: K1 min(ncon, count) "
              "equal")
        check(bool((ncon_k[-1] == 1).all()),
              f"{what}: every pixel of the last tile stops at 1")
        d1 = B.blend_bwd(ent, meta, k[1], k[3], *cts, th, tw)
        d2 = B.blend_bwd(ent, meta, k[1], k[3], *cts, th, tw)
        dp = B.blend_bwd_plain(ent, meta, k[1], k[3], *cts, th, tw)
        kept = torch.minimum(k[3], count)
        print(f"ragged {th}x{tw} K={K}: counts "
              f"{sorted(set(meta[:, 0].tolist()))}, K1 max|d| {errs}; "
              f"entries kept per pixel: max {kept.max().item():.0f}, "
              f"median {kept.median().item():.0f}")
        check_bwd(d1, dp, bwd_scale(B, ent, meta, k[1], k[3], *cts, th, tw),
                  meta, f"ragged {th}x{tw} K={K}: K2", entry_tol(K))
        check(torch.equal(d1, d2), f"ragged {th}x{tw} K={K}: K2 bitwise "
              "deterministic")
        print(f"ragged {th}x{tw} K={K}: two K2 calls equal")


def bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def perturbed(state, seed: int, device):
    """The main path's starting point: the means moved by 0.01 sigma
    noise (from seed + 1), every opacity logit lowered by 0.5."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed + 1)
    return state.replace_params(dict(
        state.params(),
        means=state.means + 0.01 * torch.randn(
            state.means.shape, generator=g, device=device),
        opacity_logit=state.opacity_logit - 0.5))


def mesh_scene(state, seed: int, device):
    """Phase 11's starting point: the perturbed scene with random
    rotations and anisotropic scales (from seed + 2). The scene's own
    identity rotations and isotropic scales leave the rotation gradient
    at rounding noise, which no tolerance can compare."""
    import torch

    st = perturbed(state, seed, device)
    g = torch.Generator(device=device).manual_seed(seed + 2)
    q = torch.randn(st.quats.shape, generator=g, device=device)
    return st.replace_params(dict(
        st.params(), quats=q / q.norm(dim=1, keepdim=True),
        log_scales=st.log_scales + 0.4 * torch.randn(
            st.log_scales.shape, generator=g, device=device)))


def main_path(state, cam, device, seed):
    """Target render, 10 gaussian_train_steps, 5 pose_train_steps.
    Returns (gaussian losses, pose losses, median step ms, metrics)."""
    import torch

    from ht3dgs_torch.core import adam
    from ht3dgs_torch.core.se3 import se3_exp
    from ht3dgs_torch.train import step

    target = step.render_eval(state, cam, mode="tiled",
                              tile_args=TILE_ARGS)["image"]
    pert = perturbed(state, seed, device)
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


# phase 8: the repo's "full" tier (tools/_tiers.py): 16 frames at 256x192
TIER_H, TIER_W, TIER_FRAMES, TIER_GAUSSIANS = 192, 256, 16, 4000
# the JAX package's own bounds on a synthetic run (tests/test_hierarchy_e2e.py)
MAX_ROT_DEG = 3.0
MIN_PSNR = 18.0
HIER_PHASES = ("phase_a", "leaf", "merge", "nonleaf_phase1",
               "nonleaf_phase2", "eval")


def tier_configs(depth_dir: str):
    """The full tier's recipe and budgets (tools/_tiers.py, apply_tier
    "full"), except two cuts. The root's MSS budgets, which the tier leaves
    at the defaults (phase 1: 50 iterations per frame, phase 2: 300): at
    those phase 8 took 335.6 s on an H100 80GB HBM3 at 700 W (steps
    host-bound at 23-31 ms), so they are cut to 10 (the repo's medium and
    scale tiers' phase 1) and 25. And the steps per leaf frame, from 100
    to 50, for phase 11c (this recipe on a 2 x 2 mesh): with it the script
    took 691.6 s on the same card."""
    from ht3dgs_torch.utils.config import load_configs

    model, pipe, optim = load_configs()
    model.eval = False
    model.expname, model.category, model.seq_name = "smoke", "synt", "full"
    pipe.train_level = 1
    pipe.render_mode = "tiled"
    pipe.depth_provider = "precomputed"
    pipe.depth_dir = depth_dir
    pipe.train_pose_mode = None
    pipe.multi_source_supervision = "base+vfi"
    pipe.vfi_provider = "blend"
    pipe.init_max_points = 20_000
    pipe.phase_a_batch = 4
    pipe.tile_max_per_tile = 2048
    pipe.tile_dup_factor = 32
    optim.opacity_reset_interval_override = 100_000
    optim.pose_lr = 3e-3
    optim.single_step = 50
    optim.phase_a_fit_iters = 400
    optim.phase_a_pose_iters = 150
    optim.leaf_init_iters = 400
    optim.mss_phase1_iteration_per_frame = 10
    optim.num_iterations_per_frame_each_level = [25, 25, 25]
    return model, pipe, optim


# phase 8's depth: Phase A's fits 400 -> 100 and pose fits 150 -> 100
# iterations, the leaf init 400 -> 100 iterations and the steps per leaf
# frame 50 -> 12, so that phase 15 fits in the script's time
HIER_CUTS = dict(phase_a_fit_iters=100, phase_a_pose_iters=100,
                 leaf_init_iters=100, single_step=12)


def tier_trainer(device, seed: int, mesh=(1, 1), write_depth=True,
                 cuts=None):
    """The full tier's trainer on its synthetic scene, frames in memory,
    depths as .npy under depth/ of the working directory (written when
    write_depth), with a (segments, tiles) mesh and the budgets `cuts` set
    over tier_configs'. Returns (trainer, scene)."""
    from ht3dgs_torch.core.camera import intrinsics_from_fov
    from ht3dgs_torch.data.readers import FrameInfo, SceneInfo
    from ht3dgs_torch.train import hierarchy
    from ht3dgs_torch.utils import synthetic

    scene = synthetic.generate(n_frames=TIER_FRAMES, height=TIER_H,
                               width=TIER_W, n_gaussians=TIER_GAUSSIANS,
                               fovx=1.2, seed=seed, device=device)
    K = intrinsics_from_fov(1.2, TIER_H, TIER_W)
    frames = [FrameInfo(uid=i, image_path=None, image_name=f"{i:04d}",
                        width=TIER_W, height=TIER_H, intrinsics=K,
                        fovx=1.2, fovy=2 * float(np.arctan(
                            TIER_H / (2 * K[1, 1]))),
                        R=scene.poses_w2c[i][:3, :3],
                        T=scene.poses_w2c[i][:3, 3], _image=scene.frames[i])
              for i in range(TIER_FRAMES)]
    info = SceneInfo(train_frames=frames, test_frames=[],
                     i_train=np.arange(TIER_FRAMES),
                     i_test=np.array([], np.int64), nerf_radius=1.0)

    class InMemoryTrainer(hierarchy.HTGaussianTrainer):
        def setup_dataset(self):
            self.set_scene(info)

    if write_depth:
        os.makedirs("depth", exist_ok=True)
        for i, d in enumerate(scene.depths):
            np.save(os.path.join("depth", f"{i:04d}.npy"), d)
    model, pipe, optim = tier_configs(os.path.abspath("depth"))
    pipe.mesh_segments, pipe.mesh_tiles = mesh
    for k, v in (cuts or {}).items():
        setattr(optim, k, v)
    tr = InMemoryTrainer("", model, pipe, optim, seed=seed, device=device)
    tr.result_path = os.path.abspath(tr.result_path)
    return tr, scene


def rotation_errors(tr, scene) -> list:
    """Degrees between each relative pose and the truth."""
    from ht3dgs_torch import real_image_bench

    for f in range(1, TIER_FRAMES):
        check(np.all(np.isfinite(tr.pose_dict[f"rel_pose_{f - 1}_to_{f}"])),
              f"rel_pose_{f - 1}_to_{f} finite")
    return real_image_bench.rotation_errors(tr.pose_dict, scene.poses_w2c)


def phase_hierarchy(B, device, seed: int, workdir: str):
    """Phase 8: HTGaussianTrainer.hierarchical_training on the full tier's
    synthetic scene, frames and depths in memory, writing under `workdir`.
    Returns the launches of each kernel in the phase and, for phase 9, the
    trainer, the root, the scene, its pose metrics and train-view PSNR."""
    import torch

    from ht3dgs_torch.eval import pose_eval
    from ht3dgs_torch.utils.profiling import StepCounter, root_step_figures

    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(workdir)   # the trainer writes output/ under the working dir
    try:
        tr, scene = tier_trainer(device, seed, cuts=HIER_CUTS)
        print(f"phase 8: scene {TIER_FRAMES} frames {TIER_W}x{TIER_H}, "
              f"{TIER_GAUSSIANS} Gaussians, {time.perf_counter() - t0:.1f} s")
        counter = StepCounter(tr.timer)
        originals = counter.wrap_steps()
        try:
            B.blend_fwd.launches = 0
            B.blend_bwd.launches = 0
            t0 = time.perf_counter()
            bundle = tr.hierarchical_training()
            wall = time.perf_counter() - t0
            launches = counter._counts()
        finally:
            for m, n, fn in originals:
                setattr(m, n, fn)
        psnr = tr.evaluate_on_training_images(save_images=False)
        reloaded = tr.load_checkpoint(
            os.path.join(tr.result_path, "chkpnt", "model.npz"))
        same = torch.equal(tr.render_frame(bundle, 0)[1]["image"],
                           tr.render_frame(reloaded, 0)[1]["image"])
    finally:
        os.chdir(cwd)

    summary = tr.timer.summary()
    print(f"phase 8: hierarchical_training {wall:.1f} s; capacity growths "
          f"{tr.n_capacity_grows}; root: {int(bundle.state.n_live())} live "
          f"Gaussians of {bundle.state.capacity}; tile args {tr._tile_args}")
    for name in HIER_PHASES:
        ph, n = summary.get(name, {}), counter.steps[name]
        total = ph.get("total_s", 0.0)
        per = f"{1e3 * total / n:.2f} ms per step" if n else "no steps"
        print(f"phase 8 [{name}]: {total:.3f} s x{ph.get('count', 0)}, "
              f"{n} steps ({counter.model_steps[name]} model-steps), {per}, "
              f"launches {dict(counter.launches[name])}")
    rot_err = rotation_errors(tr, scene)
    ev = pose_eval.evaluate_poses(scene.poses_w2c,
                                  bundle.poses[:TIER_FRAMES])
    print(f"phase 8: relative-pose rotation error, degrees: max "
          f"{max(rot_err):.4f}, mean {np.mean(rot_err):.4f}; ATE "
          f"{ev['ATE']:.5f}, RPE_trans x100 {ev['RPE_trans_x100']:.4f}, "
          f"RPE_rot {ev['RPE_rot_deg']:.4f} deg; train-view mean PSNR "
          f"{psnr:.3f} dB; checkpoint reload renders frame 0 equal: {same}")
    check(bundle.to_visit_frames == list(range(TIER_FRAMES)),
          "the root covers every frame")
    check(max(rot_err) < MAX_ROT_DEG,
          f"relative-pose rotation error < {MAX_ROT_DEG} deg")
    check(psnr > MIN_PSNR, f"train-view mean PSNR > {MIN_PSNR} dB")
    check(same, "model.npz reloads and renders frame 0 bit for bit")
    for name in HIER_PHASES:
        n = counter.steps[name]
        for k in ("blend_fwd", "blend_bwd"):
            check(counter.launches[name][k] >= n,
                  f"phase 8 [{name}]: {k} launched once per step")
    # Phase A runs batched steps alone: one K1 and one K2 each
    n_a = counter.steps["phase_a"]
    check(counter.model_steps["phase_a"] > n_a > 0,
          "phase 8 [phase_a]: batched steps of several models")
    check(counter.launches["phase_a"]["blend_bwd"] == n_a,
          "phase 8 [phase_a]: K2 launched once per batched step")
    check(sum(counter.steps.values()) > 0 and all(launches.values()),
          "phase 8 ran steps and both kernels")

    # host share of a step at this size: the root's step, timed alone at
    # the training's tile arguments and at the eval sweep's
    root_step_figures(tr, bundle, counter, f"phase 8 ({TIER_W}x{TIER_H})")
    return launches, (tr, bundle, scene, ev, psnr)


# phase 9: the eval modes, the viewer and PLY on phase 8's root
NOVEL = 120
# test-time pose steps per frame, cut from the default 200 to keep the
# script with phase 11 inside its time
EVAL_NVS_EPOCHS = 50
VIEWER_SIZES = ((TIER_W, TIER_H), (1920, 1080))
VIEWER_REQUESTS = 4
# phase 10: the networks against the CPU, with seeded random weights
IFRNET_TOL = 1e-4
LPIPS_RTOL = 1e-5
NET_H, NET_W = 1080, 1920


def launch_counts(B) -> dict:
    return {"blend_fwd": B.blend_fwd.launches,
            "blend_bwd": B.blend_bwd.launches}


def run_counted(B, fn):
    """(fn(), wall seconds, kernel launches) of one step of a path."""
    import torch

    torch.cuda.synchronize()
    k0 = launch_counts(B)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k: v - k0[k] for k, v in launch_counts(B).items()}


@contextlib.contextmanager
def wrapped(module, name: str, make):
    """module.name replaced by make(original) inside the block."""
    fn = getattr(module, name)
    setattr(module, name, make(fn))
    try:
        yield
    finally:
        setattr(module, name, fn)


def png_pixels(path: str) -> np.ndarray:
    """[H, W, 3] uint8 of a PNG that utils.image.write_png wrote (8-bit
    RGB, filter 0 on every row)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: PNG signature")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    check(not rows[:, 0].any(), f"{path}: filter 0 rows")
    return rows[:, 1:].reshape(h, w, 3)


def free_port() -> int:
    import socket

    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def viewer_requests(port: int, views, fovx: float, fovy: float):
    """Send each (width, height, w2c) SIBR request on one connection;
    returns [(width, height, w2c, payload bytes, ms)]."""
    import socket
    import struct

    from ht3dgs_torch.cli.viewer import _read_exact

    cli = None
    for _ in range(300):
        try:
            cli = socket.create_connection(("127.0.0.1", port), timeout=5)
            break
        except OSError:
            time.sleep(0.1)
    check(cli is not None, "the viewer bridge accepts a connection")
    cli.settimeout(300)
    out = []
    try:
        for w, h, view in views:
            msg = json.dumps({"resolution_x": w, "resolution_y": h,
                              "fov_x": fovx, "fov_y": fovy, "z_near": 0.01,
                              "z_far": 100.0}).encode()
            mat = np.asarray(view, "<f4").T.tobytes()
            t0 = time.perf_counter()
            cli.sendall(struct.pack("<I", len(msg)) + msg + mat + mat)
            (plen,) = struct.unpack("<I", _read_exact(cli, 4))
            payload = _read_exact(cli, plen)
            out.append((w, h, view, payload,
                        (time.perf_counter() - t0) * 1e3))
    finally:
        cli.close()
    return out


def phase_eval(B, device, ctx):
    """Phase 9 on phase 8's trainer and root: eval_pose, eval_nvs,
    render_nvs, the viewer bridge and a PLY round trip. Returns the
    launches of each kernel on the path."""
    import threading

    import torch

    from ht3dgs_torch.cli import viewer
    from ht3dgs_torch.core import se3
    from ht3dgs_torch.core.camera import intrinsics_from_fov, make_camera
    from ht3dgs_torch.data import ply
    from ht3dgs_torch.train import phase_a
    from ht3dgs_torch.train import step as step_lib
    from ht3dgs_torch.utils.profiling import host_share

    tr, bundle, scene, ev8, psnr8 = ctx
    ckpt = os.path.join(tr.result_path, "chkpnt", "model.npz")

    def report(what, wall, k, n=None, unit="steps"):
        per = f", {n} {unit}, {1e3 * wall / n:.3f} ms each" if n else ""
        print(f"phase 9 [{what}]: {wall:.3f} s{per}, launches {k}")

    B.blend_fwd.launches = 0
    B.blend_bwd.launches = 0

    res, wall, k = run_counted(B, tr.eval_pose)
    report("eval_pose", wall, k)
    print(f"phase 9: eval_pose ATE {res['ATE']:.6f}, RPE_trans x100 "
          f"{res['RPE_trans_x100']:.6f}, RPE_rot {res['RPE_rot_deg']:.6f} "
          f"deg (phase 8: {ev8['ATE']:.6f}, {ev8['RPE_trans_x100']:.6f}, "
          f"{ev8['RPE_rot_deg']:.6f})")
    for key in ("ATE", "RPE_trans_x100", "RPE_rot_deg"):
        check(abs(res[key] - ev8[key]) <= 1e-6,
              f"eval_pose {key} equals phase 8's to 1e-6")

    n_pose = [0, 0]    # batched pose steps, model-steps in them

    def counting(fn):
        def step(*a, **kw):
            n_pose[0] += 1
            n_pose[1] += a[1].shape[0]
            return fn(*a, **kw)
        return step

    tr.sched.eval_nvs_epochs = EVAL_NVS_EPOCHS
    with wrapped(phase_a, "pose_step", counting):
        res, wall, k = run_counted(B, tr.eval_nvs)
    epochs = tr.sched.eval_nvs_epochs
    report("eval_nvs", wall, k, n_pose[0], "batched pose steps")
    for f, p, s_, l_ in res["rows"]:
        print(f"phase 9: eval_nvs frame {f}: PSNR {p:.3f} SSIM {s_:.4f} "
              f"LPIPS {l_:.3f}")
    print(f"phase 9: eval_nvs mean PSNR {res['psnr']:.3f} dB "
          f"({res['psnr'] - psnr8:+.3f} vs phase 8's train-view "
          f"{psnr8:.3f}), SSIM {res['ssim']:.4f}, LPIPS {res['lpips']:.3f} "
          f"(NaN without weights); {epochs} epochs, batch "
          f"{tr.pipe_cfg.eval_nvs_batch}: {n_pose[0]} batched steps of "
          f"{n_pose[1]} model-steps")
    n_batches = -(-TIER_FRAMES // tr.pipe_cfg.eval_nvs_batch)
    check(n_pose == [n_batches * epochs, TIER_FRAMES * epochs],
          f"eval_nvs ran {n_batches} x {epochs} batched steps of "
          f"{TIER_FRAMES} x {epochs} pose steps")
    check(res["psnr"] > MIN_PSNR, f"eval_nvs mean PSNR > {MIN_PSNR} dB")
    check(k["blend_fwd"] >= n_pose[0] and k["blend_bwd"] == n_pose[0],
          "eval_nvs: K1 and K2 launched once per batched pose step")
    poses_nvs = res["poses"]

    images = []

    def recording(fn):
        def render_eval(*a, **kw):
            out = fn(*a, **kw)
            images.append(out["image"])
            return out
        return render_eval

    with wrapped(step_lib, "render_eval", recording):
        mp4, wall, k = run_counted(B, tr.render_nvs)
    report("render_nvs", wall, k, NOVEL, "frames")
    img_dir = os.path.join(tr.result_path, "nvs", "bspline", "img_out")
    names = sorted(os.listdir(img_dir))
    print(f"phase 9: render_nvs wrote {len(names)} PNGs; returned {mp4}")
    check(names == [f"{i:04d}.png" for i in range(NOVEL)],
          f"render_nvs wrote {NOVEL} PNGs")
    check(k["blend_fwd"] >= NOVEL, f"render_nvs: K1 launched {NOVEL} times")
    for name, img in zip(names, images[-NOVEL:]):
        check(bool(torch.isfinite(img).all()), f"novel frame {name} finite")
        want = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        got = png_pixels(os.path.join(img_dir, name))
        check(np.array_equal(got, want), f"{name} holds the render")
        check(int(got.max()) > int(got.min()), f"{name} not constant")

    port = free_port()
    threading.Thread(target=viewer.serve, args=(ckpt, "127.0.0.1", port),
                     kwargs={"device": device}, daemon=True).start()
    fovx, fovy = 1.2, tr.data[0].fovy
    step = TIER_FRAMES // VIEWER_REQUESTS
    views = [(w, h, bundle.get_RT(i * step)) for w, h in VIEWER_SIZES
             for i in range(VIEWER_REQUESTS)]
    replies, wall, k = run_counted(
        B, lambda: viewer_requests(port, views, fovx, fovy))
    report("viewer", wall, k, len(replies), "requests")
    for w, h in VIEWER_SIZES:
        ms = [r[4] for r in replies if r[:2] == (w, h)]
        print(f"phase 9: viewer {w}x{h}: median {statistics.median(ms):.2f} "
              f"ms per request ({', '.join(f'{x:.2f}' for x in ms)})")
    check(k["blend_fwd"] >= len(views), "viewer: K1 launched per request")

    st = tr.gs_bundle.state   # the checkpoint's, loaded by render_nvs
    path = os.path.join(tr.result_path, "model.ply")

    def ply_round_trip():
        ply.save_ply(st, path)
        st_ply = ply.load_ply(path, max_sh_degree=st.max_sh_degree,
                              capacity=st.capacity, device=device)
        # a PLY keeps no active SH degree: load_ply activates every degree
        full = dataclasses.replace(st, active_sh_degree=st_ply.active_sh_degree)
        cam = tr.camera_for(0, pose=bundle.get_RT(0))
        return st_ply, [step_lib.render_eval(x, cam, mode=tr._mode,
                                             tile_args=tr._tile_args)["image"]
                        for x in (full, st_ply)]

    (st_ply, (a, b)), wall, k = run_counted(B, ply_round_trip)
    report("ply", wall, k)
    print(f"phase 9: PLY {os.path.getsize(path) / 1e6:.2f} MB, "
          f"{int(st_ply.n_live())} Gaussians (checkpoint: "
          f"{int(st.n_live())}, active SH degree "
          f"{int(st.active_sh_degree)} -> {int(st_ply.active_sh_degree)}); "
          f"frame 0 renders equal: {torch.equal(a, b)}")
    check(int(st_ply.n_live()) == int(st.n_live()), "PLY keeps every live row")
    check(torch.equal(a, b), "the PLY state renders frame 0 bit for bit")
    launches = launch_counts(B)

    # outside the counted path: the viewer's answers against render_eval
    # of the same cameras, and the host share of one test-time pose step
    state_v = viewer.load_state(ckpt, device)
    for w, h, view, payload, _ in replies:
        cam = make_camera(h, w, intrinsics_from_fov(fovx, h, w, fovy=fovy),
                          world_view=view, device=device)
        out = step_lib.render_eval(state_v, cam, mode="auto")
        want = (np.clip(out["image"].cpu().numpy(), 0, 1) * 255
                ).astype(np.uint8)
        print(f"phase 9: viewer {w}x{h}: payload {len(payload)} bytes, "
              f"dropped m={int(out.get('n_dropped_m', 0))} "
              f"tile={int(out.get('n_dropped_tile', 0))}")
        check(len(payload) == h * w * 3, f"viewer {w}x{h}: H*W*3 bytes")
        check(payload == want.tobytes(),
              f"viewer {w}x{h}: payload equals render_eval's bytes")

    # eval_nvs's step: one model under a chunk of test-time poses
    nb = min(tr.pipe_cfg.eval_nvs_batch, TIER_FRAMES)
    bases = se3.se3_from_matrix(torch.as_tensor(poses_nvs[:nb],
                                                device=device))
    gts = torch.stack([tr.device_frame("rgb", f) for f in range(nb)])
    cams = phase_a.stack_cameras([tr.camera_for(f) for f in range(nb)])
    opt = phase_a.init_pose_opts(nb, device)
    deltas = torch.zeros(nb, 6, device=device)
    step_ms, busy_ms = host_share(lambda: phase_a.pose_step(
        st, deltas, bases, opt, cams, gts, tr.sched.rotation_lr,
        shared_state=True, mode=tr._mode, tile_args=tr._tile_args,
        lambda_dssim=tr.sched.lambda_dssim))
    print(f"phase 9: test-time batched pose step ({nb} poses) at "
          f"{TIER_W}x{TIER_H}: median {step_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / step_ms:.1f}%), host share "
          f"{100 * (1 - busy_ms / step_ms):.1f}%")
    return launches


def random_vgg_weights(seed: int) -> dict:
    """LPIPS npz arrays (conv{i}_w/_b, lin{i}) with He-scaled random VGG16
    weights, from numpy."""
    from ht3dgs_torch.eval.metrics import _VGG_CFG

    rng = np.random.default_rng(seed)
    w, cin, ci = {}, 3, 0
    for v in _VGG_CFG:
        if v == "M":
            continue
        w[f"conv{ci}_w"] = (rng.standard_normal((v, cin, 3, 3))
                            * np.sqrt(2.0 / (cin * 9))).astype(np.float32)
        w[f"conv{ci}_b"] = (0.01 * rng.standard_normal(v)).astype(np.float32)
        cin, ci = v, ci + 1
    for i, c in enumerate([64, 128, 256, 512, 512]):
        w[f"lin{i}"] = (rng.random((1, c, 1, 1)) * 0.1).astype(np.float32)
    return w


def event_ms(fn, runs: int = 5):
    """Median device time of fn() over `runs` calls, each timed alone by
    CUDA events, after one warm-up call; and the peak memory of a call."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), torch.cuda.max_memory_allocated()


def kernel_launches(fn) -> int:
    """CUDA kernels that one call of fn() launches (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def phase_networks(device, seed: int, frames) -> None:
    """Phase 10: IFRNet and LPIPS with seeded random weights on the card
    (cuDNN TF32 off) against the CPU on a 256x192 pair, then timed at
    1920x1080."""
    import tempfile

    import torch

    from ht3dgs_torch.data import ifrnet
    from ht3dgs_torch.eval import metrics
    from ht3dgs_torch.train.losses import full_precision_convs

    img0, img1 = frames[0], frames[1]
    params = ifrnet.random_params(seed)
    nets = {d: ifrnet.from_params(params, d) for d in (device, "cpu")}
    mids = {d: ifrnet.interpolate(n, img0, img1) for d, n in nets.items()}
    err = float(np.abs(mids[device] - mids["cpu"]).max())
    print(f"phase 10: IFRNet {TIER_W}x{TIER_H} card vs CPU max|d| "
          f"{err:.3e} (limit {IFRNET_TOL:g}); midway frame range "
          f"[{mids['cpu'].min():.3f}, {mids['cpu'].max():.3f}]")
    check(err <= IFRNET_TOL, f"IFRNet card vs CPU {IFRNET_TOL:g}")

    rng = np.random.default_rng(seed + 10)
    big = [ifrnet.pad16(rng.random((NET_H, NET_W, 3), dtype=np.float32),
                        device) for _ in range(2)]
    net = nets[device]

    def on_cudnn():
        # the same network on cuDNN's float32 convolutions, for comparison
        with torch.no_grad(), full_precision_convs():
            return net._interpolate(*big, 0.5)

    for what, fn in (("PyTorch's convolutions (the module's)",
                      lambda: net(*big)),
                     ("cuDNN's float32 convolutions", on_cudnn)):
        ms, mem = event_ms(fn)
        print(f"phase 10: IFRNet {NET_W}x{NET_H} (padded to "
              f"{big[0].shape[3]}x{big[0].shape[2]}) on {what}: median "
              f"{ms:.3f} ms per pair over 5, peak memory "
              f"{mem / 2**30:.3f} GiB, {kernel_launches(fn)} kernel "
              f"launches per pair")
    del nets, net, big

    old = os.environ.get("HT3DGS_LPIPS_WEIGHTS")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lpips_vgg.npz")
        np.savez(path, **random_vgg_weights(seed))
        os.environ["HT3DGS_LPIPS_WEIGHTS"] = path
        try:
            vals = {d: metrics.lpips(img0, img1, device=d)
                    for d in (device, "cpu")}
            rel = abs(vals[device] - vals["cpu"]) / abs(vals["cpu"])
            print(f"phase 10: LPIPS {TIER_W}x{TIER_H} card "
                  f"{vals[device]:.9f} CPU {vals['cpu']:.9f}, relative "
                  f"{rel:.3e} (limit {LPIPS_RTOL:g})")
            check(rel <= LPIPS_RTOL, f"LPIPS card vs CPU relative "
                  f"{LPIPS_RTOL:g}")
            net = metrics.lpips_module(device)
            big = [torch.as_tensor(rng.random((1, 3, NET_H, NET_W),
                                              dtype=np.float32),
                                   device=device) for _ in range(2)]
            ms, mem = event_ms(lambda: net(*big))
            print(f"phase 10: LPIPS {NET_W}x{NET_H}: median {ms:.3f} ms per "
                  f"call over 5, peak memory {mem / 2**30:.3f} GiB, "
                  f"{kernel_launches(lambda: net(*big))} kernel launches "
                  f"per call")
        finally:
            if old is None:
                os.environ.pop("HT3DGS_LPIPS_WEIGHTS")
            else:
                os.environ["HT3DGS_LPIPS_WEIGHTS"] = old
            metrics._cached.clear()


# phase 11: multi-device on the card. One card admits one NCCL rank (NCCL
# refuses two ranks on a device), so 11a runs NCCL at world size 1 and 11b/c
# run MESH_RANKS processes on the one card over gloo, which reduces CUDA
# tensors through the host.
MESH_RANKS = 4
COMPACT_FRAC = 2.0
# the sharded steps are held to the single-device step where neither drops
# an entry: dup_factor 32 keeps M above this scene's 26.2M entries, and
# max_per_tile is the next power of two above the longest tile list of the
# full image and of every row block (mesh_tile_args)
MESH_DUP = 32


class CommTimer:
    """Wall time and count of torch.distributed's all_reduce and broadcast
    in this process (each returns when its collective is done), by
    wrapping them; the port calls them through the module."""

    def __init__(self):
        import torch.distributed as dist

        self.s = {"all_reduce": 0.0, "broadcast": 0.0}
        self.n = {"all_reduce": 0, "broadcast": 0}
        for name in self.s:
            fn = getattr(dist, name)

            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.s[_name] += time.perf_counter() - t0
                    self.n[_name] += 1

            setattr(dist, name, timed)

    def snapshot(self):
        return dict(self.s), dict(self.n)


def round128(n: float) -> int:
    return -(-int(n) // 128) * 128


def tile_loads(state, cam, n_blocks: int):
    """(longest tile list, most rows with entries in one block) of the full
    image and of its n_blocks row blocks, from the binning's tile
    rectangles (a 2-D difference array per image)."""
    import torch

    from ht3dgs_torch.parallel import mesh as mesh_lib
    from ht3dgs_torch.raster.projection import project

    longest, rows = 0, 0
    bh = cam.height // n_blocks
    views = [(cam, False)] + [(mesh_lib._row_block_camera(cam, t * bh, bh),
                               True) for t in range(n_blocks)]
    for c, block in views:
        with torch.no_grad():
            p = project(state.means, state.log_scales, state.quats,
                        state.opacity_logit, state.sh_dc, state.sh_rest,
                        state.live, c, state.active_sh_degree,
                        state.max_sh_degree)
        ntx, nty = -(-c.width // 16), -(-c.height // 16)
        mx, my = p.means2d[:, 0], p.means2d[:, 1]
        ex, ey = p.extents[:, 0], p.extents[:, 1]
        x0 = torch.floor((mx - ex) / 16).clamp(0, ntx).long()
        x1 = torch.floor((mx + ex + 15) / 16).clamp(0, ntx).long()
        y0 = torch.floor((my - ey) / 16).clamp(0, nty).long()
        y1 = torch.floor((my + ey + 15) / 16).clamp(0, nty).long()
        on = p.valid & (x1 > x0) & (y1 > y0)
        x0, x1, y0, y1 = (v[on] for v in (x0, x1, y0, y1))
        d = torch.zeros((nty + 1) * (ntx + 1), dtype=torch.int64,
                        device=state.device)
        for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                             (y1, x1, 1)):
            d.index_add_(0, yy * (ntx + 1) + xx,
                         torch.full_like(yy, sign))
        counts = d.reshape(nty + 1, ntx + 1).cumsum(0).cumsum(1)
        longest = max(longest, int(counts.max()))
        if block:
            rows = max(rows, int(on.sum()))
    return longest, rows


def mesh_tile_args(longest: int) -> dict:
    K = 128
    while K < longest:
        K *= 2
    return dict(tile_h=16, tile_w=16, max_per_tile=K, dup_factor=MESH_DUP)


def compare_step(got, ref, what: str, params: bool = True,
                 phase: str = "11") -> dict:
    """A sharded step's (state, opt, metrics) against the single-device
    step's: loss 1e-5 relative; gradients (the first Adam moments after
    one step from zero, 0.1 x the gradient) 1e-4 of their max; new
    parameters where both gradients are above 1e-6 of the max, 1e-5
    relative; grad_accum and max_radii2d 1e-4 of their max; counters
    equal. Returns the errors."""
    import torch

    from ht3dgs_torch.core.gaussians import PARAM_FIELDS

    (gs, go, gm), (rs, ro, rm) = got, ref
    errs = {"loss": abs(float(gm["loss"]) - float(rm["loss"]))
            / abs(float(rm["loss"]))}
    check(errs["loss"] <= 1e-5, f"{what}: loss 1e-5 relative")
    for f in PARAM_FIELDS:
        scale = float(ro.m[f].abs().max())
        if scale == 0.0:
            check(float(go.m[f].abs().max()) == 0.0, f"{what}: m[{f}] zero")
            continue
        e = float((go.m[f] - ro.m[f]).abs().max()) / scale
        errs[f"grad {f}"] = e
        check(e <= 1e-4, f"{what}: gradient of {f} 1e-4 of its max")
        if params:
            both = (go.m[f].abs() > 1e-6 * scale) & (
                ro.m[f].abs() > 1e-6 * scale)
            d = (getattr(gs, f) - getattr(rs, f)).abs() / getattr(
                rs, f).abs().clamp(min=1.0)
            e = float(torch.where(both, d, 0.0).max())
            errs[f"param {f}"] = e
            check(e <= 1e-5, f"{what}: new {f} 1e-5 where both gradients "
                  "are above 1e-6 of the max")
    for f in ("grad_accum", "max_radii2d"):
        a, b = getattr(gs, f), getattr(rs, f)
        e = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        errs[f] = e
        check(e <= 1e-4, f"{what}: {f} 1e-4 of its max")
    for k in ("n_dropped", "n_dropped_m", "n_dropped_tile"):
        if k in gm:
            check(int(gm[k]) == int(rm[k]), f"{what}: {k} equal "
                  f"({int(gm[k])} vs {int(rm[k])})")
    print(f"phase {phase}: {what} vs gaussian_train_step: loss "
          f"{float(gm['loss']):.8f} vs {float(rm['loss']):.8f}; relative "
          "errors " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return errs


def phase_nccl(B, state, cam, target, device):
    """11a: build_hierarchy_step on a (1, 1) mesh of one NCCL rank against
    gaussian_train_step, on the trained-stats scene at TILE_ARGS. Returns
    the kernel launches of the sharded step."""
    import torch

    from ht3dgs_torch.core import adam
    from ht3dgs_torch.parallel import mesh as mesh_lib
    from ht3dgs_torch.train import step as step_lib

    mesh_lib.init_distributed(
        backend="nccl", init_method=f"tcp://localhost:{free_port()}",
        world=1, rank_=0, device=device, timeout=300)
    try:
        import torch.distributed as dist

        section = mesh_lib._GROUPS[mesh_lib._SECTION]
        print(f"phase 11a: process group {dist.get_backend()}, world "
              f"{dist.get_world_size()}; section group "
              f"{dist.get_backend(section)}, world "
              f"{dist.get_world_size(section)}")
        step = mesh_lib.build_hierarchy_step(
            mesh_lib.make_mesh(1, 1), H, W, mode="tiled",
            tile_args=TILE_ARGS)
        torch.cuda.synchronize()
        k0 = launch_counts(B)
        t0 = time.perf_counter()
        got = step(state, adam.init(state.params()), cam, target, LRS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        k = {n: v - k0[n] for n, v in launch_counts(B).items()}
    finally:
        mesh_lib.shutdown()
    ref = step_lib.gaussian_train_step(
        state, adam.init(state.params()), cam, target, LRS, mode="tiled",
        tile_args=TILE_ARGS)
    compare_step(got, ref, "11a (1, 1) NCCL hierarchy step")
    print(f"phase 11a: one step {ms:.1f} ms, launches {k}")
    check(all(v >= 1 for v in k.values()), "11a: K1 and K2 launched")
    return k


def mesh_steps_rank(rank: int, seed: int, targs: dict, compact_n: int):
    """11b on one of MESH_RANKS gloo ranks sharing the card: the hierarchy
    step on a (1, 4) mesh without and with compact_n, and the Gaussian-
    sharded step; rank 0 gathers each result and holds it to
    gaussian_train_step on the same inputs."""
    import torch

    from ht3dgs_torch.core import adam
    from ht3dgs_torch.core.camera import intrinsics_from_fov, make_camera
    from ht3dgs_torch.core.gaussians import PARAM_FIELDS
    from ht3dgs_torch.parallel import comm, gauss_shard
    from ht3dgs_torch.parallel import mesh as mesh_lib
    from ht3dgs_torch.raster import blend as B
    from ht3dgs_torch.train import step as step_lib

    device = mesh_lib.rank_device("cuda")
    timer = CommTimer()
    state = make_scene(seed, device)
    cam = make_camera(H, W, intrinsics_from_fov(1.2, H, W), device=device)
    target = step_lib.render_eval(state, cam, mode="tiled",
                                  tile_args=TILE_ARGS)["image"]
    state = mesh_scene(state, seed, device)
    mesh = mesh_lib.make_mesh(1, MESH_RANKS)
    axis = mesh.tile_axis
    cases = [("hierarchy", targs, None),
             ("hierarchy compact_n", dict(targs, compact_n=compact_n), None),
             ("gauss-sharded", dict(targs, compact_n=compact_n), "gauss")]
    out, kept = {}, {}
    for name, ta, kind in cases:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        B.blend_fwd.launches = B.blend_bwd.launches = 0
        c0 = timer.snapshot()
        t0 = time.perf_counter()
        if kind == "gauss":
            st = gauss_shard.shard_state(state, MESH_RANKS)[rank]
            step = gauss_shard.build_gauss_sharded_step(
                mesh, H, W, cull_cap=None, tile_args=ta)
        else:
            st = state
            step = mesh_lib.build_hierarchy_step(mesh, H, W, mode="tiled",
                                                 tile_args=ta)
        res = step(st, adam.init(st.params()), cam, target, LRS)
        torch.cuda.synchronize()
        c1 = timer.snapshot()
        out[name] = dict(
            ms=1e3 * (time.perf_counter() - t0),
            all_reduce_ms=1e3 * (c1[0]["all_reduce"] - c0[0]["all_reduce"]),
            all_reduces=c1[1]["all_reduce"] - c0[1]["all_reduce"],
            peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30,
            launches={"blend_fwd": B.blend_fwd.launches,
                      "blend_bwd": B.blend_bwd.launches},
            n_dropped_compact=int(res[2]["n_dropped_compact"]))
        if kind == "gauss":
            # rank 0 needs every shard's moments and statistics
            s1, o1, m1 = res
            with torch.no_grad():
                gath = {f: comm.gather_rows(o1.m[f], axis)
                        for f in PARAM_FIELDS}
                stats = {f: comm.gather_rows(getattr(s1, f), axis)
                         for f in ("grad_accum", "max_radii2d")}
            res = (dataclasses.replace(state, **stats),
                   adam.AdamState(m=gath, v=gath, step=o1.step), m1)
        if rank == 0:
            kept[name] = res
        del res, step
        torch.cuda.empty_cache()
    if rank != 0:
        return {"cases": out}
    ref = step_lib.gaussian_train_step(
        state, adam.init(state.params()), cam, target, LRS, mode="tiled",
        tile_args=targs)
    errs = {name: compare_step(kept[name], ref, f"11b {name}",
                               params=name != "gauss-sharded")
            for name in kept}
    return {"cases": out, "errors": errs,
            "ref_drops": {k: int(ref[2][k]) for k in (
                "n_dropped", "n_dropped_m", "n_dropped_tile")}}


def deterministic() -> None:
    """Deterministic algorithms in this process from here on: 11c holds a
    resumed run to the uninterrupted one bit for bit, and index_add_ on the
    card sums in no fixed order otherwise. cuBLAS reads its workspace
    setting at its first call, which may come before: the rank functions
    set it first."""
    import torch

    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False


# a cuBLAS workspace with which deterministic algorithms are allowed
CUBLAS_DETERMINISTIC = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def rank_dir(workdir: str, run: str, rank: int) -> str:
    """A working directory of this rank's own: the ranks share no files,
    as on hosts that share no disk."""
    d = os.path.join(workdir, run, f"r{rank}")
    os.makedirs(d, exist_ok=True)
    return d


class Stopped(Exception):
    pass


def tier_mesh_rank(rank: int, seed: int, workdir: str):
    """11c on one of MESH_RANKS gloo ranks sharing the card: run A, the
    full tier's hierarchical_training on a (2, 2) mesh, then the host share
    of a root step on a (1, 4) mesh; then run B, the same from A's Phase A
    poses (copied to rank 0's directory alone), ended where the root's
    chunk would start (rank 0 alone writes the crumbs)."""
    import torch

    from ht3dgs_torch.parallel import checks
    from ht3dgs_torch.parallel import mesh as mesh_lib
    from ht3dgs_torch.raster import blend as B
    from ht3dgs_torch.train import hierarchy, parallel_nonleaf
    from ht3dgs_torch.utils.profiling import StepCounter, host_share

    os.environ.update(CUBLAS_DETERMINISTIC)
    device = mesh_lib.rank_device("cuda")
    timer = CommTimer()
    os.chdir(rank_dir(workdir, "a", rank))
    tr, scene = tier_trainer(device, seed, mesh=(2, 2), cuts=FILES_CUTS)
    counter = StepCounter(tr.timer)
    sections = [0]

    def counted_share(fn):
        def share(*a, **kw):
            sections[0] += 1
            return fn(*a, **kw)
        return share

    def counted_builder(fn):
        def build(*a, **kw):
            step = fn(*a, **kw)

            def counted(*sa, **skw):
                counter.steps[counter.current] += 1
                return step(*sa, **skw)
            return counted
        return build

    def then_deterministic(fn):
        # Phase A's poses reach runs B and C through rank 0's file, so
        # only what follows Phase A has to repeat bit for bit
        def phase_a(self):
            fn(self)
            deterministic()
        return phase_a

    originals = counter.wrap_steps()
    patches = [(mesh_lib, "build_hierarchy_step", counted_builder),
               (hierarchy.HTGaussianTrainer, "_share_trainer_state",
                counted_share),
               (hierarchy.HTGaussianTrainer, "_phase_a", then_deterministic)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, make in patches:
        setattr(m, n, make(getattr(m, n)))
    try:
        B.blend_fwd.launches = B.blend_bwd.launches = 0
        t0 = time.perf_counter()
        bundle = tr.hierarchical_training()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(B)
    finally:
        for m, n, fn in originals + saved:
            setattr(m, n, fn)
    comm_s, comm_n = timer.snapshot()
    res = dict(
        wall=wall, launches=launches, summary=tr.timer.summary(),
        steps=dict(counter.steps),
        phase_launches={k: dict(v) for k, v in counter.launches.items()},
        digest=checks.state_digest(bundle.state), poses=bundle.poses,
        gen=tr.gen.get_state().numpy(),
        frames=bundle.to_visit_frames, sections=sections[0],
        comm_s=comm_s, comm_n=comm_n,
        capacity=(int(bundle.state.n_live()), bundle.state.capacity))
    if rank == 0:
        res["rot_err"] = rotation_errors(tr, scene)
        res["psnr"] = tr.evaluate_on_training_images(save_images=False)

    # one root step on a (1, 4) mesh, timed as phase 8's root step
    mesh = mesh_lib.make_mesh(1, MESH_RANKS)
    step = mesh_lib.build_hierarchy_step(mesh, TIER_H, TIER_W, mode="tiled",
                                         tile_args=tr._tile_args)
    cam = tr.camera_for(0, pose=bundle.get_RT(0))
    gt = tr.device_frame("rgb", 0)
    lrs = tr._lrs(1, bundle)
    calls = [0]

    def one_step():
        calls[0] += 1
        return step(bundle.state, bundle.opt, cam, gt, lrs)

    c0 = timer.snapshot()
    res["step_ms"], res["busy_ms"] = host_share(one_step)
    c1 = timer.snapshot()
    res["step_all_reduce_ms"] = 1e3 * (c1[0]["all_reduce"]
                                       - c0[0]["all_reduce"]) / calls[0]
    # the cost of the deterministic algorithms: the same step as users run
    torch.use_deterministic_algorithms(False)
    res["step_ms_nondet"], res["busy_ms_nondet"] = host_share(one_step)
    torch.use_deterministic_algorithms(True)

    # run B, in a second directory of this rank's own
    os.chdir(rank_dir(workdir, "b", rank))
    trb, _ = tier_trainer(device, seed, mesh=(2, 2), cuts=FILES_CUTS)
    if rank == 0:
        pose = os.path.join(trb.result_path, "pose")
        os.makedirs(pose)
        shutil.copy(os.path.join(tr.result_path, "pose", "pose_partial.npz"),
                    pose)

    def stop(*a, **kw):
        raise Stopped

    t0 = time.perf_counter()
    with wrapped(parallel_nonleaf, "train_nonleaf_segments_parallel",
                 lambda fn: stop):
        try:
            trb.hierarchical_training()
        except Stopped:
            pass
        else:
            raise RuntimeError("11c run B did not stop at the root")
    res["b_wall"] = time.perf_counter() - t0
    return res


def tier_resume_rank(rank: int, seed: int, workdir: str):
    """11c, run C on one of MESH_RANKS gloo ranks: run B resumed in this
    rank's directory of B, where only rank 0's holds crumbs and Phase A's
    poses. Returns the root's digest, poses and generator state, the
    resume files this rank found, the Phase A poses and the segments
    taken from rank 0, the phase table and the wall time."""
    import torch

    from ht3dgs_torch.parallel import checks
    from ht3dgs_torch.parallel import mesh as mesh_lib
    from ht3dgs_torch.train import hierarchy

    os.environ.update(CUBLAS_DETERMINISTIC)
    deterministic()
    device = mesh_lib.rank_device("cuda")
    os.chdir(rank_dir(workdir, "b", rank))
    tr, _ = tier_trainer(device, seed, mesh=(2, 2), write_depth=False,
                         cuts=FILES_CUTS)
    files = checks.resume_files(tr.result_path)
    taken, n_poses = set(), []

    def counted_load(fn):
        def load(self, tag):
            b = fn(self, tag)
            if b is not None:
                taken.add(tag)
            return b
        return load

    def counted_resume(fn):
        def resume(self):
            fn(self)
            n_poses.append(sum(k.startswith("rel_pose_")
                               for k in self.pose_dict))
        return resume

    t0 = time.perf_counter()
    with wrapped(hierarchy.HTGaussianTrainer, "_load_bundle_breadcrumb",
                 counted_load), \
            wrapped(hierarchy.HTGaussianTrainer, "_resume_poses",
                    counted_resume):
        bundle = tr.hierarchical_training()
    torch.cuda.synchronize()
    return dict(wall=time.perf_counter() - t0,
                digest=checks.state_digest(bundle.state),
                poses=bundle.poses, gen=tr.gen.get_state().numpy(),
                files=files, taken=sorted(taken), n_poses=n_poses[0],
                summary=tr.timer.summary())


def phase_mesh(B, device, seed: int, state, cam) -> dict:
    """11b and 11c: MESH_RANKS processes on the card over gloo. Returns the
    kernel launches of every rank together."""
    from ht3dgs_torch.parallel import mesh as mesh_lib

    longest, rows = tile_loads(state, cam, MESH_RANKS)
    targs = mesh_tile_args(longest)
    compact_n = min(N, round128(N * COMPACT_FRAC / MESH_RANKS))
    print(f"phase 11b: longest tile list {longest} (full image and "
          f"{MESH_RANKS} row blocks), at most {rows} rows with entries in "
          f"a block; tile args {targs}, compact_n {compact_n}")
    t0 = time.perf_counter()
    res = mesh_lib.spawn(mesh_steps_rank, MESH_RANKS, backend="gloo",
                         device="cuda", args=(seed, targs, compact_n),
                         timeout=600, threads=2)
    print(f"phase 11b: {MESH_RANKS} gloo ranks on the card, "
          f"{time.perf_counter() - t0:.1f} s; single-device step's drops "
          f"{res[0]['ref_drops']}")
    launches = {"blend_fwd": 0, "blend_bwd": 0}
    for r, rr in enumerate(res):
        for name, c in rr["cases"].items():
            print(f"phase 11b rank {r} [{name}]: {c['ms']:.1f} ms, "
                  f"{c['all_reduces']} all-reduces {c['all_reduce_ms']:.1f}"
                  f" ms, peak {c['peak_gib']:.3f} GiB, n_dropped_compact "
                  f"{c['n_dropped_compact']}, launches {c['launches']}")
            check(all(v >= 1 for v in c["launches"].values()),
                  f"11b rank {r} [{name}]: K1 and K2 launched")
            for k, v in c["launches"].items():
                launches[k] += v

    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        res = mesh_lib.spawn(tier_mesh_rank, MESH_RANKS, backend="gloo",
                             device="cuda", args=(seed, workdir),
                             timeout=900, threads=2)
        total = time.perf_counter() - t0
        # C under a process-group timeout of half the root's seconds in A:
        # ranks 2 and 3 wait out the root's chunk in one wait
        pg_timeout = res[0]["summary"]["nonleaf_parallel"]["total_s"] / 2
        t0 = time.perf_counter()
        resumed = mesh_lib.spawn(tier_resume_rank, MESH_RANKS,
                                 backend="gloo", device="cuda",
                                 args=(seed, workdir), timeout=600,
                                 pg_timeout=pg_timeout, threads=2)
        total_c = time.perf_counter() - t0
    r0 = res[0]
    print(f"phase 11c: hierarchical_training on a (2, 2) mesh of "
          f"{MESH_RANKS} gloo ranks: {r0['wall']:.1f} s (spawn and all "
          f"{total:.1f} s); root {r0['capacity'][0]} live Gaussians of "
          f"{r0['capacity'][1]}")
    for r, rr in enumerate(res):
        for name, ph in rr["summary"].items():
            n = rr["steps"].get(name, 0)
            per = (f"{1e3 * ph['total_s'] / n:.2f} ms per step" if n
                   else "no steps")
            print(f"phase 11c rank {r} [{name}]: {ph['total_s']:.3f} s "
                  f"x{ph['count']}, {n} steps, {per}, launches "
                  f"{rr['phase_launches'].get(name, {})}")
            for k in ("blend_fwd", "blend_bwd"):
                check(rr["phase_launches"].get(name, {}).get(k, 0) >= n,
                      f"11c rank {r} [{name}]: {k} launched once per step")
        n_steps = sum(rr["steps"].values())
        n_lock = sum(rr["steps"].get(k, 0)
                     for k in ("leaf_parallel", "nonleaf_parallel"))
        ar = rr["comm_s"]["all_reduce"]
        bc = rr["comm_s"]["broadcast"]
        print(f"phase 11c rank {r}: {n_steps} steps ({n_lock} lockstep); "
              f"all_reduce {rr['comm_n']['all_reduce']} calls {ar:.3f} s "
              f"({1e3 * ar / max(1, n_lock):.3f} ms per lockstep step); "
              "broadcast "
              f"{rr['comm_n']['broadcast']} calls {bc:.3f} s over "
              f"{rr['sections']} sections "
              f"({1e3 * bc / max(1, rr['sections']):.1f} ms per section); "
              f"root step on a (1, {MESH_RANKS}) mesh: "
              f"median {rr['step_ms']:.3f} ms, device busy "
              f"{rr['busy_ms']:.3f} ms, host share "
              f"{100 * (1 - rr['busy_ms'] / rr['step_ms']):.1f}%, "
              f"all-reduce {rr['step_all_reduce_ms']:.3f} ms per step; "
              f"without deterministic algorithms {rr['step_ms_nondet']:.3f}"
              f" ms, device busy {rr['busy_ms_nondet']:.3f} ms")
        for k, v in rr["launches"].items():
            launches[k] += v
    print(f"phase 11c: relative-pose rotation error, degrees: max "
          f"{max(r0['rot_err']):.4f}; train-view mean PSNR "
          f"{r0['psnr']:.3f} dB; root digests "
          f"{sorted({rr['digest'][:16] for rr in res})}")
    check(len({rr["digest"] for rr in res}) == 1,
          "11c: every rank holds the same root (SHA-256)")
    check(all(rr["frames"] == list(range(TIER_FRAMES)) for rr in res),
          "11c: the root covers every frame")
    check(max(r0["rot_err"]) < MAX_ROT_DEG,
          f"11c: relative-pose rotation error < {MAX_ROT_DEG} deg")
    check(r0["psnr"] > MIN_PSNR, f"11c: train-view mean PSNR > {MIN_PSNR}")
    check({"leaf_parallel", "nonleaf_parallel"} <= set(r0["summary"]),
          "11c: leaves and the root ran on the mesh")
    check_resume(res, resumed, pg_timeout, total_c)
    return launches


def check_resume(res, resumed, pg_timeout: float, total_c: float) -> None:
    """11c's resume (run C) against the uninterrupted run A, rank by
    rank."""
    c0 = resumed[0]
    ph = c0["summary"]
    section = ph["nonleaf_parallel"]["total_s"]
    alone = sum(ph[k]["total_s"] for k in ("merge", "eval") if k in ph)
    print(f"phase 11c resume: run B (A's poses, stopped at the root) "
          f"{res[0]['b_wall']:.1f} s; run C {c0['wall']:.1f} s (spawn and "
          f"all {total_c:.1f} s), {c0['n_poses']} Phase A poses and "
          f"{len(c0['taken'])} segments {c0['taken']} taken from rank 0; "
          f"resume files by rank "
          f"{[len(rc['files']) for rc in resumed]}")
    print(f"phase 11c short timeout: process-group timeout {pg_timeout:.3f}"
          f" s; ranks 2-3 waited out the root's chunk on a (1, 2) mesh, "
          f"{section:.3f} s, in one wait; rank 0 alone: merge and eval "
          f"{alone:.3f} s")
    check(any(f.startswith("chkpnt") for f in c0["files"])
          and "pose/pose_partial.npz" in c0["files"]
          and all(rc["files"] == [] for rc in resumed[1:]),
          "11c: resume files in rank 0's directory alone")
    check(c0["n_poses"] == TIER_FRAMES - 1
          and c0["taken"] == ["lv1_seg0", "lv1_seg1"]
          and "leaf_parallel" not in ph,
          "11c: run C took Phase A and the leaves from rank 0")
    check(section > pg_timeout,
          "11c: the root's chunk outlasted the process-group timeout")
    for r, (ra, rc) in enumerate(zip(res, resumed)):
        check(rc["digest"] == ra["digest"]
              and np.array_equal(rc["poses"], ra["poses"])
              and np.array_equal(rc["gen"], ra["gen"]),
              f"11c rank {r}: the resumed root equals the uninterrupted "
              "one (digest, poses, generator)")
    print(f"phase 11c resume: the resumed root equals the uninterrupted "
          f"one on all {len(resumed)} ranks (digest {c0['digest'][:16]}, "
          "poses, generator state)")


# phase 12: the batch axis at the operating point
BATCH = 4


@contextlib.contextmanager
def deterministic_block():
    """Deterministic algorithms inside the block only (index_add_ then sums
    in a fixed order). warn_only: cuBLAS's products run as they are, on
    the workspace this process already has."""
    import warnings

    import torch

    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def compare_pose(got, ref, what: str) -> None:
    """A batched pose step's model against pose_train_step: loss 1e-5
    relative; gradient (the first Adam moment after one step from zero)
    1e-4 of its max; new tangent 1e-5 where both gradients are above 1e-6
    of the max."""
    (gd, gm, gl), (rd, rm, rl) = got, ref
    e_loss = abs(gl - rl) / abs(rl)
    scale = float(rm.abs().max())
    e_grad = float((gm - rm).abs().max()) / scale
    both = (gm.abs() > 1e-6 * scale) & (rm.abs() > 1e-6 * scale)
    e_new = float(((gd - rd).abs() / rd.abs().clamp(min=1.0))[both].max())
    print(f"phase 12: {what} vs pose_train_step: loss {gl:.8f} vs "
          f"{rl:.8f}; relative errors loss {e_loss:.2e}, grad {e_grad:.2e}, "
          f"new tangent {e_new:.2e}")
    check(e_loss <= 1e-5, f"{what}: loss 1e-5 relative")
    check(e_grad <= 1e-4, f"{what}: gradient 1e-4 of its max")
    check(e_new <= 1e-5, f"{what}: new tangent 1e-5")


def phase_batch(B, state, cam, target, device, seed) -> dict:
    """Phase 12: BATCH perturbed copies of the trained-stats scene at one
    capacity. One batched Phase A step (phase_a.fit_step) against
    gaussian_train_step on each model, and one batched shared-state pose
    step (one model under BATCH poses, as eval_nvs) against
    pose_train_step on each pose, under deterministic algorithms; K1 and
    K2 once per batched step; the batched K1/K2 outputs against one launch
    per image's tiles; K1/K2 timed at the B*T-tile launch; the batched
    step against the BATCH single steps, its host share and peak memory.
    Returns the launches of the batched steps (the path)."""
    import torch

    from ht3dgs_torch.core import adam
    from ht3dgs_torch.core.se3 import se3_exp
    from ht3dgs_torch.raster.projection import project
    from ht3dgs_torch.raster.tiled import build_tile_lists
    from ht3dgs_torch.train import phase_a
    from ht3dgs_torch.train import step as step_lib
    from ht3dgs_torch.utils.profiling import host_share

    models = [perturbed(state, seed + b, device) for b in range(BATCH)]
    stacked = phase_a.stack_states(models)
    cams = phase_a.stack_cameras([cam] * BATCH)
    gts = target.expand(BATCH, *target.shape).contiguous()
    lrs = {k: torch.full((BATCH,), v, device=device) for k, v in LRS.items()}
    active = torch.ones(BATCH, dtype=torch.bool, device=device)
    opt0 = phase_a.stack_opts([adam.init(m.params()) for m in models])
    path = {"blend_fwd": 0, "blend_bwd": 0}

    def fit_step():
        return phase_a.fit_step(stacked, opt0, cams, gts, lrs, active,
                                mode="tiled", tile_args=TILE_ARGS,
                                lambda_dssim=0.2)

    def counted(fn):
        out, wall, k = run_counted(B, fn)
        for name in path:
            path[name] += k[name]
        check(k == {"blend_fwd": 1, "blend_bwd": 1},
              f"phase 12: K1 and K2 launched once per batched step ({k})")
        return out, wall

    # 12a: the batched fit step against gaussian_train_step per model
    with deterministic_block():
        (st, opt, m), _ = counted(fit_step)
        got = list(zip(phase_a.unstack_states(st),
                       [phase_a._index(opt, b) for b in range(BATCH)]))
        for b, model in enumerate(models):
            ref = step_lib.gaussian_train_step(
                model, adam.init(model.params()), cam, target, LRS,
                mode="tiled", tile_args=TILE_ARGS, track_stats=False)
            compare_step((*got[b], {"loss": m["loss"][b]}), ref,
                         f"batched fit step, model {b}", phase="12")
    del st, opt, got, ref

    # 12b: one model under BATCH poses against pose_train_step per pose
    g = torch.Generator(device=device).manual_seed(seed + 3)
    bases = se3_exp(0.03 * torch.randn(BATCH, 6, generator=g,
                                       device=device))
    pose_target = step_lib.render_eval(state, cam, mode="tiled",
                                       tile_args=POSE_TILE_ARGS)["image"]
    pose_gts = pose_target.expand(BATCH, *pose_target.shape).contiguous()
    deltas0 = torch.zeros(BATCH, 6, device=device)
    pose_opt0 = phase_a.init_pose_opts(BATCH, device)

    def pose_step():
        return phase_a.pose_step(state, deltas0, bases, pose_opt0, cams,
                                 pose_gts, POSE_LR, shared_state=True,
                                 mode="tiled", tile_args=POSE_TILE_ARGS,
                                 lambda_dssim=0.2)

    with deterministic_block():
        (d, popt, losses), _ = counted(pose_step)
        for b in range(BATCH):
            rd, ropt, rm = step_lib.pose_train_step(
                state, torch.zeros(6, device=device), bases[b],
                step_lib.init_pose_opt(device), cam, pose_target, POSE_LR,
                mode="tiled", tile_args=POSE_TILE_ARGS)
            compare_pose((d[b], popt.m["pose"][b], float(losses[b])),
                         (rd, ropt.m["pose"], float(rm["loss"])),
                         f"batched pose step, pose {b}")

    # 12c: the batched kernel launch against one launch per image
    with torch.no_grad():
        proj = project(stacked.means, stacked.log_scales, stacked.quats,
                       stacked.opacity_logit, stacked.sh_dc, stacked.sh_rest,
                       stacked.live, cams, stacked.active_sh_degree[0],
                       stacked.max_sh_degree)
        ent, meta, total, nd_m, nd_tile, _ = build_tile_lists(
            proj, cam.height, cam.width, **TILE_ARGS)
        del proj
        T, P = ent.shape[0] // BATCH, 256
        fwd = B.blend_fwd(ent, meta, 16, 16)
        g = torch.Generator(device=device).manual_seed(seed + 4)
        cts = [torch.randn(s, generator=g, device=device) / P
               for s in ((BATCH * T, P, 3), (BATCH * T, P), (BATCH * T, P))]
        bwd = B.blend_bwd(ent, meta, fwd[1], fwd[3], *cts, 16, 16)
        same = True
        for b in range(BATCH):
            r = slice(b * T, (b + 1) * T)
            f1 = B.blend_fwd(ent[r], meta[r], 16, 16)
            b1 = B.blend_bwd(ent[r], meta[r], f1[1], f1[3],
                             *(c[r] for c in cts), 16, 16)
            same &= all(torch.equal(x[r], y) for x, y in zip(fwd, f1))
            same &= torch.equal(bwd[r], b1)
        del fwd, bwd, cts
    print(f"phase 12: batched binning of {BATCH} models: {BATCH * T} tiles, "
          f"entries {total.tolist()}, dropped m {nd_m.tolist()} tile "
          f"{nd_tile.tolist()}")
    check(same, "phase 12: batched K1/K2 equal one launch per image's tiles "
          "bit for bit")
    # K1/K2 at the B*T-tile launch against their plain versions, timed
    rec_fwd, ncon, t_fin, _ = phase_fwd(B, ent, meta, P)
    rec_bwd = phase_bwd(B, ent, meta, t_fin, ncon, P, seed)
    del ent, meta, ncon, t_fin
    for r in (rec_fwd, rec_bwd):
        print(f"phase 12: {r['name']} at {BATCH * T} tiles: {r['ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.3f} ms")

    # 12d: times, in this order: batched, singles, singles, batched
    def singles():
        for model in models:
            step_lib.gaussian_train_step(
                model, adam.init(model.params()), cam, target, LRS,
                mode="tiled", tile_args=TILE_ARGS, track_stats=False)

    def wall_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    order = [("batched", fit_step), ("singles", singles),
             ("singles", singles), ("batched", fit_step)]
    ms = {}
    for name, fn in order:
        ms.setdefault(name, []).append(wall_ms(fn))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fit_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms, busy_ms = host_share(fit_step, reps=10, profiled=3)
    pose_ms, pose_busy = host_share(pose_step, reps=5, profiled=2)
    print(f"phase 12: batched fit step of {BATCH} models at {W}x{H}: median "
          f"{ms['batched']} ms against {BATCH} single steps "
          f"{ms['singles']} ms (batched, singles, singles, batched); "
          f"host share {100 * (1 - busy_ms / step_ms):.1f}% ({busy_ms:.3f} "
          f"of {step_ms:.3f} ms on the device); peak memory {peak:.3f} GiB")
    print(f"phase 12: batched pose step of {BATCH} poses: {pose_ms:.3f} ms, "
          f"device busy {pose_busy:.3f} ms, host share "
          f"{100 * (1 - pose_busy / pose_ms):.1f}%")
    return path


# phase 13: the normal entry point from files on disk
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_images")
DECODE_REPS = 10


def fixture_digest(a: np.ndarray) -> dict:
    """As tests/torch_images/generate.py records Pillow's arrays."""
    import hashlib

    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def host_ms(fn, reps: int = DECODE_REPS) -> float:
    """Median host milliseconds of fn() over reps calls, after one call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def yaml_value(v) -> str:
    """A config value as the YAML subset writes it (floats keep a dot, as
    YAML 1.1 needs for a float: 3e-3 would read as a string)."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        text = repr(v)
        if "e" in text and "." not in text:
            mant, exp = text.split("e")
            text = f"{mant}.0e{'' if exp[0] in '+-' else '+'}{exp}"
        return text
    if isinstance(v, list):
        return "[" + ", ".join(yaml_value(x) for x in v) + "]"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    return str(v)


def write_config(path: str, want, comment: str, what: str) -> None:
    """cfg.yml: the fields of `want` (model, pipe, optim) that differ from
    the defaults, as the YAML subset writes them. Loading it must give
    want's fields back."""
    from ht3dgs_torch.utils.config import load_configs

    lines = [comment]
    for section, cfg, default in zip(
            ("ModelParams", "PipelineParams", "OptimizationParams"), want,
            load_configs()):
        lines.append(f"{section}:")
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if v != getattr(default, f.name):
                lines.append(f"    {f.name}: {yaml_value(v)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    for got, ref in zip(load_configs(path), want):
        check(dataclasses.asdict(got) == dataclasses.asdict(ref),
              f"{what}: cfg.yml reads back as written "
              f"({dataclasses.asdict(got)} != {dataclasses.asdict(ref)})")


# Phases 13 and 11c train phase 8's tier at a smaller depth than phase 8
# (phase 14 drives the same entry point at the scale tier's depth, phase
# 15 the published configs), for the script's time: Phase A's fits 400 ->
# 60 and pose fits 150 -> 40 iterations, the leaf init 400 -> 60, steps
# per leaf frame 50 -> 8, and the root's MSS phase 1 and 2 from 10 and 25
# to 3 and 6 per frame (11c's short process-group timeout is half the
# root's seconds).
FILES_CUTS = dict(phase_a_fit_iters=60, phase_a_pose_iters=40,
                  leaf_init_iters=60, single_step=8,
                  mss_phase1_iteration_per_frame=3,
                  num_iterations_per_frame_each_level=[6, 6, 6])


def files_config(path: str, img_dir: str, depth_dir: str) -> None:
    """cfg.yml: phase 8's recipe and cuts (tier_configs) at phase 13's
    depth (FILES_CUTS), the frame folder for training and the same
    folder's transforms_train.json (true poses) for the eval modes."""
    want = tier_configs(depth_dir)
    want[0].seq_name = "files"
    want[0].FovX = 1.2
    want[0].data_path_train = want[0].data_path_eval = img_dir
    want[0].data_type_train, want[0].data_type_eval = "images_only", "blender"
    want[2].eval_nvs_epochs = EVAL_NVS_EPOCHS
    for k, v in FILES_CUTS.items():
        setattr(want[2], k, v)
    write_config(path, want, "# the full tier from files on disk "
                 "(chip_smoke.py phase 13)", "13")


def phase_files(B, device, seed: int, workdir: str) -> dict:
    """Phase 13: (a) the fixtures decoded here against Pillow's hashes,
    (b) host times of a 1080p JPEG and PNG decode and the 1.6K resize,
    (c) the full tier written as PNG files and trained by
    `run.main(["--mode", "train", "--config", cfg.yml])`, then eval_pose
    and eval_nvs in-process and eval_pose as `python -m ht3dgs_torch`.
    Returns the kernel launches of the in-process runs."""
    from ht3dgs_torch import run
    from ht3dgs_torch.data import imgcodec, readers
    from ht3dgs_torch.train import hierarchy
    from ht3dgs_torch.utils import synthetic
    from ht3dgs_torch.utils.image import write_png
    from ht3dgs_torch.utils.profiling import StepCounter

    # (a) the fixtures against Pillow's arrays
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for name, entry in sorted(manifest.items()):
        path = os.path.join(FIXTURES, name)
        check(fixture_digest(imgcodec.open_array(path))
              == entry["open_array"], f"13: {name} open_array as Pillow's")
        rgb = imgcodec.load_rgb8(path)
        check(fixture_digest(rgb) == entry["load_rgb8"],
              f"13: {name} load_rgb8 as Pillow's")
        if "lanczos_1600x900" in entry:
            check(fixture_digest(imgcodec.resize_lanczos_rgb8(rgb, 1600, 900))
                  == entry["lanczos_1600x900"],
                  f"13: {name} LANCZOS 1600x900 as Pillow's")

    # (b) host times at 1080p
    jpg = os.path.join(FIXTURES, "frame_1080p.jpg")
    frame = imgcodec.load_rgb8(jpg)
    png = os.path.join(workdir, "frame_1080p.png")
    write_png(png, frame)
    check(np.array_equal(imgcodec.load_rgb8(png), frame),
          "13: write_png -> load_rgb8 round trip at 1080p")
    ms = {"jpeg_1080p": host_ms(lambda: imgcodec.load_rgb8(jpg)),
          "png_1080p": host_ms(lambda: imgcodec.load_rgb8(png)),
          "lanczos_1080p_to_1600x900": host_ms(
              lambda: imgcodec.resize_lanczos_rgb8(frame, 1600, 900))}

    # (c) the tier from files
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        scene = synthetic.generate(n_frames=TIER_FRAMES, height=TIER_H,
                                   width=TIER_W, n_gaussians=TIER_GAUSSIANS,
                                   fovx=1.2, seed=seed, device=device)
        img_dir = synthetic.write_images_only(
            scene, os.path.abspath("images"),
            depth_dir=os.path.abspath("depth"))
        frames = []
        for i, w2c in enumerate(scene.poses_w2c):
            c2w = np.linalg.inv(w2c)
            c2w[:3, 1:3] *= -1            # OpenCV -> NeRF/OpenGL axes
            frames.append({"file_path": f"{i:04d}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(img_dir, "transforms_train.json"), "w") as f:
            json.dump({"camera_angle_x": 1.2, "frames": frames}, f)
        cfg = os.path.abspath("cfg.yml")
        files_config(cfg, img_dir, os.path.abspath("depth"))

        # the trainer and its PSNR, the steps it took (as phase 8 counts
        # them, all phases together) and the seconds spent decoding frames
        seen = {"decode_s": 0.0, "decodes": 0}
        evaluate = hierarchy.HTGaussianTrainer.evaluate_on_training_images
        load_image = readers.FrameInfo.load_image

        def recorded(self, *a, **kw):
            seen["trainer"], seen["psnr"] = self, evaluate(self, *a, **kw)
            return seen["psnr"]

        def timed_load(self):
            t0 = time.perf_counter()
            img = load_image(self)
            seen["decode_s"] += time.perf_counter() - t0
            seen["decodes"] += 1
            return img

        hierarchy.HTGaussianTrainer.evaluate_on_training_images = recorded
        readers.FrameInfo.load_image = timed_load
        counter = StepCounter()
        originals = counter.wrap_steps()
        B.blend_fwd.launches = 0
        B.blend_bwd.launches = 0
        try:
            t0 = time.perf_counter()
            run.main(["--mode", "train", "--config", cfg], device=str(device))
            train_s = time.perf_counter() - t0
            train_launches = launch_counts(B)
            for m, n, fn in originals:
                setattr(m, n, fn)
            originals = []
            train_decode = dict(s=seen["decode_s"], frames=seen["decodes"])
            t0 = time.perf_counter()
            for mode in ("eval_pose", "eval_nvs"):
                run.main(["--mode", mode, "--config", cfg],
                         device=str(device))
            eval_s = time.perf_counter() - t0
        finally:
            hierarchy.HTGaussianTrainer.evaluate_on_training_images = \
                evaluate
            readers.FrameInfo.load_image = load_image
            for m, n, fn in originals:
                setattr(m, n, fn)
        launches = launch_counts(B)
        tr = seen["trainer"]
        out = tr.result_path
        # the root's size beside phase 8's, whose steps these compare with
        root = tr.load_checkpoint(
            os.path.join(out, "chkpnt", "model.npz")).state
        sizes = {"capacity_growths": tr.n_capacity_grows,
                 "root_live": int(root.n_live()),
                 "root_capacity": root.capacity}
        pose_txt = os.path.join(out, "pose", "pose_eval.txt")
        test_txt = os.path.join(out, "test", "test.txt")
        check(os.path.exists(pose_txt) and os.path.exists(test_txt),
              "13: pose_eval.txt and test/test.txt written")
        pose_line = open(pose_txt).read().strip()
        nvs_line = open(test_txt).read().splitlines()[-1]
        os.remove(pose_txt)
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.dirname(os.path.abspath(__file__))]
            + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        proc = subprocess.run(
            [sys.executable, "-m", "ht3dgs_torch", "--mode", "eval_pose",
             "--config", cfg], env=env, capture_output=True, text=True,
            timeout=300)
        proc_s = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"13: python -m ht3dgs_torch exits 0 ({proc.stderr[-2000:]})")
        check(os.path.exists(pose_txt)
              and open(pose_txt).read().strip() == pose_line,
              "13: python -m ht3dgs_torch wrote the same pose_eval.txt")
        with open(os.path.join(out, "phase_timing.json")) as f:
            timing = json.load(f)
    finally:
        os.chdir(cwd)
    rot_err = rotation_errors(tr, scene)
    psnr = seen["psnr"]
    check(tr.seq_len == TIER_FRAMES and all(
        f._image is None and f.image_path.endswith(".png") for f in tr.data),
        f"13: the {TIER_FRAMES} frames read from PNG files")
    check(max(rot_err) < MAX_ROT_DEG,
          f"13: relative-pose rotation error < {MAX_ROT_DEG} deg")
    check(psnr > MIN_PSNR, f"13: train-view mean PSNR > {MIN_PSNR} dB")
    check(all(train_launches.values()), "13: K1 and K2 launched in training")
    check(launches["blend_fwd"] > train_launches["blend_fwd"],
          "13: eval_nvs launched K1")
    print("files " + json.dumps({
        "fixtures": len(manifest), "fixtures_equal_pillow": len(manifest),
        "host_ms_median_of_10": ms, "train_s": round(train_s, 3),
        "trainer_phases_s": {k: round(v.get("total_s", 0.0), 3)
                             for k, v in timing.items()},
        "train_steps": counter.steps[None],
        "train_model_steps": counter.model_steps[None], **sizes,
        "train_frame_decodes": train_decode,
        "eval_pose_and_nvs_s": round(eval_s, 3),
        "subprocess_eval_pose_s": round(proc_s, 3),
        "train_view_psnr": psnr, "max_rot_err_deg": max(rot_err),
        "pose_eval": pose_line, "eval_nvs": nvs_line,
        "launches": launches}))
    return launches


# phase 14: the scale tier at train_level 2 from files. The hierarchy's
# shape is the tier's (48 frames, 4 leaves, 2 level-1 non-leaves, MSS phase
# 1 at both non-leaf levels, 3 merges); only budgets are cut, each for the
# script's time (the uncut recipe is ~40k steps, `python -m
# ht3dgs_torch.real_image_bench OUT --scale`):
# - Phase A's fits 300 -> 40 and pose fits 120 -> 25 iterations (12
#   chunks of 4 pairs);
# - the leaf init 300 -> 40 iterations and the steps per leaf frame
#   80 -> 14;
# - MSS phase 1 from 10 to 4 and phase 2 from 300 to 10 steps per frame
#   at levels 1 and 0.
SCALE_CUTS = dict(phase_a_fit_iters=40, phase_a_pose_iters=25,
                  leaf_init_iters=40, single_step=14,
                  mss_phase1_iteration_per_frame=4,
                  num_iterations_per_frame_each_level=[10, 10, 10])


def frame_ranges(lists) -> str:
    return ", ".join(f"{fr[0]}-{fr[-1]}" for fr in lists)


def phase_scale(B, device, seed: int, workdir: str):
    """Phase 14: the photo scene at the scale tier's size (48 frames at
    208x160, blender layout with exact depths) and the tier's recipe
    (`utils/tiers.py`, train_level 2, partition v1) with SCALE_CUTS,
    written as cfg.yml and trained by `run.main(["--mode", "train",
    "--config", cfg.yml])`. Gates: train-view PSNR above 18 dB, every
    relative-pose rotation error below 3 degrees, the root covering frames
    0-47, 4 / 2 / 1 segments, 3 merges and MSS phase 1 three times (both
    level-1 non-leaves and the root), K1 and K2 launched once per step in
    every trainer phase that trains; the root step timed at the last
    training step's K. Then the root's step at the training's tile
    arguments and at the eval sweep's (timed), the first profiled with the
    binning's fill, and K1 and K2 at the root's training shape (frame 0's
    entry lists at the training's tile arguments) against their plain
    versions, timed. Returns the launches of the run and the K1/K2 records
    and counts at the root's shape."""
    import torch

    from ht3dgs_torch import real_image_bench, run
    from ht3dgs_torch.eval import pose_eval
    from ht3dgs_torch.train import hierarchy
    from ht3dgs_torch.utils import photo_scene
    from ht3dgs_torch.utils.config import load_configs
    from ht3dgs_torch.utils.profiling import (StepCounter, root_step_figures,
                                              tile_lists)
    from ht3dgs_torch.utils.tiers import apply_tier, tier_dims

    h, w, n = tier_dims("scale")
    data_dir = os.path.join(workdir, "data")
    t0 = time.perf_counter()
    gt, _ = photo_scene.write_dataset(data_dir, n_frames=n, height=h,
                                      width=w, seed=seed)
    scene_s = time.perf_counter() - t0
    want = load_configs()
    apply_tier("scale", *want, data_dir)
    want[0].data_path_train = data_dir
    want[0].data_type_train = "blender"
    for k, v in SCALE_CUTS.items():
        setattr(want[2], k, v)
    check(want[1].train_level == 2 and want[1].partition_strategy == "v1",
          "14: train_level 2, partition v1")
    cfg = os.path.join(workdir, "cfg.yml")
    write_config(cfg, want, "# the scale tier at train_level 2 "
                 "(chip_smoke.py phase 14)", "14")

    counter = StepCounter()
    originals = counter.wrap_steps() + counter.watch_trainer(
        hierarchy.HTGaussianTrainer)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        B.blend_fwd.launches = 0
        B.blend_bwd.launches = 0
        t0 = time.perf_counter()
        run.main(["--mode", "train", "--config", cfg], device=str(device))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts(B)
        peak = torch.cuda.max_memory_allocated()
        StepCounter.restore(originals)
        originals = []
        tr = counter.trainer
        root = tr.gs_bundle
        psnr = tr.evaluate_on_training_images(save_images=False)
        # one root step at the training's tile arguments (timed and
        # profiled) and at the eval sweep's (timed)
        root_rec = root_step_figures(tr, root, counter, "phase 14",
                                     profile=True)
        # K1 and K2 at the shape the root trains at: frame 0's entry lists
        # at the training's tile arguments
        ent, meta, *_ = tile_lists(root.state,
                                   tr.camera_for(0, pose=root.get_RT(0)),
                                   counter.train_tile_args)
    finally:
        os.chdir(cwd)
        StepCounter.restore(originals)

    lists = tr.partition(tr.seq_len, 2)
    table = counter.table(tr.timer)
    T, K, _ = ent.shape
    ta = dict(counter.train_tile_args or {})
    check((ta.get("tile_h", 16), ta.get("tile_w", 16)) == (16, 16),
          "14: the root trained on 16x16 tiles")
    where = f"14: {{}} at the root's training shape (T = {T}, K = {K})"
    rec_f, ncon, t_fin, work = phase_fwd(B, ent, meta, 256,
                                         where.format("K1"), plain_reps=1)
    rec_b = phase_bwd(B, ent, meta, t_fin, ncon, 256, seed,
                      where.format("K2"), plain_reps=1)
    del ent, meta, ncon, t_fin
    # every launch of phase 14 is at T tiles but Phase A's, at B x T
    batch = tr.pipe_cfg.phase_a_batch
    at_t = {k: v - table["phase_a"]["launches"].get(k, 0)
            for k, v in launches.items()}
    print(f"phase 14: Phase A launches K1/K2 over B x T = {batch} x {T} = "
          f"{batch * T} tiles a batched step (K = "
          f"{(table['phase_a']['tile_args'] or {}).get('max_per_tile')}); "
          f"the other phases over T = {T} tiles: {at_t} launches")
    root_kernels = {"T": T, "K": K, "work": work, "launches": at_t,
                    "blend_fwd": rec_f, "blend_bwd": rec_b}
    rot = real_image_bench.rotation_errors(tr.pose_dict, gt)
    ev = pose_eval.evaluate_poses(gt, root.poses[:n])
    print(f"phase 14: scale tier, {n} frames {w}x{h} written in "
          f"{scene_s:.1f} s; run.main --mode train {wall:.1f} s; tile args "
          f"{tr._tile_args}; capacity growths {tr.n_capacity_grows}")
    for lv in (2, 1, 0):
        print(f"phase 14: partition level {lv}: {frame_ranges(lists[lv])}")
    for b in counter.bundles:
        print(f"phase 14: bundle {b['tag']} frames {b['frames'][0]}-"
              f"{b['frames'][1]}: {b['live']} live of capacity "
              f"{b['capacity']}, M {b['M']}")
    for name in HIER_PHASES:
        r = table.get(name, {})
        per = (f"{r['ms_per_step']:.2f} ms per step" if r.get("ms_per_step")
               else "no steps")
        print(f"phase 14 [{name}]: {r.get('s', 0.0):.3f} s "
              f"x{r.get('count', 0)}, {r.get('steps', 0)} steps "
              f"({r.get('model_steps', 0)} model-steps), {per}, launches "
              f"{r.get('launches', {})}, drops {r.get('drops', {})}")
    print(f"phase 14: peak memory of the training {peak / 2**30:.3f} GiB")
    print(f"phase 14: relative-pose rotation error, degrees: max "
          f"{max(rot):.4f}, mean {np.mean(rot):.4f}; ATE x100 "
          f"{100 * ev['ATE']:.4f}, RPE_trans x100 "
          f"{ev['RPE_trans_x100']:.4f}, RPE_rot {ev['RPE_rot_deg']:.4f} "
          f"deg; train-view mean PSNR {psnr:.3f} dB")
    print("scale " + json.dumps({
        "frames": n, "width": w, "height": h, "train_s": round(wall, 3),
        "partition": {lv: frame_ranges(lists[lv]) for lv in (2, 1, 0)},
        "bundles": counter.bundles, "phases": table,
        "capacity_growths": tr.n_capacity_grows, **root_rec,
        "peak_memory_gib": peak / 2**30, "train_view_psnr": psnr,
        "max_rot_err_deg": max(rot), "ATE_x100": 100 * ev["ATE"],
        "RPE_trans_x100": ev["RPE_trans_x100"],
        "RPE_rot_deg": ev["RPE_rot_deg"], "launches": launches}))

    check(psnr > MIN_PSNR, f"14: train-view mean PSNR > {MIN_PSNR} dB")
    check(max(rot) < MAX_ROT_DEG,
          f"14: relative-pose rotation error < {MAX_ROT_DEG} deg")
    check(root.to_visit_frames == list(range(n)),
          f"14: the root covers frames 0-{n - 1}")
    check([len(lists[lv]) for lv in (2, 1, 0)] == [4, 2, 1],
          "14: 4 leaves, 2 level-1 non-leaves, the root")
    check(table.get("merge", {}).get("count") == 3, "14: 3 merges")
    check(table.get("nonleaf_phase1", {}).get("count") == 3,
          "14: MSS phase 1 at both level-1 non-leaves and the root")
    for name, r in table.items():
        for k in ("blend_fwd", "blend_bwd"):
            check(r["launches"].get(k, 0) >= r["steps"],
                  f"14 [{name}]: {k} launched once per step")
    check(all(table[p]["steps"] > 0 for p in (
        "phase_a", "leaf", "nonleaf_phase1", "nonleaf_phase2")),
        "14: every training phase took steps")
    check(all(launches.values()), "14: K1 and K2 launched")
    last_k = dict(counter.tile_args["nonleaf_phase2"] or {})
    check(root_rec["root_step_train"]["K"] == last_k.get("max_per_tile"),
          "14: the root step timed at the last training step's K")
    return launches, root_kernels


# phase 15: the published configs through the CLI ("published"). The
# configs' own recipe (train_level 2, partition v1, VFI pose mode, base+vfi
# MSS, render_mode auto, no init cap, the renderer's default tile arguments
# with auto-grow, Phase A batch 8, opacity resets), the photo scene written
# where each config reads it, relative to the working directory.
REPO = os.path.dirname(os.path.abspath(__file__))
PUBLISHED = {
    # the 1.6K cap's frame size (1920x1080 Tanks frames load at 1600x900);
    # the stride-2 split ("Family" in the path): 12 train, 12 test frames
    "tanks": dict(config="configs/tanks/Family.yml", frames=24, width=1600,
                  height=900),
    # one under the cap; the stride-8 split: 14 train, 2 test frames
    "co3d": dict(config="configs/co3d/hydrant_106_12648_23157.yml",
                 frames=16, width=1200, height=900),
    # trained from the COLMAP layout (FovX null): the camera's focal from
    # the median FovX of the seven other Tanks configs (Museum's), as
    # Church's cameras.bin is not in the repo; the stride-8 split: 21
    # train, 3 test frames. Not a phase of the whole run: run it alone
    # with --published church WORKDIR RECORD -
    "church": dict(config="configs/tanks/Church.yml", frames=24,
                   width=1600, height=900, fovx=1.3604490659339243),
}
# iteration budgets cut for the script's time, on the CLI; every other
# value is the config's
PUBLISHED_CUTS = dict(phase_a_fit_iters=50, phase_a_pose_iters=50,
                      leaf_init_iters=20, single_step=7,
                      num_iterations_per_frame_each_level=[15, 15, 15],
                      mss_phase1_iteration_per_frame=2,
                      reset_recovery_iters=10, eval_nvs_epochs=25)
PUBLISHED_MODES = {"tanks": ("eval_pose", "eval_nvs", "render"),
                   "co3d": ("eval_nvs", "render"),
                   "church": ("eval_nvs", "render")}
# the longest wait on another process of phase 15: Family's scene writer,
# Family's Phase A (the CO3D process's wait), the CO3D process's end
PUBLISHED_CHILD_S = 600


def published_argv(kind: str, vfi_dir: str):
    """The CLI of one published config: its path, then each override with
    its reason."""
    from ht3dgs_torch.utils.config import load_configs

    cfg = os.path.join(REPO, PUBLISHED[kind]["config"])
    _, pipe, optim = load_configs(cfg)
    over = [("vfi_provider", "precomputed",
             f"the config's {pipe.vfi_provider} needs "
             f"{pipe.vfi_checkpoint}, which is not in the repo: the scene's "
             "frames at the midpoint poses stand in"),
            ("vfi_dir", vfi_dir, "where those frames are written")]
    over += [(k, v, f"cut for the script's time (config: "
              f"{getattr(optim, k)})") for k, v in PUBLISHED_CUTS.items()]
    argv = ["--config", cfg]
    for k, v, why in over:
        text = yaml_value(v) if isinstance(v, list) else str(v)
        print(f"phase 15 ({kind}): --{k} {text}: {why}")
        argv += [f"--{k}", text]
    print(f"phase 15 ({kind}): data paths, depth_dir, train_pose_mode, "
          "render_mode, init_max_points, the tile presets and phase_a_batch: "
          "the config's own")
    return argv


# written beside a published config's layout: the scene's true poses, K,
# the VFI frames' directory and the seconds it took to write
SCENE_RECORD = "scene.npz"


def published_scene(kind: str, seed: int, workers=None) -> None:
    """The photo scene written where config `kind` reads it, relative to the
    working directory, on `workers` threads, with its SCENE_RECORD."""
    from ht3dgs_torch.utils import photo_scene
    from ht3dgs_torch.utils.config import load_configs

    spec = PUBLISHED[kind]
    model, pipe, _ = load_configs(os.path.join(REPO, spec["config"]))
    t0 = time.perf_counter()
    if kind in ("tanks", "church"):
        scene_dir = os.path.normpath(model.data_path_eval)
        gt, K = photo_scene.write_tanks(
            scene_dir, n_frames=spec["frames"], height=spec["height"],
            width=spec["width"], fovx=model.FovX or spec["fovx"], seed=seed,
            workers=workers)
        vfi_dir = os.path.join(scene_dir, "vfi")
    else:
        vfi_dir = os.path.join(os.path.dirname(pipe.depth_dir), "vfi")
        gt, K = photo_scene.write_co3d(
            model.data_path_train, model.category, model.seq_name,
            pipe.depth_dir, vfi_dir, n_frames=spec["frames"],
            height=spec["height"], width=spec["width"], seed=seed,
            workers=workers)
    np.savez(SCENE_RECORD, gt=gt, K=K, vfi_dir=vfi_dir,
             s=time.perf_counter() - t0)


def published_scene_in(workdir: str, kind: str, seed: int,
                       workers: int) -> None:
    """published_scene in `workdir` (a process's target)."""
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    published_scene(kind, seed, workers)


def published_config(B, device, seed: int, workdir: str, kind: str,
                     signal=None, after=None) -> dict:
    """One published config in `workdir`: its layout written (unless a
    process wrote it there before: its SCENE_RECORD), then `run.main` in
    train and each eval mode of PUBLISHED_MODES. With `signal`, that file
    is created once Phase A has ended; with `after`, the training waits
    for that file. Gates: the recipe kept, train-view PSNR, rotation
    errors, eval_nvs PSNR, the files written, K1 and K2 once per step in
    every trainer phase. Returns the record (with the trainer and
    StepCounter under "trainer" and "counter")."""
    import torch

    from ht3dgs_torch import real_image_bench, run
    from ht3dgs_torch.data import depth as depth_lib
    from ht3dgs_torch.data import readers
    from ht3dgs_torch.train import hierarchy
    from ht3dgs_torch.utils import profiling
    from ht3dgs_torch.utils.config import load_configs
    from ht3dgs_torch.utils.profiling import StepCounter

    spec = PUBLISHED[kind]
    model, pipe, _ = load_configs(os.path.join(REPO, spec["config"]))
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    seen = {"decode_s": 0.0, "decodes": 0, "pcd": [], "depth": []}
    hier = hierarchy.HTGaussianTrainer

    def recorded_psnr(fn):
        def call(self, *a, **kw):
            seen["psnr"] = fn(self, *a, **kw)
            return seen["psnr"]
        return call

    def timed_load(fn):
        def call(self):
            t0 = time.perf_counter()
            img = fn(self)
            seen["decode_s"] += time.perf_counter() - t0
            seen["decodes"] += 1
            return img
        return call

    def counted_pcd(fn):
        def call(self, idx, down_sample=True, use_vfi_frame=False):
            pcd = fn(self, idx, down_sample, use_vfi_frame)
            seen["pcd"].append((idx, use_vfi_frame, len(pcd.points)))
            return pcd
        return call

    def timed_write(fn):
        def call(self, *a, **kw):
            t0 = time.perf_counter()
            out = fn(self, *a, **kw)
            seen["write_s"] = seen.get("write_s", 0.0) + (
                time.perf_counter() - t0)
            return out
        return call

    def looked_up(fn):
        def call(self, image, name):
            seen["depth"].append(
                (name, os.path.exists(os.path.join(self.dir, name + ".npy"))))
            return fn(self, image, name)
        return call

    def signalled(fn):
        def call(self):
            out = fn(self)
            open(signal, "w").close()
            return out
        return call

    try:
        prewritten = os.path.exists(SCENE_RECORD)
        if not prewritten:
            published_scene(kind, seed)
        with np.load(SCENE_RECORD) as z:
            gt, scene_s, vfi_dir = z["gt"], float(z["s"]), str(z["vfi_dir"])
        argv = published_argv(kind, vfi_dir)
        waited = 0.0
        if after:
            t0 = time.perf_counter()
            while not os.path.exists(after):
                waited = time.perf_counter() - t0
                check(waited < PUBLISHED_CHILD_S, f"15 ({kind}): {after} "
                      f"within {PUBLISHED_CHILD_S} s")
                time.sleep(0.2)

        counter = StepCounter(track_peaks=device.type == "cuda")
        originals = counter.wrap_steps() + counter.watch_trainer(hier)
        with contextlib.ExitStack() as stack:
            for owner, name, make in (
                    (hier, "evaluate_on_training_images", recorded_psnr),
                    (readers.FrameInfo, "load_image", timed_load),
                    (hier, "prepare_pcd", counted_pcd),
                    (depth_lib.PrecomputedDepth, "__call__", looked_up),
                    (hier, "_write_breadcrumb", timed_write),
                    (hier, "save_checkpoint", timed_write)) + (
                    ((hier, "_phase_a", signalled),) if signal else ()):
                stack.enter_context(wrapped(owner, name, make))
            try:
                if device.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                B.blend_fwd.launches = 0
                B.blend_bwd.launches = 0
                # Church's run records the tracer's counters and spans: MSS
                # phase 1's pseudo-views (`_pseudo_view`)
                tracer = (profiling.tracing() if kind == "church"
                          else contextlib.nullcontext())
                t0 = time.perf_counter()
                with tracer as trace:
                    run.main(["--mode", "train"] + argv, device=str(device))
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                launches = launch_counts(B)
            finally:
                StepCounter.restore(originals)
            train_decode = dict(s=seen["decode_s"], frames=seen["decodes"])
            tr = counter.trainer
            table = counter.table(tr.timer)
            out = tr.result_path
            i_train = tr.scene_info.i_train
            rot = real_image_bench.rotation_errors(tr.pose_dict, gt[i_train])
            evals = {}
            for mode in PUBLISHED_MODES[kind]:
                k0 = launch_counts(B)
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                run.main(["--mode", mode] + argv, device=str(device))
                if device.type == "cuda":
                    torch.cuda.synchronize()
                evals[mode] = {"s": time.perf_counter() - t0, "launches": {
                    k: v - k0[k] for k, v in launch_counts(B).items()},
                    "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                                 if device.type == "cuda" else None)}
            if "eval_pose" not in PUBLISHED_MODES[kind]:
                # the default split's test frames against the train poses:
                # raises in both packages (ROADMAP Queue 3)
                try:
                    run.main(["--mode", "eval_pose"] + argv,
                             device=str(device))
                    raised = None
                except ValueError as e:
                    raised = str(e)
                print(f"phase 15 ({kind}): eval_pose left out: with the "
                      f"default split it compares the {len(i_train)} train "
                      f"poses with the test frames' and raises in both "
                      f"packages (here: ValueError: {raised})")
                check(raised is not None, f"15 ({kind}): eval_pose raises "
                      "ValueError, as in the JAX package")
    finally:
        os.chdir(cwd)
    out = os.path.join(workdir, out)
    nvs_line = open(os.path.join(out, "test", "test.txt")).read()\
        .splitlines()[-1]
    nvs_psnr = float(re.match(r"PSNR : ([0-9.]+)", nvs_line).group(1))
    rendered = sorted(os.listdir(os.path.join(out, "nvs", model.traj_opt,
                                              "img_out")))
    pose_line = (open(os.path.join(out, "pose", "pose_eval.txt")).read()
                 .strip() if "eval_pose" in PUBLISHED_MODES[kind] else None)
    pcd = seen["pcd"]
    vfi_depth = [found for name, found in seen["depth"]
                 if name.endswith("_vfi")]
    p, w = tr.pipe_cfg, tr.data[0]
    rec = {
        "config": spec["config"], "frames": spec["frames"],
        "width": w.width, "height": w.height, "train_frames": tr.seq_len,
        "scene_s": round(scene_s, 3), "scene_prewritten": prewritten,
        "waited_s": round(waited, 3), "train_s": round(train_s, 3),
        "train_frame_decodes": train_decode,
        "init_points": {"frames": sum(not v for _, v, _ in pcd),
                        "vfi_frames": sum(v for _, v, _ in pcd),
                        "min": min(n for *_, n in pcd),
                        "max": max(n for *_, n in pcd)},
        "vfi_depth_lookups": {"found": sum(vfi_depth),
                              "base_frame_depth": len(vfi_depth)
                              - sum(vfi_depth)},
        "bundles": counter.bundles, "phases": table,
        "tile_arg_changes": counter.growths,
        "capacity_growths": tr.n_capacity_grows,
        "peak_memory_gib": max([r.get("peak_gib", 0.0)
                                for r in table.values()] or [0.0]),
        "checkpoint_and_crumb_writes_s": round(seen.get("write_s", 0.0), 3),
        "train_view_psnr": seen["psnr"], "max_rot_err_deg": max(rot),
        "eval": evals, "eval_nvs": nvs_line, "eval_nvs_psnr": nvs_psnr,
        "pose_eval": pose_line, "rendered_frames": len(rendered),
        "launches": launches}
    if trace is not None:
        pseudo = [sp for sp in trace.spans if sp["name"] == "pseudo"]
        rec["pseudo"] = dict(
            {k: trace.counters.get(k, 0) for k in (
                "pseudo_views", "pseudo_rows", "pseudo_dropped_k")},
            spans=len(pseudo), in_frame=sum(
                trace.spans[sp["parent"]]["name"] == "frame"
                for sp in pseudo),
            host_ms=sum(sp["end_ns"] - sp["start_ns"] for sp in pseudo)
            / 1e6)
        print(f"phase 15 ({kind}): MSS phase 1's pseudo-views (tracer): "
              f"{rec['pseudo']}")
    print(f"phase 15 ({kind}): {spec['config']}: {spec['frames']} frames "
          f"{w.width}x{w.height} ({tr.seq_len} train) written in "
          f"{scene_s:.1f} s"
          + (" (by a process, during phases 12 and 14)" if prewritten
             else "")
          + (f"; waited {waited:.1f} s for Family's Phase A" if after
             else "")
          + f"; run.main --mode train {train_s:.1f} s; frames "
          f"decoded in {train_decode['s']:.2f} s ({train_decode['frames']} "
          f"decodes)")
    print(f"phase 15 ({kind}): init points per frame: {pcd}")
    print(f"phase 15 ({kind}): VFI-frame depth: {sum(vfi_depth)} of "
          f"{len(vfi_depth)} lookups found {{name}}_vfi.npy, the rest took "
          "the base frame's depth")
    for b in counter.bundles:
        print(f"phase 15 ({kind}): bundle {b['tag']} frames {b['frames'][0]}-"
              f"{b['frames'][1]}: {b['live']} live of capacity "
              f"{b['capacity']}, M {b['M']}")
    for name in HIER_PHASES:
        r = table.get(name, {})
        per = (f"{r['ms_per_step']:.2f} ms per step" if r.get("ms_per_step")
               else "no steps")
        print(f"phase 15 ({kind}) [{name}]: {r.get('s', 0.0):.3f} s "
              f"x{r.get('count', 0)}, {r.get('steps', 0)} steps "
              f"({r.get('model_steps', 0)} model-steps), {per}, launches "
              f"{r.get('launches', {})}, drops {r.get('drops', {})}, tile "
              f"args {r.get('tile_args')}, opacity resets "
              f"{r.get('opacity_resets', 0)}, peak "
              f"{r.get('peak_gib', float('nan')):.3f} GiB")
    for g in counter.growths:
        print(f"phase 15 ({kind}): tile arguments changed in {g['phase']} "
              f"at its step {g['step']}: {g['tile_args']}")
    print(f"phase 15 ({kind}): the crumbs and the checkpoint written "
          f"(np.savez_compressed) in {rec['checkpoint_and_crumb_writes_s']}"
          f" s of the training's {train_s:.1f} s")
    for mode, e in evals.items():
        print(f"phase 15 ({kind}): {mode} {e['s']:.3f} s, launches "
              f"{e['launches']}, peak {e['peak_gib']} GiB")
    print(f"phase 15 ({kind}): relative-pose rotation error max "
          f"{max(rot):.4f} deg; train-view PSNR {seen['psnr']:.3f} dB; "
          f"eval_nvs {nvs_line!r}; eval_pose {pose_line!r}; "
          f"{len(rendered)} rendered frames; peak memory of the training "
          f"{rec['peak_memory_gib']:.3f} GiB")

    what = f"15 ({kind})"
    if kind == "church":
        f0 = tr.data[0]
        fx = spec["width"] / (2.0 * math.tan(spec["fovx"] / 2.0))
        check(tr.model_cfg.data_type == "colmap" and tr.model_cfg.FovX is None
              and abs(float(f0.intrinsics[0, 0]) - fx) < 1e-3 * fx,
              f"{what}: trained from the COLMAP layout, its camera's focal "
              f"{float(f0.intrinsics[0, 0]):.3f} px ({fx:.3f})")
        pv = rec["pseudo"]
        check(pv["pseudo_views"] > 0 and pv["spans"] == pv["pseudo_views"]
              and pv["in_frame"] == pv["spans"],
              f"{what}: a `pseudo` span inside `frame` for every pseudo-view "
              f"({pv['pseudo_views']})")
    check((p.train_pose_mode, p.render_mode, p.init_max_points,
           p.phase_a_batch, p.tile_max_per_tile, p.tile_dup_factor,
           p.train_level, p.partition_strategy,
           p.multi_source_supervision) == ("vfi", "auto", 0, 8, 0, 0, 2,
                                           "v1", "base+vfi"),
          f"{what}: the config's recipe")
    check((w.width, w.height) == (spec["width"], spec["height"])
          and all(f._image is None and f.image_path.endswith(".png")
                  for f in tr.data), f"{what}: frames read from PNG files "
          f"at {spec['width']}x{spec['height']}")
    check(vfi_depth and all(vfi_depth), f"{what}: every VFI-frame depth "
          "read from its file")
    check(seen["psnr"] > MIN_PSNR, f"{what}: train-view PSNR > {MIN_PSNR}")
    check(max(rot) < MAX_ROT_DEG, f"{what}: rotation error < {MAX_ROT_DEG}")
    check(nvs_psnr > MIN_PSNR, f"{what}: eval_nvs PSNR > {MIN_PSNR}")
    check(len(rendered) == 120, f"{what}: render wrote 120 frames")
    check(os.path.exists(os.path.join(out, "chkpnt", "model.npz")),
          f"{what}: chkpnt/model.npz written")
    for name, r in table.items():
        for k in ("blend_fwd", "blend_bwd"):
            check(r["launches"].get(k, 0) >= r["steps"],
                  f"{what} [{name}]: {k} launched once per step")
    check(all(table[n]["steps"] > 0 for n in (
        "phase_a", "leaf", "nonleaf_phase1", "nonleaf_phase2")),
        f"{what}: every training phase took steps")
    return dict(rec, trainer=tr, counter=counter)


def phase_published(B, device, seed: int, workdir: str, writer=None):
    """Phase 15: configs/tanks/Family.yml and a configs/co3d/*.yml through
    `run.main --config` (published_config; the CO3D config in a process of
    its own, which trains once Family's Phase A has ended), then K1 and K2
    at Family's trained root, once that process has ended: frame 0's entry
    lists at the tile arguments the training ended on, against their plain
    versions and timed, with Phase A's launch shape. `writer`: a process
    writing Family's scene in workdir/tanks, waited for first. Returns
    (launches of every run, the K1/K2 records at the root's shape)."""
    import torch

    from ht3dgs_torch.utils.profiling import tile_lists

    launches = {"blend_fwd": 0, "blend_bwd": 0}
    torch.cuda.empty_cache()
    if writer is not None:
        writer.join(PUBLISHED_CHILD_S)
        check(writer.exitcode == 0, "15 (tanks): the scene written")
    # the CO3D config runs in a process of its own: it writes its scene
    # during Family's Phase A, trains once that has ended, so that its
    # device work overlaps Family's host work (the crumbs' compression,
    # the rendered PNGs) rather than Family's Phase A
    record = os.path.join(workdir, "co3d.json")
    log = os.path.join(workdir, "co3d.log")
    phase_a_done = os.path.join(workdir, "tanks_phase_a_done")
    with open(log, "w") as out:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--published", "co3d", os.path.join(workdir, "co3d"), record,
             phase_a_done], stdout=out)
    try:
        rec = published_config(B, device, seed,
                               os.path.join(workdir, "tanks"), "tanks",
                               signal=phase_a_done)
        rc = child.wait(timeout=PUBLISHED_CHILD_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    print(open(log).read(), end="")
    check(rc == 0, f"15 (co3d): its process exited with {rc}")
    tr, counter = rec.pop("trainer"), rec.pop("counter")
    root = tr.gs_bundle
    ta = dict(counter.train_tile_args or {})
    ent, meta, *_ = tile_lists(
        root.state, tr.camera_for(0, pose=root.get_RT(0)), ta)
    pa_args = rec["phases"]["phase_a"]["tile_args"] or {}
    batch = tr.pipe_cfg.phase_a_batch
    del tr, counter
    print("published " + json.dumps({"tanks": rec}))
    with open(record) as f:
        recs = {"tanks": rec, "co3d": json.load(f)}
    for rec in recs.values():
        for k in launches:
            launches[k] += rec["launches"][k] + sum(
                e["launches"][k] for e in rec["eval"].values())
    T, K, _ = ent.shape
    check((ta.get("tile_h", 16), ta.get("tile_w", 16)) == (16, 16),
          "15: Family's root trained on 16x16 tiles")
    where = f"15: {{}} at Family's root, T = {T}, K = {K}"
    rec_f, ncon, t_fin, work = phase_fwd(B, ent, meta, 256,
                                         where.format("K1"), plain_reps=1)
    rec_b = phase_bwd(B, ent, meta, t_fin, ncon, 256, seed,
                      where.format("K2"), plain_reps=1)
    del ent, meta, ncon, t_fin
    # Family's training launches at T tiles: all but Phase A's (B x T)
    fam = recs["tanks"]
    pa = fam["phases"]["phase_a"]
    at_t = {k: v - pa["launches"].get(k, 0)
            for k, v in fam["launches"].items()}
    print(f"phase 15: Family's Phase A launches K1/K2 over B x T = "
          f"{batch} x {T} = {batch * T} tiles a batched step (K = "
          f"{pa_args.get('max_per_tile', 1024)}, dup "
          f"{pa_args.get('dup_factor', 16)}: the renderer's defaults unless "
          f"grown; "
          f"{pa['steps']} batched steps); its other phases over T = {T} "
          f"tiles: {at_t} launches")
    return launches, {"T": T, "K": K, "work": work, "launches": at_t,
                      "blend_fwd": rec_f, "blend_bwd": rec_b}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="PATH",
                    help="also profile one 1080p train step with "
                    "torch.profiler (device time by kernel and by layer) "
                    "and write its table of device time by kernel to PATH")
    ap.add_argument("--published", nargs=4,
                    metavar=("KIND", "WORKDIR", "RECORD", "AFTER"),
                    help="run only phase 15's config KIND (tanks, co3d or "
                    "church) in WORKDIR, its training once the file AFTER "
                    "exists (at once with AFTER -), and write its record "
                    "to RECORD as JSON (phase 15 runs the CO3D config this "
                    "way, beside Family)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from ht3dgs_torch import kernels
    from ht3dgs_torch.core.camera import intrinsics_from_fov, make_camera
    from ht3dgs_torch.raster import blend as B
    from ht3dgs_torch.raster import projection as PR
    from ht3dgs_torch.utils.profiling import tile_lists

    device = torch.device("cuda")
    if args.published:
        kind, workdir, record, after = args.published
        rec = published_config(B, device, args.seed, workdir, kind,
                               after=None if after == "-" else after)
        del rec["trainer"], rec["counter"]
        with open(record, "w") as f:
            json.dump(rec, f)
        print("published " + json.dumps({kind: rec}))
        return
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(what: str) -> None:
        """The wall seconds since the last lap, and since the start."""
        now = time.perf_counter()
        print(f"wall: {what} {now - t_lap[0]:.1f} s (at "
              f"{now - t_start:.1f} s)")
        t_lap[0] = now

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    for name, log in kernels.build(kernels.SOURCES
                                   + kernels.HOST_SOURCES).items():
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
    ent, meta, total, nd_m, nd_tile, _ = tile_lists(state, cam, TILE_ARGS)
    T, K, _ = ent.shape
    P = 16 * 16
    print(f"scene: {N} Gaussians, {W}x{H}, T={T} tiles, K={K}, "
          f"{int(total)} entries, dropped m={int(nd_m)} "
          f"tile={int(nd_tile)}, {time.perf_counter() - t0:.1f} s")

    # 3-4. kernels vs plain versions
    rec_fwd, ncon, t_fin, work = phase_fwd(B, ent, meta, P)
    rec_bwd = phase_bwd(B, ent, meta, t_fin, ncon, P, args.seed)
    del ent, meta, ncon, t_fin

    # 5. ragged edges
    phase_ragged(B, device, args.seed, chunk)
    # 16. the projection kernels at the cells' shapes
    project_recs = phase_project(device, args.seed)

    # 6. main path
    B.blend_fwd.launches = 0
    B.blend_bwd.launches = 0
    PR.project_fwd.launches = 0
    PR.project_bwd.launches = 0
    losses, pose_losses, step_ms, drops, trained = main_path(
        state, cam, device, args.seed)
    launches = {"blend_fwd": B.blend_fwd.launches,
                "blend_bwd": B.blend_bwd.launches,
                "project_fwd": PR.project_fwd.launches,
                "project_bwd": PR.project_bwd.launches}
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
    check(launches["project_fwd"] >= n_steps, "P1 launched every step")
    check(launches["project_bwd"] >= n_steps, "P2 launched every step")
    rec_fwd["launches"] = launches["blend_fwd"]
    rec_bwd["launches"] = launches["blend_bwd"]

    # 7. small scene against the oracle
    small_reference(device, args.seed)
    lap("phases 1-7")

    # 8-9. the hierarchical trainer, then the eval modes on its root
    with tempfile.TemporaryDirectory() as workdir:
        hier_launches, ctx = phase_hierarchy(B, device, args.seed, workdir)
        lap("phase 8")
        # 13. the normal entry point from files on disk, next to phase 8
        with tempfile.TemporaryDirectory() as files_dir:
            files_launches = phase_files(B, device, args.seed, files_dir)
        lap("phase 13")
        eval_launches = phase_eval(B, device, ctx)
        lap("phase 9")
    # 10. the networks
    phase_networks(device, args.seed, ctx[2].frames)
    del ctx
    lap("phase 10")
    # 11. multi-device: NCCL at world size 1, then gloo ranks on the card
    mesh_state = mesh_scene(state, args.seed, device)
    nccl_launches = phase_nccl(B, mesh_state, cam, trained[2], device)
    torch.cuda.empty_cache()
    mesh_launches = phase_mesh(B, device, args.seed, mesh_state, cam)
    del mesh_state
    torch.cuda.empty_cache()
    lap("phase 11")
    with tempfile.TemporaryDirectory() as published_dir:
        # phase 15's Family scene, written by a process on the host while
        # phases 12 and 14 run (the first waits on the card, the second
        # on one core)
        writer = multiprocessing.get_context("spawn").Process(
            target=published_scene_in, args=(
                os.path.join(published_dir, "tanks"), "tanks", args.seed,
                max(1, (os.cpu_count() or 1) - 2)))
        writer.start()
        try:
            # 12. the batch axis at the operating point
            batch_launches = phase_batch(B, state, cam, trained[2], device,
                                         args.seed)
            # 14. the scale tier at train_level 2, from files through
            # run.main
            torch.cuda.empty_cache()
            with tempfile.TemporaryDirectory() as scale_dir:
                scale_launches, scale_root = phase_scale(B, device, args.seed,
                                                         scale_dir)
            lap("phases 12 and 14")
            # 15. the published configs through the CLI
            torch.cuda.empty_cache()
            published_launches, published_root = phase_published(
                B, device, args.seed, published_dir, writer)
        finally:
            if writer.is_alive():
                writer.terminate()
            writer.join()
    lap("phase 15")
    for rec in (rec_fwd, rec_bwd):
        by_path = {"train_step": rec["launches"],
                   "hierarchy": hier_launches[rec["name"]],
                   "eval": eval_launches[rec["name"]],
                   "mesh": nccl_launches[rec["name"]]
                   + mesh_launches[rec["name"]],
                   "batch": batch_launches[rec["name"]],
                   "files": files_launches[rec["name"]],
                   "scale": scale_launches[rec["name"]],
                   "published": published_launches[rec["name"]]}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path
    if args.profile:
        from ht3dgs_torch.utils.profiling import profile_step

        os.makedirs(os.path.dirname(os.path.abspath(args.profile)),
                    exist_ok=True)
        profile_step(dict(state=trained[0], opt=trained[1], camera=cam,
                          gt_image=trained[2], lrs=LRS, mode="tiled"),
                     TILE_ARGS, "1080p", args.profile, step_ms)

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
    floor = floors(work, per_eval, clock_mhz, n_sm)
    print(f"instruction floor (SASS instructions / ({WARP_INSTR_PER_SM_CLOCK} per SM and "
          f"clock x {n_sm} SMs x {clock_mhz:.0f} MHz max SM clock)): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in floor.items())
          + f"; instructions per evaluation {per_eval}")
    # the same kernels at the scale tier's root shape (phase 14) and at
    # Family's 1600x900 root (phase 15)
    for key, root, label in (("scale_root", scale_root, "scale root"),
                             ("published_root", published_root,
                              "Family root 1600x900")):
        root_floor = floors(root["work"], per_eval, clock_mhz, n_sm)
        for rec in (rec_fwd, rec_bwd):
            r, name = root[rec["name"]], rec["name"]
            rec[key] = {
                "T": root["T"], "K": root["K"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "floor_ms": root_floor[name],
                "max_abs_err": r["max_abs_err"],
                "launches": root["launches"][name]}
            print(f"{label} {name} (T = {root['T']}, K = {root['K']}): "
                  f"{r['ms']:.4f} ms/call, plain {r['plain_ms']:.3f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"instruction floor {root_floor[name]:.4f} ms "
                  f"({100 * root_floor[name] / r['ms']:.1f}% of the call), "
                  f"{root['launches'][name]} launches at T tiles in its "
                  f"training; library: none")
    print(f"step: median {step_ms:.2f} ms, {H * W / 1e6 / (step_ms / 1e3):.3f}"
          f" MP/s fwd+bwd+Adam ({N} Gaussians, {W}x{H}; {gpu})")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    recs = [rec_fwd, rec_bwd]
    print("kernels " + json.dumps([
        {"name": r["name"], "launches": r["launches"],
         "max_dev": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]} for r in recs]))
    print(gpu)
    print(json.dumps({"kernels": recs, "project": project_recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
