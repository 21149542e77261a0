"""Parallel non-leaf segment training over the (segment, tile) mesh.

Counterpart of `ht3dgs.train.parallel_nonleaf`. Sibling segments of one
level are data-independent until their own merge, so S of them run MSS
phase 1 and phase 2 at once, one per tile group of ranks, in lockstep with
a shared iteration counter that continues from the largest of their
counters.

Phase 1 supervises with pseudo-views of the segment's two frozen children
at SE(3)-interpolated poses. Each rank renders its own segment's views one
by one at the full image size (the JAX package renders all S in one
vmapped forward), from children padded to the level's common capacity and
without the block-sized compact_n, as there. Each segment draws from its
own stream, random.Random(5000 + 11 * i), and plans every phase-1
iteration up front, inactive ones included, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional

import numpy as np
import torch

from ..core import gaussians as G
from ..core import se3
from ..parallel import mesh as mesh_lib
from . import step as step_lib
from .lockstep import LockstepEngine, pad_rows


def _pad_to_capacity(state: G.GaussianState, opt, cap: int):
    """One model and its moments padded to a common capacity, so the
    segments of a level share one (it sets M and compact_n, and so which
    entries drop)."""
    if cap < state.capacity:
        raise ValueError(f"capacity {state.capacity} > {cap}")
    return pad_rows(state, opt, cap - state.capacity)


def _se3_interp_mat(p0_mat: np.ndarray, p1_mat: np.ndarray,
                    alpha: float) -> np.ndarray:
    p0, p1 = (se3.se3_from_matrix(torch.from_numpy(
        np.asarray(p, np.float32))) for p in (p0_mat, p1_mat))
    return se3.se3_to_matrix(se3.se3_interp(p0, p1, alpha)).numpy().astype(
        np.float32)


def train_nonleaf_segments_parallel(tr, bundles: List, frame_lists:
                                    List[List[int]], level: int,
                                    children_pairs: Optional[List] = None,
                                    mesh: mesh_lib.Mesh = None) -> None:
    """MSS phase 1 (with `children_pairs`) then phase 2 for S sibling
    segments at once, segment s on the tile group of mesh segment s. Every
    rank of the world calls it; ranks outside the mesh only receive. The
    bundles are updated in place, the same on every rank, and
    tr.global_iteration is left at the shared final count."""
    S = len(bundles)
    own = None
    if mesh.member:
        own = _train_own_segment(tr, bundles, frame_lists, level,
                                 children_pairs, mesh)
    for b, new in zip(bundles, tr._share_segments(own, mesh, S)):
        b.state, b.opt = new.state, new.opt
        b.global_iteration = new.global_iteration


def _train_own_segment(tr, bundles, frame_lists, level, children_pairs,
                       mesh):
    s = mesh.segment
    o = tr.sched
    use_vfi_mss = ("vfi" in tr.pipe_cfg.multi_source_supervision
                   and tr.vfi_provider is not None)
    b = bundles[s]
    cap = max(x.state.capacity for x in bundles)
    state, opt = _pad_to_capacity(b.state, b.opt, cap)
    rng = random.Random(5000 + 11 * s)
    cam0 = tr.camera_for(frame_lists[0][0])
    eng = LockstepEngine(tr, mesh, state, opt, b.radius, b.spatial_scale,
                         cam0.height, cam0.width, label="parallel nonleaf")
    # the sequential path restores the counter from each bundle; the
    # lockstep segments share the largest
    giter = max(x.global_iteration for x in bundles)

    def frame_cam_gt(fidx, use_vfi):
        pose = b.get_RT(fidx)
        half = (tr.pose_dict.get(f"rel_pose_{fidx}_to_{fidx}.5")
                if use_vfi else None)
        if half is None:
            return tr.camera_for(fidx, pose=pose), tr.device_frame("rgb",
                                                                   fidx)
        return (tr.camera_for(fidx, pose=half @ pose),
                tr.device_frame("vfi", fidx))

    if children_pairs is not None:
        # the phase-1 renders are full images: the engine's auto-grown
        # capacities without its block-sized compact_n
        def child_tile_args():
            ta = {k: v for k, v in (eng.tile_args or {}).items()
                  if k != "compact_n"}
            return ta or None

        ccap = max(c.state.capacity for pair in children_pairs
                   for c in pair)
        children = [_pad_to_capacity(c.state, c.opt, ccap)[0]
                    for c in children_pairs[s]]
        indices_s = [sorted({f for c in pair for f in c.to_visit_frames})
                     for pair in children_pairs]
        ix = indices_s[s]
        o1 = dataclasses.replace(tr.sched)
        if o.mss_phase1_densification_interval is not None:
            o1.densification_interval = o.mss_phase1_densification_interval
        n_iters_s = [o.mss_phase1_iteration_per_frame * len(x)
                     for x in indices_s]
        if o.mss_phase1_densify_until_iter_ratio is not None:
            o1.densify_until_iter = int(
                max(n_iters_s) * o.mss_phase1_densify_until_iter_ratio)
        n1 = max(n_iters_s)
        tr.logger.info(f"[parallel nonleaf p1] level {level} S={len(bundles)}"
                       f" iters {n_iters_s} (mesh {mesh.shape}, cap {cap})")
        # children and poses are frozen in phase 1: plan every iteration
        # first, in the sequential path's draw order
        plans = []
        for _ in range(n1):
            fidx = rng.choice(ix)
            if rng.random() < o.mss_phase1_ratio:
                alpha = rng.random()
                if fidx == ix[-1]:
                    fidx -= 1
                pose_i = _se3_interp_mat(b.get_RT(fidx), b.get_RT(fidx + 1),
                                         alpha)
                ci = None
                for k, c in list(enumerate(children_pairs[s]))[::-1]:
                    if fidx >= c.start_fidx and fidx in c.to_visit_frames:
                        ci = k
                        break
                if ci is None:
                    raise ValueError(f"no child covers frame {fidx}")
                pose_wrt_child = pose_i @ np.linalg.inv(
                    b.get_RT(children_pairs[s][ci].start_fidx))
                plans.append((tr.camera_for(0, pose=pose_i),
                              (ci, tr.camera_for(0, pose=pose_wrt_child))))
            else:
                plans.append(frame_cam_gt(fidx, False))
        for it in range(1, n1 + 1):
            giter += 1
            cam, target = plans[it - 1]
            if isinstance(target, tuple):
                ci, ccam = target
                target = step_lib.render_eval(
                    children[ci], ccam, mode=tr._mode,
                    tile_args=child_tile_args())["image"]
            m = eng.one_iteration(cam, target, giter, sched=o1,
                                  interval=o1.densification_interval,
                                  active=it <= n_iters_s[s])
            if it % 100 == 0:
                tr.logger.info(f"[parallel nonleaf p1] git {giter} it {it} "
                               f"psnr {float(m['psnr']):.2f}")

    o2 = dataclasses.replace(
        tr.sched, densification_interval=o.mss_phase2_densification_interval)
    n2_s = [o.num_iterations_per_frame_each_level[level] * len(fr)
            for fr in frame_lists]
    if o.mss_phase2_densify_until_iter_ratio is not None:
        o2.densify_until_iter = int(
            max(n2_s) * o.mss_phase2_densify_until_iter_ratio)
    tr.logger.info(f"[parallel nonleaf p2] level {level} iters {n2_s}")
    for it in range(1, max(n2_s) + 1):
        giter += 1
        fidx = rng.choice(frame_lists[s])
        use_vfi = (use_vfi_mss and fidx + 1 < tr.seq_len
                   and rng.random() < o.mss_phase2_ratio)
        m = eng.one_iteration(*frame_cam_gt(fidx, use_vfi), giter, sched=o2,
                              interval=o2.densification_interval,
                              active=it <= n2_s[s])
        if it % 100 == 0:
            tr.logger.info(f"[parallel nonleaf p2] git {giter} it {it} "
                           f"psnr {float(m['psnr']):.2f}")

    tr.global_iteration = giter
    return dataclasses.replace(b, state=eng.state, opt=eng.opt,
                               global_iteration=giter)
