"""Parallel leaf-segment training over the (segment, tile) mesh.

Counterpart of `ht3dgs.train.parallel_leaves`. Leaf segments are
data-independent until they merge, so S of them train at once, one per
tile group of ranks; each segment's image rows are split over its tile
ranks (parallel.mesh.build_hierarchy_step). The ranks walk their leaves in
lockstep: the 'even' partition gives every leaf the same schedule (init
fit, per-frame replay, densify / reset cadence), so one shared iteration
counter drives them all, and a leaf that runs out of frames early is
frozen by the step's `active` flag.

The semantics are the sequential path's (same losses, apply codes, densify
cadence, replay sampling and VFI supervision); each leaf draws its frames
from its own stream, random.Random(1000 + 7 * i), as the JAX package's.
"""

from __future__ import annotations

import random
from typing import List

import numpy as np
import torch

from ..core import adam as adam_lib
from ..parallel import mesh as mesh_lib
from .lockstep import LockstepEngine


class _LeafCtx:
    """Host-side bookkeeping of one leaf."""

    def __init__(self, frames, seed, seq_len):
        self.frames = frames
        self.rng = random.Random(seed)
        self.visited = [frames[0]]
        self.poses = np.tile(np.eye(4, dtype=np.float32), (seq_len, 1, 1))
        self.start_fidx = frames[0]
        self.active = True

    def get_RT(self, idx):
        return self.poses[idx]

    def set_RT(self, idx, pose):
        self.poses[idx] = pose.astype(np.float32)

    def sample_training_frame(self):
        """70% bias to the recent half of the visited frames (the
        distribution of HTGaussianTrainer.sample_training_frame)."""
        last = max(1, len(self.visited) // 2)
        if self.rng.random() < 0.7:
            i = self.rng.randint(last, len(self.visited) - 1)
        else:
            i = self.rng.randint(1, last)
        return self.visited[i]


def train_leaf_segments_parallel(tr, frame_lists: List[List[int]],
                                 mesh: mesh_lib.Mesh):
    """Train S = len(frame_lists) leaves at once, leaf s on the tile group
    of segment s. Every rank of the world calls it; ranks outside the mesh
    only receive. Returns the S ModelBundles, the same on every rank, and
    leaves tr.global_iteration at the shared final count."""
    from .hierarchy import ModelBundle, _round_capacity

    S = len(frame_lists)
    own = None
    if mesh.member:
        own = _train_own_leaf(tr, frame_lists, mesh, ModelBundle,
                              _round_capacity)
    return tr._share_segments(own, mesh, S)


def _train_own_leaf(tr, frame_lists, mesh, ModelBundle, _round_capacity):
    s = mesh.segment
    frames = frame_lists[s]
    o = tr.sched
    use_vfi_mss = ("vfi" in tr.pipe_cfg.multi_source_supervision
                   and tr.vfi_provider is not None)
    f0 = frames[0]
    pcd = tr.prepare_pcd(f0)
    # one capacity for every leaf, sized from the largest init point cloud
    presize = max(1.0, getattr(tr.pipe_cfg, "capacity_presize", 1.0))
    need = torch.tensor([float(_round_capacity(
        int(len(pcd.points) * 1.5 * presize)))], device=tr.device)
    cap = int(mesh.mesh_axis.all_reduce_(need, "max")[0])
    bundle = tr.make_model(pcd, capacity=cap)
    ctx = _LeafCtx(frames, seed=1000 + 7 * s, seq_len=tr.seq_len)
    cam0 = tr.camera_for(f0)
    eng = LockstepEngine(tr, mesh, bundle.state, bundle.opt, bundle.radius,
                         bundle.spatial_scale, cam0.height, cam0.width,
                         label="parallel leaves")

    # leaf init: leaf_init_iters on the first frame, densify off
    tr.logger.info(f"[parallel leaves] init fit on frame {f0} "
                   f"(mesh {mesh.shape}, cap {cap})")
    gt0 = tr.device_frame("rgb", f0)
    depth0 = tr.device_frame("depth", f0) if o.lambda_depth else None
    for it in range(1, o.leaf_init_iters + 1):
        eng.state, eng.opt, m = eng.step(
            eng.state, eng.opt, cam0, gt0, eng.lrs_for(it),
            depth_gt=depth0, apply_code=mesh_lib.APPLY_ALL,
            track_stats=False)
        if it % 200 == 0:
            tr.logger.info(f"[parallel init] it {it} "
                           f"psnr {float(m['psnr']):.2f}")
    # training_setup(fit_pose=True) recreates Adam
    eng.opt = adam_lib.init(eng.state.params())

    def cam_gt(fidx, use_vfi):
        pose = ctx.get_RT(fidx)
        half = (tr.pose_dict.get(f"rel_pose_{fidx}_to_{fidx}.5")
                if use_vfi else None)
        if half is None:
            return tr.camera_for(fidx, pose=pose), tr.device_frame("rgb",
                                                                   fidx)
        return (tr.camera_for(fidx, pose=half @ pose),
                tr.device_frame("vfi", fidx))

    def one_iteration(cam, gt, giter):
        return eng.one_iteration(cam, gt, giter, active=ctx.active,
                                 interval=o.densification_interval_leaf)

    giter = 0
    n_steps = max(len(fr) for fr in frame_lists) - 1
    for j in range(n_steps):
        if j + 1 < len(ctx.frames):
            fidx = ctx.frames[j + 1]
            rel = tr.pose_dict[f"rel_pose_{fidx - 1}_to_{fidx}"]
            ctx.set_RT(fidx, rel @ ctx.get_RT(fidx - 1))
            ctx.visited.append(fidx)
            ctx.active = True
        else:
            ctx.active = False
        cur = ctx.frames[min(j + 1, len(ctx.frames) - 1)]

        # reset-recovery replay (train_leaf's just_reset branch)
        if eng.just_reset:
            eng.just_reset = False
            for _ in range(1, o.reset_recovery_iters):
                giter += 1
                fr = ctx.rng.randint(0, max(0, cur - 1))
                one_iteration(*cam_gt(fr, False), giter)

        for it in range(1, o.single_step + 1):
            giter += 1
            fidx = ctx.sample_training_frame()
            use_vfi = (use_vfi_mss and fidx + 1 < tr.seq_len
                       and ctx.rng.random() < o.mss_phase2_ratio)
            m = one_iteration(*cam_gt(fidx, use_vfi), giter)
            if it % 100 == 0:
                tr.logger.info(f"[parallel leaves] git {giter} frame {cur} "
                               f"psnr {float(m['psnr']):.2f}")
        tr.logger.info(f"[parallel leaves] finished frame step {j + 1}"
                       f"/{n_steps} (frame {cur})")

    tr.global_iteration = giter
    return ModelBundle(
        state=eng.state, opt=eng.opt, radius=bundle.radius,
        spatial_scale=bundle.spatial_scale, poses=ctx.poses,
        global_iteration=giter, start_fidx=ctx.start_fidx,
        to_visit_frames=list(frames))
