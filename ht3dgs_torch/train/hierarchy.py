"""Hierarchical-training orchestrator on one device.

Counterpart of `ht3dgs.train.hierarchy.HTGaussianTrainer`, with the same
schedule and host cadence: per-frame relative poses (Phase A), the binary
partition of the frame sequence (Phase B), leaf-segment training with
replay sampling, densify/prune and VFI multi-source supervision, non-leaf
training on pseudo-views from the frozen children (MSS phase 1) and replay
plus VFI (phase 2), importance-pruned SE(3)-re-anchored merges,
checkpoints and crash-resume breadcrumbs.

Every render and backward runs through `train.step` and `train.phase_a`;
this module is host-side control flow. Poses are numpy [4, 4] w2c matrices
per frame per model, anchored at each segment's first frame.

Randomness: `self.rng` (Python's `random.Random(seed)`, drawn in the JAX
trainer's order, so the frame-sampling stream is the same) and `self.gen`,
a `torch.Generator` on the trainer's device that draws the split noise of
densify in place of the JAX trainer's key. The eval modes live in
`train.evals`.

Several ranks (torch.distributed, one process per device): every rank runs
this orchestrator, and at the end of each section (a Phase A batch, a leaf
chunk, a non-leaf chunk, a merge, a sequential segment) every rank holds
bit-equal bundles, poses, random streams and iteration count. With
pipe.mesh_segments x pipe.mesh_tiles ranks or more, leaves and sibling
non-leaf segments train on the (segment, tile) mesh (`parallel_leaves`,
`parallel_nonleaf`) and each segment's bundle is broadcast from its first
rank; Phase A deals the models of each batch over the ranks. Sequential
sections run on rank 0 and broadcast its results: `index_add_` on the card
sums in no fixed order, so ranks that each ran them would drift apart.
While rank 0 works alone, the others wait on the section group
(`parallel.mesh.wait_for_rank`), which has no time limit to speak of;
the results then travel on the main group. Only rank 0 writes crumbs,
checkpoints, poses and logs, and only rank 0 reads resume state (the pose
files, the crumbs): it decides and broadcasts, so a multi-host run resumes
from rank 0's result_path alone.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import io
import json
import os
import pickle
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import interop
from ..core import adam as adam_lib
from ..core import gaussians as G
from ..core import se3
from ..core.gaussians import GaussianState
from ..data.pointcloud import PointCloud
from ..parallel import comm
from ..parallel import mesh as mesh_lib
from ..raster import render_batched
from ..utils.image import save_image
from ..utils.profiling import PhaseTimer, count, span, traced
from . import phase_a as pa
from . import step as step_lib
from .lockstep import pad_rows
from .losses import psnr as psnr_fn
from .trainer import GaussianTrainer


def _round_capacity(n: int) -> int:
    cap = 512
    while cap < n:
        cap *= 2
    return cap


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclass
class ModelBundle:
    """One 3DGS model (a leaf or merged segment) + its optimizer + poses."""

    state: GaussianState
    opt: adam_lib.AdamState
    radius: float               # scene extent for densify thresholds
    spatial_scale: float        # xyz-LR scale (create_from_pcd arg)
    poses: Optional[np.ndarray] = None   # [F, 4, 4] w2c
    global_iteration: int = 0
    start_fidx: int = 0
    to_visit_frames: List[int] = field(default_factory=list)

    def get_RT(self, idx: int) -> np.ndarray:
        if self.poses is None:
            return np.eye(4, dtype=np.float32)
        return self.poses[idx]

    def set_RT(self, idx: int, pose: np.ndarray):
        self.poses[idx] = pose.astype(np.float32)

    def fresh_adam(self):
        """training_setup semantics: the reference recreates Adam, so the
        moments reset."""
        self.opt = adam_lib.init(self.state.params())


class HTGaussianTrainer(GaussianTrainer):
    def __init__(self, data_path, model_cfg, pipe_cfg, optim_cfg, seed=0,
                 device="cuda"):
        super().__init__(data_path, model_cfg, pipe_cfg, optim_cfg,
                         device=device)
        self.train_level = pipe_cfg.train_level
        self.seed = seed
        self.rng = random.Random(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.pose_dict: Dict[str, np.ndarray] = {}
        self.just_reset = False
        self.global_iteration = 0
        self.near = 0.01
        self.n_capacity_grows = 0
        # mutated schedule copy (hierarchical_training derives its own)
        self.sched = dataclasses.replace(optim_cfg)
        self._mode = pipe_cfg.render_mode
        self._tile_args = None  # auto-grown on overflow diagnostics
        ta = {}
        if getattr(pipe_cfg, "tile_max_per_tile", 0):
            ta["max_per_tile"] = int(pipe_cfg.tile_max_per_tile)
        if getattr(pipe_cfg, "tile_dup_factor", 0):
            ta["dup_factor"] = int(pipe_cfg.tile_dup_factor)
        if ta:
            self._tile_args = tuple(sorted(ta.items()))
        self._steps_since_tune = 0
        self.timer = PhaseTimer()
        self.rank, self.world = mesh_lib.rank(), mesh_lib.world_size()

    # ------------------------------------------------------------------ #
    # model construction
    def make_model(self, pcd: PointCloud,
                   capacity: Optional[int] = None) -> ModelBundle:
        radius = float(np.linalg.norm(pcd.points, axis=1).max())
        presize = max(1.0, getattr(self.pipe_cfg, "capacity_presize", 1.0))
        cap = capacity or _round_capacity(int(len(pcd.points) * 1.5
                                              * presize))
        state = G.create_from_pcd(
            pcd.points, pcd.colors, cap,
            max_sh_degree=self.model_cfg.sh_degree,
            view_dependent=self.model_cfg.view_dependent,
            device=self.device)
        return ModelBundle(state=state, opt=adam_lib.init(state.params()),
                           radius=radius, spatial_scale=radius)

    def _split_noise(self, cap: int):
        """The two [cap, 3] standard normals of densify's split children."""
        return tuple(torch.randn((cap, 3), generator=self.gen,
                                 device=self.device) for _ in range(2))

    @traced("lrs")
    def _lrs(self, iteration: int, bundle: ModelBundle,
             fix_feat: bool = False) -> Dict[str, float]:
        o = self.sched
        feat = 0.0 if fix_feat else 1.0
        return {
            "means": adam_lib.expon_lr(
                iteration, o.position_lr_init * bundle.spatial_scale,
                o.position_lr_final * bundle.spatial_scale,
                max_steps=o.position_lr_max_steps),
            "sh_dc": o.feature_lr * feat,
            "sh_rest": o.feature_lr / 20.0 * feat,
            "opacity_logit": o.opacity_lr * feat,
            "log_scales": o.scaling_lr * feat,
            "quats": o.rotation_lr * feat,
        }

    # ------------------------------------------------------------------ #
    # the host-side inner iteration
    def host_train_step(self, bundle: ModelBundle, camera, gt_image,
                        iteration: int, *, densify=True, reset=True,
                        sched=None, densification_interval=None,
                        depth_gt=None, fix_feat=False):
        """gt_image and depth_gt: tensors on the trainer's device."""
        o = sched or self.sched
        interval = densification_interval or o.densification_interval

        in_densify_window = densify and iteration < o.densify_until_iter
        do_densify = (in_densify_window and iteration > o.densify_from_iter
                      and iteration % interval == 0)
        do_reset = (in_densify_window and reset
                    and iteration % o.opacity_reset_interval == 0
                    and iteration < o.reset_until_iter)
        apply_adam = "skip" if do_densify else (
            "no_opacity" if do_reset else "all")

        bundle.state, bundle.opt, metrics = step_lib.gaussian_train_step(
            bundle.state, bundle.opt, camera, gt_image,
            self._lrs(iteration, bundle, fix_feat=fix_feat),
            depth_gt=depth_gt, mode=self._mode, apply_adam=apply_adam,
            track_stats=in_densify_window, lambda_dssim=o.lambda_dssim,
            lambda_depth=o.lambda_depth if depth_gt is not None else 0.0,
            tile_args=self._tile_args)

        # auto-grow the tile capacity that the renderer reports exhausted,
        # read every 50 steps (reading the counters syncs the device)
        self._steps_since_tune += 1
        if self._mode in ("tiled", "pallas", "auto") \
                and self._steps_since_tune >= 50:
            self._steps_since_tune = 0
            self._tune_tile_args(metrics)

        if do_densify:
            use_screen = iteration > o.opacity_reset_interval
            with span("densify"):
                bundle.state, bundle.opt, dropped = \
                    step_lib.densify_and_prune(
                        bundle.state, bundle.opt,
                        self._split_noise(bundle.state.capacity),
                        o.densify_grad_threshold, 0.005, bundle.radius,
                        o.percent_dense, 20.0, use_screen)
                if int(dropped) > 0:
                    self._grow_capacity(bundle)
        if do_reset:
            with span("reset"):
                bundle.state, bundle.opt = step_lib.reset_opacity(
                    bundle.state, bundle.opt)
            self.just_reset = True
        return metrics

    @traced("tune")
    def _tune_tile_args(self, metrics):
        """Grow the tile capacity that a step's counters report exhausted
        (reading them syncs the device)."""
        nd_m = int(metrics["n_dropped_m"])
        nd_tile = int(metrics["n_dropped_tile"])
        if nd_m > 0 or nd_tile > 0:
            ta = dict(self._tile_args or {})
            if nd_tile > 0:
                ta["max_per_tile"] = min(
                    2 * ta.get("max_per_tile", 1024), 4096)
            if nd_m > 0:
                ta["dup_factor"] = min(2 * ta.get("dup_factor", 16), 64)
            new_args = tuple(sorted(ta.items()))
            if new_args != self._tile_args:   # silent once saturated
                self._tile_args = new_args
                self.logger.info(f"tile capacity grown: {ta}")

    def _grow_capacity(self, bundle: ModelBundle):
        """Double the capacity. HT3DGS_MAX_CAPACITY (env) clamps it: past
        the clamp, densify overflow drops new Gaussians instead. An env knob
        rather than config, so a clamped relaunch keeps the breadcrumbs'
        config fingerprint."""
        st = bundle.state
        cap = st.capacity
        max_cap = int(os.environ.get("HT3DGS_MAX_CAPACITY", "0"))
        if max_cap and 2 * cap > max_cap:
            self.logger.warning(
                f"capacity growth {cap} -> {2 * cap} clamped by "
                f"HT3DGS_MAX_CAPACITY={max_cap}; densify overflow will "
                f"drop new Gaussians")
            return
        bundle.state, bundle.opt = pad_rows(st, bundle.opt, cap)
        self.n_capacity_grows += 1
        self.logger.info(f"capacity grown {cap} -> {2 * cap} "
                         f"(growth #{self.n_capacity_grows})")

    # ------------------------------------------------------------------ #
    # Phase A primitives
    def fit_single_image(self, bundle: ModelBundle, idx: int,
                         iterations: int, early_stop: bool = True,
                         depth_gt=None):
        """Fit a model to one frame through a fixed identity camera, densify
        off."""
        cam = self.camera_for(idx)
        gt = self.device_frame("rgb", idx)
        bundle.fresh_adam()
        psnr = 0.0
        stop_after = min(500, iterations // 2)
        for it in range(1, iterations + 1):
            m = self.host_train_step(bundle, cam, gt, it, densify=False,
                                     depth_gt=depth_gt)
            # reading the metric syncs the device; poll the early stop
            # sparsely so steps stay enqueued ahead of the host
            if it % 25 == 0 or it == iterations:
                psnr = float(m["psnr"])
                if early_stop and psnr > 35.0 and it > stop_after:
                    break
            if it % 100 == 0:
                self.logger.info(
                    f"[fit_single {idx}] it {it} psnr {psnr:.2f} "
                    f"n={int(bundle.state.n_live())}")
        return psnr

    def fit_single_image_vfi(self, bundle: ModelBundle, idx: int,
                             iterations: int):
        cam = self.camera_for(idx)
        gt = self.device_frame("vfi", idx)
        bundle.fresh_adam()
        stop_after = min(500, iterations // 2)
        for it in range(1, iterations + 1):
            m = self.host_train_step(bundle, cam, gt, it, densify=False)
            if (it % 25 == 0 and float(m["psnr"]) > 35.0
                    and it > stop_after):
                break

    def _pose_fitter(self):
        """batched_pose_fit, or its coarse-to-fine wrapper when
        pipe.pose_c2f is set."""
        if getattr(self.pipe_cfg, "pose_c2f", False):
            return pa.batched_pose_fit_c2f
        return pa.batched_pose_fit

    def _pose_lr(self) -> float:
        o = self.sched
        return o.rotation_lr if o.pose_lr is None else o.pose_lr

    def _identity_bases(self, n: int) -> torch.Tensor:
        return se3.se3_identity((n,), device=self.device)

    def _rel_matrices(self, deltas: torch.Tensor) -> np.ndarray:
        """[B, 6] tangents -> [B, 4, 4] w2c relative poses (float32)."""
        return _np(se3.se3_to_matrix(se3.se3_exp(deltas))).astype(np.float32)

    def fit_relative_pose(self, bundle: ModelBundle, gt_image,
                          camera, iterations: int = 300) -> np.ndarray:
        """Optimize only an SE(3) tangent against frozen Gaussians.
        Returns the w2c 4x4."""
        deltas = self._pose_fitter()(
            [bundle.state], self._identity_bases(1), [camera],
            gt_image[None], self._pose_lr(), mode=self._mode,
            tile_args=self._tile_args, lambda_dssim=self.sched.lambda_dssim,
            n_iters=iterations)
        return self._rel_matrices(deltas)[0]

    def compute_relative_pose(self, view_idx: int, view_idx_prev: int):
        """Pose of frame `view_idx` w.r.t. `view_idx_prev`. With
        train_pose_mode='vfi', two half-steps through the interpolated frame
        are composed."""
        key = f"rel_pose_{view_idx_prev}_to_{view_idx}"
        if key in self.pose_dict:
            return
        use_vfi = (self.pipe_cfg.train_pose_mode == "vfi"
                   and self.vfi_provider is not None)

        local = self.make_model(self.prepare_pcd(view_idx_prev))
        self.logger.info(f"[Phase A] fit frame {view_idx_prev}")
        self.fit_single_image(local, view_idx_prev,
                              self.sched.phase_a_fit_iters)

        cam_ref = self.camera_for(view_idx)
        gt_ref = self.device_frame("rgb", view_idx)
        if not use_vfi:
            self.pose_dict[key] = self.fit_relative_pose(
                local, gt_ref, cam_ref, self.sched.phase_a_pose_iters)
            self._save_partial_poses()
            return

        local_vfi = self.make_model(
            self.prepare_pcd(view_idx_prev, use_vfi_frame=True))
        self.logger.info(f"[Phase A] fit frame {view_idx_prev}+0.5 (VFI)")
        self.fit_single_image_vfi(local_vfi, view_idx_prev,
                                  self.sched.phase_a_fit_iters)
        rel1 = self.fit_relative_pose(
            local, self.device_frame("vfi", view_idx_prev),
            self.camera_for(view_idx_prev), self.sched.phase_a_pose_iters)
        rel2 = self.fit_relative_pose(local_vfi, gt_ref, cam_ref,
                                      self.sched.phase_a_pose_iters)
        self.pose_dict[f"rel_pose_{view_idx_prev}_to_{view_idx_prev}.5"] = \
            rel1
        self.pose_dict[f"rel_pose_{view_idx_prev}.5_to_{view_idx}"] = rel2
        self.pose_dict[key] = rel2 @ rel1
        self._save_partial_poses()

    # ------------------------------------------------------------------ #
    # Phase A, batched
    def _batched_fit(self, bundles: List[ModelBundle], cams, gts):
        o = self.sched
        lr_args = (
            [o.position_lr_init * b.spatial_scale for b in bundles],
            [o.position_lr_final * b.spatial_scale for b in bundles],
            o.position_lr_max_steps,
            {k: [lr] * len(bundles) for k, lr in (
                ("sh_dc", o.feature_lr), ("sh_rest", o.feature_lr / 20.0),
                ("opacity_logit", o.opacity_lr),
                ("log_scales", o.scaling_lr), ("quats", o.rotation_lr))})
        states, _ = pa.batched_fit(
            [b.state for b in bundles], [b.opt for b in bundles], cams, gts,
            lr_args, mode=self._mode, tile_args=self._tile_args,
            lambda_dssim=o.lambda_dssim, n_iters=o.phase_a_fit_iters)
        return states

    def _batched_pose(self, states, cams, gts) -> np.ndarray:
        deltas = self._pose_fitter()(
            states, self._identity_bases(len(states)), cams,
            torch.stack(gts), self._pose_lr(), mode=self._mode,
            tile_args=self._tile_args, lambda_dssim=self.sched.lambda_dssim,
            n_iters=self.sched.phase_a_pose_iters)
        return self._rel_matrices(deltas)

    def compute_relative_poses_batched(self):
        """Phase A in chunks of phase_a_batch pairs, each chunk's fits and
        pose fits one batched step per iteration (train.phase_a). Every
        chunk's models share one capacity, so they stack, and their binning
        capacities (M) match the JAX trainer's. With several ranks the
        models of each chunk are dealt over them (model k to rank k mod
        world): each rank stacks and fits its own, and the poses are
        gathered to every rank. The fits are independent, so
        the poses are a one-process run's."""
        B = self.pipe_cfg.phase_a_batch
        pairs = [(f, f - 1) for f in range(1, self.seq_len)
                 if f"rel_pose_{f - 1}_to_{f}" not in self.pose_dict]
        if not pairs or B <= 0:
            return
        use_vfi = (self.pipe_cfg.train_pose_mode == "vfi"
                   and self.vfi_provider is not None)
        self.logger.info(f"[Phase A/batched] {len(pairs)} pairs, batch {B}, "
                         f"{self.world} ranks")

        def mine(chunk):
            return [p for k, p in enumerate(chunk)
                    if k % self.world == self.rank]

        own = [p for i0 in range(0, len(pairs), B)
               for p in mine(pairs[i0:i0 + B])]
        all_pcds = {prev: self.prepare_pcd(prev) for (_, prev) in own}
        all_vfi_pcds = {}
        if use_vfi:
            all_vfi_pcds = {prev: self.prepare_pcd(prev, use_vfi_frame=True)
                            for (_, prev) in own}
        need = max([_round_capacity(int(len(p.points) * 1.5))
                    for p in list(all_pcds.values())
                    + list(all_vfi_pcds.values())] or [0])
        world_axis = comm.Axis(mesh_lib.world_group(), self.rank, self.world)
        cap = int(world_axis.all_reduce_(torch.tensor(
            [float(need)], device=self.device), "max")[0])

        for i0 in range(0, len(pairs), B):
            chunk = pairs[i0:i0 + B]
            sub = mine(chunk)
            # [pair, (rel, half-step 1, half-step 2)], each pair's row
            # written by the rank that fitted it
            rels = np.zeros((len(chunk), 3, 4, 4), np.float32)
            if sub:
                rows = [k for k in range(len(chunk))
                        if k % self.world == self.rank]
                rels[rows] = self._fit_pairs(sub, cap, all_pcds,
                                             all_vfi_pcds, use_vfi)
            if self.world > 1:
                rels = world_axis.all_reduce_(torch.as_tensor(
                    rels, device=self.device)).cpu().numpy()
            self.logger.info(f"[Phase A/batched] fitted pairs {chunk}")
            for (f, prev), r in zip(chunk, rels):
                self.pose_dict[f"rel_pose_{prev}_to_{f}"] = r[0]
                if use_vfi:
                    self.pose_dict[f"rel_pose_{prev}_to_{prev}.5"] = r[1]
                    self.pose_dict[f"rel_pose_{prev}.5_to_{f}"] = r[2]
            self._save_partial_poses()

        # a non-finite batched result is refitted by the sequential path
        for (f, prev) in pairs:
            keys = [k for k in (f"rel_pose_{prev}_to_{f}",
                                f"rel_pose_{prev}_to_{prev}.5",
                                f"rel_pose_{prev}.5_to_{f}")
                    if k in self.pose_dict]
            if any(not np.all(np.isfinite(self.pose_dict[k])) for k in keys):
                self.logger.warning(
                    f"[Phase A/batched] non-finite result for pair "
                    f"({prev}->{f}); falling back to sequential fit")
                for k in keys:
                    self.pose_dict.pop(k, None)

    def _fit_pairs(self, pairs, cap, all_pcds, all_vfi_pcds, use_vfi):
        """[len(pairs), 3, 4, 4]: each pair's relative pose and, with VFI,
        its two half-steps (zeros without)."""
        out = np.zeros((len(pairs), 3, 4, 4), np.float32)
        cams = [self.camera_for(prev) for (_, prev) in pairs]
        cams_ref = [self.camera_for(f) for (f, _) in pairs]
        gts_ref = [self.device_frame("rgb", f) for (f, _) in pairs]
        states = self._batched_fit(
            [self.make_model(all_pcds[prev], capacity=cap)
             for (_, prev) in pairs], cams,
            [self.device_frame("rgb", prev) for (_, prev) in pairs])
        if not use_vfi:
            out[:, 0] = self._batched_pose(states, cams_ref, gts_ref)
            return out
        # VFI: fit a second set of local models to the midway frames, then
        # compose the two half-step poses
        gts_v = [self.device_frame("vfi", prev) for (_, prev) in pairs]
        states_v = self._batched_fit(
            [self.make_model(all_vfi_pcds[prev], capacity=cap)
             for (_, prev) in pairs], cams, gts_v)
        # half-step 1: base model -> VFI frame; 2: VFI model -> frame f
        out[:, 1] = self._batched_pose(states, cams, gts_v)
        out[:, 2] = self._batched_pose(states_v, cams_ref, gts_ref)
        for r in out:
            r[0] = r[2] @ r[1]
        return out

    # ------------------------------------------------------------------ #
    # partition
    def partition(self, n: int, level: int, overlap: int = 2):
        if self.pipe_cfg.partition_strategy == "v1" and level > 0:
            diffs = []
            for idx in range(n - 1):
                rel = self.pose_dict[f"rel_pose_{idx}_to_{idx + 1}"]
                diffs.append((self._pose_size(rel), idx))
            num_segment = 2 ** level
            len_segment = n // num_segment
            len_sub = n // (num_segment * 4)
            key_indices = []
            for i in range(num_segment - 1):
                idx = (i + 1) * len_segment
                window = diffs[max(0, idx - len_sub):idx + len_sub + 1]
                key_indices.append(sorted(window)[-1][1])
            result = {}
            for lv in range(level, -1, -1):
                result[lv] = []
                if lv == level:
                    prev = 0
                    for k in key_indices:
                        result[lv].append(list(range(prev, k + 1 + overlap)))
                        prev = k + 1
                    result[lv].append(list(range(prev, n)))
                else:
                    for i in range(0, len(result[lv + 1]), 2):
                        l1 = result[lv + 1][i]
                        l2 = result[lv + 1][i + 1]
                        result[lv].append(sorted(set(l1 + l2)))
            if result[0][0] != list(range(n)):
                raise RuntimeError(f"partition misses frames: {result}")
            return result
        # 'even': recursive halving with 1-frame overlap
        result = {0: [list(range(n))]}
        for lv in range(1, level + 1):
            result[lv] = []
            for ind in result[lv - 1]:
                h = len(ind) // 2
                result[lv].append(ind[:h + 1])
                result[lv].append(ind[h - 1:])
        return result

    @staticmethod
    def _pose_size(pose: np.ndarray) -> float:
        t = float(np.linalg.norm(pose[:3, 3]))
        tr = float(np.trace(pose[:3, :3]))
        ang = float(np.arccos(np.clip((tr - 1) / 2, -1.0, 1.0)))
        return t + ang

    # ------------------------------------------------------------------ #
    # leaf / non-leaf training loops
    def sample_training_frame(self, visited: List[int]) -> int:
        """70% bias to the recent half of the visited frames."""
        last = max(1, len(visited) // 2)
        if self.rng.random() < 0.7:
            i = self.rng.randint(last, len(visited) - 1)
        else:
            i = self.rng.randint(1, last)
        return visited[i]

    @traced("frame")
    def _frame_camera_gt(self, bundle: ModelBundle, fidx: int,
                         use_vfi: bool):
        """(camera, gt) of one iteration: the frame, or the VFI midway
        frame at its half-step pose (MSS phase 2). Without a recorded
        half-step pose the frame itself is used."""
        pose = bundle.get_RT(fidx)
        half = (self.pose_dict.get(f"rel_pose_{fidx}_to_{fidx}.5")
                if use_vfi else None)
        if half is None:
            return (self.camera_for(fidx, pose=pose),
                    self.device_frame("rgb", fidx))
        return (self.camera_for(fidx, pose=half @ pose),
                self.device_frame("vfi", fidx))

    def _after_step(self, bundle: ModelBundle):
        if self.global_iteration % 1000 == 0:
            bundle.state = G.oneup_sh_degree(bundle.state)

    def train_leaf(self, bundle: ModelBundle, view_idx: int,
                   view_idx_prev: int, visited: List[int]):
        o = self.sched
        use_vfi_mss = ("vfi" in self.pipe_cfg.multi_source_supervision
                       and self.vfi_provider is not None)

        if self.just_reset:
            self.just_reset = False
            for _ in range(1, self.sched.reset_recovery_iters):
                fidx = self.rng.randint(0, view_idx_prev)
                self.global_iteration += 1
                with span("iteration", step=self.global_iteration):
                    cam, gt = self._frame_camera_gt(bundle, fidx, False)
                    self.host_train_step(
                        bundle, cam, gt, self.global_iteration,
                        densification_interval=o.densification_interval_leaf)

        for it in range(1, o.single_step + 1):
            fidx = self.sample_training_frame(visited)
            self.global_iteration += 1
            with span("iteration", step=self.global_iteration):
                use_vfi = (use_vfi_mss and fidx + 1 < self.seq_len
                           and self.rng.random() < o.mss_phase2_ratio)
                cam, gt = self._frame_camera_gt(bundle, fidx, use_vfi)
                m = self.host_train_step(
                    bundle, cam, gt, self.global_iteration,
                    densification_interval=o.densification_interval_leaf)
                self._after_step(bundle)
            if it % 100 == 0:
                self.logger.info(
                    f"[leaf] git {self.global_iteration} it {it} "
                    f"psnr {float(m['psnr']):.2f} "
                    f"n={int(bundle.state.n_live())}")

    def train_nonleaf_phase2(self, bundle: ModelBundle, indices: List[int],
                             num_iterations: int):
        """Replay all segment frames + VFI."""
        s = self.sched
        o = dataclasses.replace(
            s, densification_interval=s.mss_phase2_densification_interval)
        if s.mss_phase2_densify_until_iter_ratio is not None:
            o.densify_until_iter = int(
                num_iterations * s.mss_phase2_densify_until_iter_ratio)
        use_vfi_mss = ("vfi" in self.pipe_cfg.multi_source_supervision
                       and self.vfi_provider is not None)
        for it in range(1, num_iterations + 1):
            fidx = self.rng.choice(indices)
            self.global_iteration += 1
            with span("iteration", step=self.global_iteration):
                use_vfi = (use_vfi_mss and fidx + 1 < self.seq_len
                           and self.rng.random() < o.mss_phase2_ratio)
                cam, gt = self._frame_camera_gt(bundle, fidx, use_vfi)
                m = self.host_train_step(bundle, cam, gt,
                                         self.global_iteration, sched=o)
                self._after_step(bundle)
            if it % 100 == 0:
                self.logger.info(
                    f"[nonleaf p2] git {self.global_iteration} it {it} "
                    f"psnr {float(m['psnr']):.2f} "
                    f"n={int(bundle.state.n_live())}")

    def train_nonleaf_phase1(self, bundle: ModelBundle,
                             children: List[ModelBundle],
                             num_iterations: Optional[int] = None):
        """Pseudo-views rendered by the frozen children at SE(3)-
        interpolated poses (MSS phase 1). The phase is
        mss_phase1_iteration_per_frame steps a frame of the children;
        num_iterations bounds one call to that many steps (the densify
        window's ratio is still taken over the whole phase)."""
        indices = sorted({f for c in children for f in c.to_visit_frames})
        o = dataclasses.replace(self.sched)
        if self.sched.mss_phase1_densification_interval is not None:
            o.densification_interval = \
                self.sched.mss_phase1_densification_interval
        phase_len = self.sched.mss_phase1_iteration_per_frame * len(indices)
        ratio = self.sched.mss_phase1_densify_until_iter_ratio
        if ratio is not None:
            o.densify_until_iter = int(phase_len * ratio)
        if num_iterations is None:
            num_iterations = phase_len

        for it in range(1, num_iterations + 1):
            fidx = self.rng.choice(indices)
            self.global_iteration += 1
            with span("iteration", step=self.global_iteration):
                if self.rng.random() < self.sched.mss_phase1_ratio:
                    cam, gt = self._pseudo_view(bundle, children, indices,
                                                fidx)
                else:
                    cam, gt = self._frame_camera_gt(bundle, fidx, False)
                m = self.host_train_step(bundle, cam, gt,
                                         self.global_iteration, sched=o)
                self._after_step(bundle)
            if it % 100 == 0:
                self.logger.info(
                    f"[nonleaf p1] git {self.global_iteration} it {it} "
                    f"psnr {float(m['psnr']):.2f}")

    @traced("frame")
    def _pseudo_view(self, bundle: ModelBundle, children: List[ModelBundle],
                     indices: List[int], fidx: int):
        """(camera, gt) of a pseudo-view: the frozen child that covers
        frame fidx rendered at a pose SE(3)-interpolated between fidx and
        the next frame (the last frame steps back one)."""
        alpha = self.rng.random()
        if fidx == indices[-1]:
            fidx -= 1
        # small pose algebra on the host's CPU, no device round trip
        p0, p1 = (se3.se3_from_matrix(torch.from_numpy(
            np.asarray(bundle.get_RT(i), np.float32)))
            for i in (fidx, fidx + 1))
        pose_i = se3.se3_to_matrix(
            se3.se3_interp(p0, p1, alpha)).numpy().astype(np.float32)
        child = None
        for c in children[::-1]:
            if fidx >= c.start_fidx and fidx in c.to_visit_frames:
                child = c
                break
        if child is None:
            raise ValueError(f"no child covers frame {fidx}")
        pose_wrt_child = pose_i @ np.linalg.inv(
            bundle.get_RT(child.start_fidx))
        with span("pseudo"):
            out = step_lib.render_eval(
                child.state, self.camera_for(0, pose=pose_wrt_child),
                mode=self._mode, tile_args=self._tile_args)
        count("pseudo_views", 1)
        count("pseudo_rows", child.state.live)
        count("pseudo_dropped_k", out.get("n_dropped_tile", 0))
        return self.camera_for(0, pose=pose_i), out["image"]

    # ------------------------------------------------------------------ #
    # merge
    def calc_importance(self, bundle: ModelBundle,
                        frame_indices: List[int]) -> torch.Tensor:
        """Colour importance: sum over the frames of |d sum(image) / d SH|,
        over the pixel count, max over coefficients. [cap] on the device."""
        from ..raster import render

        st = bundle.state
        acc_dc = torch.zeros_like(st.sh_dc)
        acc_rest = torch.zeros_like(st.sh_rest)
        n_pix = 0
        for fidx in frame_indices:
            cam = self.camera_for(fidx, pose=bundle.get_RT(fidx))
            sh_dc = st.sh_dc.detach().requires_grad_(True)
            sh_rest = st.sh_rest.detach().requires_grad_(True)
            out = render(dataclasses.replace(st, sh_dc=sh_dc,
                                             sh_rest=sh_rest),
                         cam, mode=self._mode, tile_args=self._tile_args)
            g_dc, g_rest = torch.autograd.grad(out["image"].sum(),
                                               [sh_dc, sh_rest])
            acc_dc += g_dc.abs()
            acc_rest += g_rest.abs()
            n_pix += cam.height * cam.width
        n = acc_dc.shape[0]
        imp = torch.cat([acc_dc.reshape(n, -1), acc_rest.reshape(n, -1)],
                        dim=1) / n_pix
        return imp.amax(dim=1)

    def merge_two(self, dst: ModelBundle, src: ModelBundle,
                  transform: np.ndarray):
        """Importance-prune both, SE(3)-transform src into dst's frame,
        concatenate the live rows on the host; a fresh Adam afterwards (the
        reference recreates the optimizer after a merge)."""
        ratio = self.pipe_cfg.prune_ratio
        self.logger.info(
            f"[merge] dst n={int(dst.state.n_live())} "
            f"src n={int(src.state.n_live())}")
        imp_dst = self.calc_importance(dst, dst.to_visit_frames)
        dst.state, dst.opt = step_lib.jit_importance_prune(
            dst.state, dst.opt, imp_dst, ratio)
        imp_src = self.calc_importance(src, src.to_visit_frames)
        src_state, _ = step_lib.jit_importance_prune(
            src.state, src.opt, imp_src, ratio)

        dstd = {f: _np(getattr(dst.state, f)) for f in G.PARAM_FIELDS}
        srcd = {f: _np(getattr(src_state, f)) for f in G.PARAM_FIELDS}
        live_d = _np(dst.state.live)
        live_s = _np(src_state.live)

        pts = srcd["means"][live_s]
        hom = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=1)
        aligned = hom @ transform.T.astype(np.float32)
        srcd["means"] = np.zeros_like(srcd["means"])
        srcd["means"][live_s] = aligned[:, :3] / aligned[:, 3:4]

        n_total = int(live_d.sum() + live_s.sum())
        cap = _round_capacity(int(n_total * 1.5))
        merged = {}
        for f in G.PARAM_FIELDS:
            rows = np.concatenate([dstd[f][live_d], srcd[f][live_s]], axis=0)
            out = np.zeros((cap,) + rows.shape[1:], rows.dtype)
            out[:n_total] = rows
            merged[f] = torch.as_tensor(out, device=self.device)
        live = np.zeros(cap, bool)
        live[:n_total] = True
        zeros = torch.zeros(cap, device=self.device)
        dst.state = dataclasses.replace(
            dst.state, **merged,
            live=torch.as_tensor(live, device=self.device),
            max_radii2d=zeros, grad_accum=zeros.clone(),
            grad_denom=zeros.clone())
        dst.fresh_adam()
        dst.radius = max(dst.radius, src.radius)
        self.logger.info(f"[merge] merged n={n_total} cap={cap}")

    # ------------------------------------------------------------------ #
    # the schedule and the top-level loop
    def derive_schedule(self):
        o = self.sched
        o.single_step = self.optim_cfg.single_step
        num_iterations = o.single_step * (self.seq_len // 10) * 10
        o.iterations = num_iterations
        o.position_lr_max_steps = num_iterations
        o.opacity_reset_interval = (
            max(num_iterations // 10, 1)
            if o.opacity_reset_interval_override is None
            else o.opacity_reset_interval_override)
        o.densify_until_iter = num_iterations
        o.reset_until_iter = int(num_iterations * 0.8)
        o.densify_from_iter = o.single_step

    def _resume_poses(self):
        """Read pipe.load_pose, else Phase A's partial poses, on rank 0;
        every rank takes rank 0's pose dict, empty or not."""
        def read():
            load = self.pipe_cfg.load_pose
            if load and os.path.exists(load):
                self.load_pose_dict(load)
                self.logger.info(f"loaded poses from {load}")
            # crash resume: Phase A persists its pose dict after every chunk
            partial = f"{self.result_path}/pose/pose_partial.npz"
            if not self.pose_dict and os.path.exists(partial):
                self.load_pose_dict(partial)
                self.logger.info(
                    f"resumed {len(self.pose_dict)} poses from {partial}")

        self._on_rank0(read)

    def _phase_a(self):
        if getattr(self.pipe_cfg, "phase_a_batch", 0) > 0:
            self.compute_relative_poses_batched()

        def sequential():
            for fidx in range(1, self.seq_len):
                self.compute_relative_pose(fidx, fidx - 1)

        self._on_rank0(sequential)

    def _mesh_ranks(self, S: int, n_tiles: int) -> bool:
        """Whether the world holds an S x T mesh (the JAX trainer's
        len(jax.devices()) >= S * T); logs the path taken."""
        ok = self.world >= S * n_tiles
        self.logger.info(
            f"[mesh] {S} x {n_tiles} on {self.world} ranks: "
            + ("mesh path" if ok else "sequential path"))
        return ok

    def hierarchical_training(self):
        self.derive_schedule()
        os.makedirs(f"{self.result_path}/chkpnt", exist_ok=True)
        os.makedirs(f"{self.result_path}/pose", exist_ok=True)
        self._resume_poses()

        with self.timer.phase("phase_a"):
            self._phase_a()

        lists = self.partition(self.seq_len, self.train_level)
        self.logger.info(f"partition: {lists}")
        # crumbs of one (config, partition, seed) must not resume another
        self._crumb_fp = self._config_fingerprint(lists)

        use_base = "base" in self.pipe_cfg.multi_source_supervision
        bundles: Dict[int, List[Optional[ModelBundle]]] = {
            lv: [None] * len(lists[lv]) for lv in lists}

        # several ranks: leaf segments train on the (segment, tile) mesh in
        # chunks of mesh_segments (leftovers run sequentially)
        S = max(1, self.pipe_cfg.mesh_segments)
        n_tiles = max(1, self.pipe_cfg.mesh_tiles)
        multi = S > 1 or n_tiles > 1
        leaf_lists = lists[self.train_level]
        if multi and self._mesh_ranks(S, n_tiles):
            from . import parallel_leaves as pl

            for i0 in range(0, len(leaf_lists) - (len(leaf_lists) % S), S):
                chunk = leaf_lists[i0:i0 + S]
                tags = [f"lv{self.train_level}_seg{i0 + k}"
                        for k in range(len(chunk))]
                crumbs = [self._load_bundle_breadcrumb(t) for t in tags]
                if all(c is not None for c in crumbs):
                    for k, b in enumerate(crumbs):
                        bundles[self.train_level][i0 + k] = b
                    self._commit_crumb_rng(crumbs[-1])
                    continue
                mesh = mesh_lib.make_mesh(S, n_tiles)
                with self.timer.phase("leaf_parallel"):
                    trained = pl.train_leaf_segments_parallel(self, chunk,
                                                              mesh)
                for k, b in enumerate(trained):
                    bundles[self.train_level][i0 + k] = b
                    self._save_bundle_breadcrumb(b, tags[k])

        for level in range(self.train_level, -1, -1):
            seg_lists = lists[level]

            # sibling non-leaf segments are data-independent until their
            # own merge: chunks of Sp of them run phase 1/2 at once (Sp = 1
            # still splits the root's image rows over the tile ranks)
            nonleaf_pretrained = set()
            if level < self.train_level and multi:
                from . import parallel_nonleaf as pnl

                Sp = min(S, len(seg_lists))
                if self._mesh_ranks(Sp, n_tiles):
                    for i0 in range(0, len(seg_lists)
                                    - (len(seg_lists) % Sp), Sp):
                        idxs = list(range(i0, i0 + Sp))
                        tags = [f"lv{level}_seg{i}" for i in idxs]
                        crumbs = [self._load_bundle_breadcrumb(t)
                                  for t in tags]
                        if all(c is not None for c in crumbs):
                            for i, c in zip(idxs, crumbs):
                                bundles[level][i] = c
                            self._commit_crumb_rng(crumbs[-1])
                            nonleaf_pretrained.update(idxs)
                            continue
                        chunk = [bundles[level][i] for i in idxs]
                        kids = ([tuple(bundles[level + 1][2 * i: 2 * i + 2])
                                 for i in idxs] if use_base else None)
                        mesh = mesh_lib.make_mesh(Sp, n_tiles)
                        with self.timer.phase("nonleaf_parallel"):
                            pnl.train_nonleaf_segments_parallel(
                                self, chunk, [seg_lists[i] for i in idxs],
                                level, children_pairs=kids, mesh=mesh)
                        for i, t in zip(idxs, tags):
                            self._save_bundle_breadcrumb(bundles[level][i],
                                                         t)
                        nonleaf_pretrained.update(idxs)

            for seg_idx, frames in enumerate(seg_lists):
                self.logger.info(f"level {level} seg {seg_idx}: {frames}")
                tag = f"lv{level}_seg{seg_idx}"
                crumb = (None if seg_idx in nonleaf_pretrained
                         else self._load_bundle_breadcrumb(tag))
                if crumb is not None:
                    bundle = crumb
                    bundles[level][seg_idx] = bundle
                    self._commit_crumb_rng(bundle)
                    self.global_iteration = bundle.global_iteration
                elif level == self.train_level:
                    bundle = bundles[level][seg_idx]  # parallel-pre-trained
                    if bundle is None:
                        with self.timer.phase("leaf"):
                            bundle = self._share_bundle(self._on_rank0(
                                lambda: self._train_leaf_segment(frames)), 0)
                        bundles[level][seg_idx] = bundle
                        bundle.global_iteration = self.global_iteration
                        self._save_bundle_breadcrumb(bundle, tag)
                    else:
                        self.global_iteration = bundle.global_iteration
                elif seg_idx in nonleaf_pretrained:
                    bundle = bundles[level][seg_idx]  # parallel-pre-trained
                    self.global_iteration = bundle.global_iteration
                else:
                    bundle = bundles[level][seg_idx]  # restored from child

                    def train_nonleaf(bundle=bundle, level=level,
                                      seg_idx=seg_idx, frames=frames):
                        if use_base:
                            children = bundles[level + 1][seg_idx * 2:
                                                          seg_idx * 2 + 2]
                            self.global_iteration = bundle.global_iteration
                            with self.timer.phase("nonleaf_phase1"):
                                self.train_nonleaf_phase1(bundle, children)
                        n_it = self.sched.num_iterations_per_frame_each_level[
                            level] * len(frames)
                        with self.timer.phase("nonleaf_phase2"):
                            self.train_nonleaf_phase2(bundle, frames, n_it)
                        return bundle

                    bundle = self._share_bundle(
                        self._on_rank0(train_nonleaf), 0)
                    bundles[level][seg_idx] = bundle
                    bundle.global_iteration = self.global_iteration
                    self._save_bundle_breadcrumb(bundle, tag)
                bundle.global_iteration = self.global_iteration

                if (seg_idx + 1) % 2 == 0:
                    prev = bundles[level][seg_idx - 1]
                    # destination at level-1 restores the left sibling
                    dst = ModelBundle(
                        state=prev.state, opt=prev.opt, radius=prev.radius,
                        spatial_scale=prev.spatial_scale,
                        poses=prev.poses.copy(),
                        start_fidx=prev.start_fidx,
                        to_visit_frames=list(prev.to_visit_frames))
                    pose_between = dst.get_RT(bundle.start_fidx)

                    def merge(dst=dst, bundle=bundle,
                              transform=np.linalg.inv(pose_between)):
                        self.merge_two(dst, bundle, transform)
                        return dst

                    with self.timer.phase("merge"):
                        dst = self._share_bundle(self._on_rank0(merge), 0)
                    # chain poses for the newly covered frames
                    for pf in frames:
                        if pf in seg_lists[seg_idx - 1]:
                            continue
                        rel = self.pose_dict[f"rel_pose_{pf - 1}_to_{pf}"]
                        dst.set_RT(pf, rel @ dst.get_RT(pf - 1))
                    dst.global_iteration = 0
                    dst.to_visit_frames = sorted(
                        set(bundle.to_visit_frames + dst.to_visit_frames))
                    bundles[level - 1][(seg_idx - 1) // 2] = dst

        self.gs_bundle = bundles[0][0]

        # rank 0 deletes the crumbs of its own result_path only: no other
        # rank reads resume state from its disk
        def finish():
            with self.timer.phase("eval"):
                self.evaluate_on_training_images()
            self.save_checkpoint()
            # the run completed: stale crumbs must not leak into a rerun
            for f in glob.glob(f"{self.result_path}/chkpnt/crumb_*.npz"):
                os.remove(f)
            self.logger.info(f"phase timing: {self.timer.summary()}")
            self.logger.info(f"capacity growths: {self.n_capacity_grows}")
            self.timer.dump(os.path.join(self.result_path,
                                         "phase_timing.json"))

        self._on_rank0(finish)
        return self.gs_bundle

    # ------------------------------------------------------------------ #
    # several ranks: the section broadcasts
    def _bundle_arrays(self, bundle: ModelBundle, stats: bool = False
                       ) -> dict:
        """A bundle as numpy arrays: the breadcrumb layout (the JAX
        trainer's), and with `stats` its densify statistics too."""
        arrs = {f: _np(getattr(bundle.state, f)) for f in G.PARAM_FIELDS}
        arrs.update(
            live=_np(bundle.state.live),
            active_sh_degree=_np(bundle.state.active_sh_degree),
            max_sh_degree=np.asarray(bundle.state.max_sh_degree),
            poses=bundle.poses,
            radius=np.asarray(bundle.radius),
            spatial_scale=np.asarray(bundle.spatial_scale),
            global_iteration=np.asarray(bundle.global_iteration),
            start_fidx=np.asarray(bundle.start_fidx),
            to_visit=np.asarray(bundle.to_visit_frames, np.int32),
        )
        for f in G.PARAM_FIELDS:
            arrs[f"adam_m_{f}"] = _np(bundle.opt.m[f])
            arrs[f"adam_v_{f}"] = _np(bundle.opt.v[f])
        arrs["adam_step"] = _np(bundle.opt.step)
        if stats:
            for f in ("max_radii2d", "grad_accum", "grad_denom"):
                arrs[f] = _np(getattr(bundle.state, f))
        return arrs

    def _bundle_from_arrays(self, z) -> ModelBundle:
        dev = self.device
        n = z["live"].shape[0]
        stats = {f: (torch.as_tensor(z[f], device=dev) if f in z
                     else torch.zeros(n, device=dev))
                 for f in ("max_radii2d", "grad_accum", "grad_denom")}
        state = GaussianState(
            **{f: torch.as_tensor(z[f], device=dev) for f in G.PARAM_FIELDS},
            live=torch.as_tensor(z["live"], device=dev), **stats,
            active_sh_degree=torch.as_tensor(z["active_sh_degree"],
                                             device=dev),
            max_sh_degree=int(z["max_sh_degree"]))
        opt = interop.adam_from_numpy(
            {f: z[f"adam_m_{f}"] for f in G.PARAM_FIELDS},
            {f: z[f"adam_v_{f}"] for f in G.PARAM_FIELDS},
            z["adam_step"], dev)
        return ModelBundle(
            state=state, opt=opt, radius=float(z["radius"]),
            spatial_scale=float(z["spatial_scale"]), poses=z["poses"],
            global_iteration=int(z["global_iteration"]),
            start_fidx=int(z["start_fidx"]),
            to_visit_frames=[int(x) for x in z["to_visit"]])

    def _broadcast_npz(self, arrs: Optional[dict], src: int
                       ) -> Optional[dict]:
        """Rank `src`'s arrays on every rank; None where src passed None."""
        data = None
        if arrs is not None:
            buf = io.BytesIO()
            np.savez(buf, **arrs)
            data = buf.getvalue()
        data = comm.broadcast_bytes(data, src, self.device)
        if not data:
            return None
        with np.load(io.BytesIO(data)) as z:
            return dict(z)

    def _share_bundle(self, bundle: Optional[ModelBundle], src: int
                      ) -> ModelBundle:
        """Rank `src`'s bundle on every rank (its own object on src)."""
        if self.world == 1:
            return bundle
        z = self._broadcast_npz(self._bundle_arrays(bundle, stats=True)
                                if self.rank == src else None, src)
        return bundle if self.rank == src else self._bundle_from_arrays(z)

    def _share_trainer_state(self):
        """Rank 0's random streams, iteration count, tile arguments and
        poses on every rank."""
        if self.world == 1:
            return
        arrs = None
        if self.rank == 0:
            arrs = {f"pose__{k}": v for k, v in self.pose_dict.items()}
            arrs.update(
                py_rng_state=np.frombuffer(
                    pickle.dumps(self.rng.getstate()), np.uint8),
                torch_rng=self.gen.get_state().numpy(),
                counters=np.asarray([self.global_iteration,
                                     int(self.just_reset),
                                     self.n_capacity_grows,
                                     self._steps_since_tune]),
                tile_args=np.asarray(json.dumps(self._tile_args)))
        z = self._broadcast_npz(arrs, 0)
        if self.rank == 0:
            return
        self.pose_dict = {k[6:]: v for k, v in z.items()
                          if k.startswith("pose__")}
        # the bytes rank 0 of this run pickled
        self.rng.setstate(pickle.loads(z["py_rng_state"].tobytes()))
        self.gen.set_state(torch.from_numpy(z["torch_rng"]))
        (self.global_iteration, just_reset, self.n_capacity_grows,
         self._steps_since_tune) = (int(x) for x in z["counters"])
        self.just_reset = bool(just_reset)
        ta = json.loads(str(z["tile_args"]))
        self._tile_args = tuple(tuple(p) for p in ta) if ta else None

    def _share_segments(self, own: Optional[ModelBundle],
                        mesh: mesh_lib.Mesh, S: int) -> List[ModelBundle]:
        """The S segments' bundles on every rank, each from its segment's
        first rank, then rank 0's trainer state."""
        # ranks outside the mesh wait out the chunk here, with no time limit
        mesh_lib.wait_for_rank(0)
        out = [self._share_bundle(
            own if self.rank == mesh.root(s) else None, mesh.root(s))
            for s in range(S)]
        self._share_trainer_state()
        return out

    def _on_rank0(self, fn):
        """fn() on rank 0 alone, however long it takes; then every rank
        takes rank 0's trainer state. Returns fn's result on rank 0, None
        elsewhere."""
        out = fn() if self.rank == 0 else None
        # the others wait with no time limit, on the section group
        mesh_lib.wait_for_rank(0)
        self._share_trainer_state()
        return out

    def _config_fingerprint(self, lists) -> str:
        """Hash of everything that shapes a segment's training: optim +
        pipe config, partition, seq_len, seed (the JAX trainer's hash)."""
        payload = {
            "optim": {k: repr(v)
                      for k, v in sorted(vars(self.optim_cfg).items())},
            "pipe": {k: repr(v)
                     for k, v in sorted(vars(self.pipe_cfg).items())},
            "seq_len": self.seq_len,
            "seed": getattr(self, "seed", 0),
            "partition": repr(lists),
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]

    def _bundle_breadcrumb_path(self, tag: str) -> str:
        return f"{self.result_path}/chkpnt/crumb_{tag}.npz"

    def _save_bundle_breadcrumb(self, bundle: ModelBundle, tag: str):
        """Crash-resume breadcrumb of a finished sub-training (leaf or
        merged segment): the JAX layout, with the generator's state
        `torch_rng` in place of `jax_key`."""
        if self.rank == 0:
            self._write_breadcrumb(bundle, tag)
        # a large model's crumb takes a while to compress: the others wait
        # for it here, not in the main group's next collective
        mesh_lib.wait_for_rank(0)

    def _write_breadcrumb(self, bundle: ModelBundle, tag: str):
        path = self._bundle_breadcrumb_path(tag)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        arrs = self._bundle_arrays(bundle)
        arrs["config_fp"] = np.array(
            getattr(self, "_crumb_fp", ""), dtype="U16")
        arrs["py_rng_state"] = np.frombuffer(
            pickle.dumps(self.rng.getstate()), np.uint8)
        arrs["torch_rng"] = self.gen.get_state().numpy()
        np.savez_compressed(path + ".tmp.npz", **arrs)
        os.replace(path + ".tmp.npz", path)
        self.logger.info(f"breadcrumb -> {path}")

    def _read_breadcrumb(self, tag: str) -> Optional[dict]:
        """The crumb's arrays, or None if it is missing or was written for
        another configuration."""
        path = self._bundle_breadcrumb_path(tag)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            z = dict(z)
        saved_fp = str(z["config_fp"]) if "config_fp" in z else None
        if saved_fp != getattr(self, "_crumb_fp", ""):
            self.logger.warning(
                f"REFUSING breadcrumb {path}: config fingerprint "
                f"{saved_fp!r} != current "
                f"{getattr(self, '_crumb_fp', '')!r} — retraining this "
                "segment")
            return None
        self.logger.info(f"resumed breadcrumb {path}")
        return z

    def _load_bundle_breadcrumb(self, tag: str) -> Optional[ModelBundle]:
        """Rank 0's crumb `tag` (or None) on every rank: one collective
        with several ranks, so every rank makes its calls in one order."""
        z = self._read_breadcrumb(tag) if self.rank == 0 else None
        if self.world > 1:
            mesh_lib.wait_for_rank(0)
            z = self._broadcast_npz(z, 0)
        if z is None:
            return None
        b = self._bundle_from_arrays(z)
        # the RNG payload is applied only when a caller accepts the crumb
        # (_commit_crumb_rng), so a discarded load leaves the streams as
        # they are
        b._rng_payload = None
        if "py_rng_state" in z:
            b._rng_payload = (z["py_rng_state"].tobytes(), z.get("torch_rng"))
        return b

    def _commit_crumb_rng(self, bundle) -> None:
        """Apply the RNG streams saved in an accepted breadcrumb."""
        payload = getattr(bundle, "_rng_payload", None)
        if payload is not None:
            self.rng.setstate(pickle.loads(payload[0]))
            if payload[1] is not None:
                self.gen.set_state(torch.from_numpy(payload[1]))

    def _train_leaf_segment(self, frames: List[int]) -> ModelBundle:
        """Leaf: init on the first frame, then walk the segment chaining
        poses."""
        f0 = frames[0]
        bundle = self.make_model(self.prepare_pcd(f0))
        bundle.poses = np.tile(np.eye(4, dtype=np.float32),
                               (self.seq_len, 1, 1))
        bundle.start_fidx = f0
        bundle.to_visit_frames = frames
        self.global_iteration = 0
        self.just_reset = False

        self.logger.info(f"[leaf init] frame {f0}")
        self.fit_single_image(bundle, f0, self.sched.leaf_init_iters,
                              early_stop=False,
                              depth_gt=self.device_frame("depth", f0)
                              if self.sched.lambda_depth else None)
        bundle.fresh_adam()   # training_setup(fit_pose=True) recreates Adam

        visited = [f0]
        for fidx in frames[1:]:
            rel = self.pose_dict[f"rel_pose_{fidx - 1}_to_{fidx}"]
            bundle.set_RT(fidx, rel @ bundle.get_RT(fidx - 1))
            visited.append(fidx)
            self.train_leaf(bundle, fidx, fidx - 1, visited)
            psnr, _ = self.render_frame(bundle, fidx)
            self.logger.info(
                f"Frames {fidx:03d}/{self.seq_len - 1}, PSNR : {psnr:.3f}")
        return bundle

    # ------------------------------------------------------------------ #
    def render_frame(self, bundle: ModelBundle, fidx: int):
        cam = self.camera_for(fidx, pose=bundle.get_RT(fidx))
        out = step_lib.render_eval(bundle.state, cam, mode=self._mode,
                                   tile_args=self._tile_args)
        p = float(psnr_fn(out["image"], self.device_frame("rgb", fidx)))
        return p, out

    def evaluate_on_training_images(self, save_images: bool = True):
        """Train-view PSNR of every frame, with GT | render PNGs under
        eval/. Frames render in chunks of `eval_batch` (default 8, as the
        JAX trainer's sweep), one batched render of the model per chunk."""
        out_dir = os.path.join(self.result_path, "eval")
        bundle = self.gs_bundle
        B = max(1, int(getattr(self.pipe_cfg, "eval_batch", 8)))
        if self._mode in ("tiled", "pallas"):
            # settle tile capacities for THIS model: the presets may
            # silently truncate a big merged model
            from . import evals

            evals.settle_eval_tile_args(
                self, bundle.state,
                self.camera_for(0, pose=bundle.get_RT(0)))
        psnrs = []
        for c0 in range(0, self.seq_len, B):
            idxs = list(range(c0, min(c0 + B, self.seq_len)))
            cams = pa.stack_cameras([
                self.camera_for(f, pose=bundle.get_RT(f)) for f in idxs])
            with torch.no_grad():
                imgs = _np(render_batched(
                    bundle.state, cams, shared_state=True, mode=self._mode,
                    tile_args=self._tile_args)["image"])
            for img, fidx in zip(imgs, idxs):
                gt = self.load_image(fidx)
                mse = float(np.mean((img - gt) ** 2))
                p = -10.0 * float(np.log10(max(mse, 1e-12)))
                psnrs.append(p)
                if save_images:
                    save_image(os.path.join(out_dir, f"{fidx:03d}.png"), img,
                               gt_image=gt)
                self.logger.info(f"Frame {fidx}: PSNR = {p:.3f}")
        mean_psnr = float(np.mean(psnrs))
        self.logger.info(f"train-view mean PSNR: {mean_psnr:.3f}")
        print(f"train-view mean PSNR: {mean_psnr:.3f}")
        return mean_psnr

    # ------------------------------------------------------------------ #
    # pose-only mode
    def train_pose_only(self):
        self.derive_schedule()
        os.makedirs(f"{self.result_path}/pose", exist_ok=True)
        self._phase_a()
        poses = [np.eye(4, dtype=np.float32)]
        for fidx in range(1, self.seq_len):
            rel = self.pose_dict[f"rel_pose_{fidx - 1}_to_{fidx}"]
            poses.append(rel @ poses[-1])
        self.pose_dict["poses_pred"] = np.stack(poses)
        self.save_pose_dict(f"{self.result_path}/pose/pose.npz")
        return self.pose_dict["poses_pred"]

    # ------------------------------------------------------------------ #
    # checkpoints: the JAX trainer's npz layout, loadable by either package
    def save_checkpoint(self, path: Optional[str] = None):
        b = self.gs_bundle
        path = path or f"{self.result_path}/chkpnt/model.npz"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        arrs = {f: _np(getattr(b.state, f)) for f in G.PARAM_FIELDS}
        arrs.update(
            live=_np(b.state.live),
            max_radii2d=_np(b.state.max_radii2d),
            grad_accum=_np(b.state.grad_accum),
            grad_denom=_np(b.state.grad_denom),
            active_sh_degree=_np(b.state.active_sh_degree),
            max_sh_degree=np.asarray(b.state.max_sh_degree),
            poses=b.poses if b.poses is not None else np.zeros((0, 4, 4)),
            radius=np.asarray(b.radius),
            spatial_scale=np.asarray(b.spatial_scale),
            adam_step=_np(b.opt.step),
        )
        for f in G.PARAM_FIELDS:
            arrs[f"adam_m_{f}"] = _np(b.opt.m[f])
            arrs[f"adam_v_{f}"] = _np(b.opt.v[f])
        np.savez_compressed(path, **arrs)
        self.logger.info(f"checkpoint -> {path}")

        if b.poses is not None:
            self.pose_dict["poses_pred"] = b.poses[:self.seq_len]
        self.save_pose_dict(f"{self.result_path}/pose/pose.npz")

    def load_checkpoint(self, path: str) -> ModelBundle:
        state, opt, extras = interop.load_checkpoint_npz(path, self.device)
        bundle = ModelBundle(state=state, opt=opt, radius=extras["radius"],
                             spatial_scale=extras["spatial_scale"],
                             poses=extras["poses"])
        self.gs_bundle = bundle
        return bundle

    def save_pose_dict(self, path: str):
        if self.rank != 0:
            return
        np.savez_compressed(path, **self.pose_dict)
        self.logger.info(f"poses -> {path}")

    def _save_partial_poses(self):
        """Crash-resume breadcrumb of Phase A's results so far."""
        if self.rank != 0:
            return
        path = f"{self.result_path}/pose/pose_partial.npz"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez_compressed(path, **self.pose_dict)

    def load_pose_dict(self, path: str):
        with np.load(path) as z:
            self.pose_dict = dict(z)

    # ------------------------------------------------------------------ #
    # eval / render modes (train.evals)
    def eval_nvs(self, checkpoint: Optional[str] = None,
                 pose_file: Optional[str] = None) -> dict:
        from . import evals

        return evals.eval_nvs(self, checkpoint=checkpoint,
                              pose_file=pose_file)

    def eval_pose(self, pose_file: Optional[str] = None) -> dict:
        from . import evals

        return evals.eval_pose(self, pose_file=pose_file)

    def render_nvs(self, checkpoint: Optional[str] = None,
                   pose_file: Optional[str] = None, n_novel: int = 120,
                   traj_opt: str = "bspline") -> str:
        from . import evals

        return evals.render_nvs(self, checkpoint=checkpoint,
                                pose_file=pose_file, n_novel=n_novel,
                                traj_opt=traj_opt)
