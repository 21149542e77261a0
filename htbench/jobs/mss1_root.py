"""MSS phase 1 of a root: `HTGaussianTrainer.train_nonleaf_phase1` over the
frames of its two frozen children, half of the steps supervised by the
image a child renders at a pose interpolated between two frames.

The children are the two level-1 nodes of the hierarchy at train_level 2:
their frames are the port's `partition` of the train frames (with the
scene's true relative poses as Phase A's), each the union of its two
leaves. Each child is made on the device from the seed (`scene.
trained_root`) at `rows` live rows on the surfaces its own frames see, in
the coordinates of its first frame, at the capacity a merge of its two
leaves gives it (`_round_capacity` of 1.5 x its rows). The root is made as
the hierarchy makes it: the port's `merge_two` of the two (both pruned by
importance at prune_ratio), with the scene's true poses as the root's. The
trainer's iteration count starts at `start_iteration`. A window round is
one call of `steps_per_call` steps.

Compared, against `reference/mss1.py`, which makes the root from the
children's rows itself (`mss1.merge`) and steps from its own rows:
- the merge, read as the harness reads a prune step: the rows it pruned
  (`densify_prune`, exact) and the norms of the merged rows, field by
  field (`densify_rows`);
- the first `steps` steps: each step's draw (the frame, whether it was a
  pseudo step and alpha; exact), each step's loss, the first step's
  gradient from Adam's first moment, the change after the last and the
  densify statistics;
- the pseudo-views' poses: `count_pseudo_pose`, the entries of the poses
  the port interpolated (for the compared steps and the next pseudo-view)
  off the reference's (`mss1.poses_off`), held to 0;
- the next pseudo-view (drawn from a copy of the trainer's random stream
  and rendered through the port's `_pseudo_view` in set-up) against the
  reference's render of the same child: `count_pseudo_image`, the pixels
  at which the two differ by more than one 8-bit level
  (`mss1.pixels_off`).
The counts are the port's reading 0 against the reference's. Two
decisions that rounding can tip go the port's way where the two sides
agree within a tolerance: a row whose importance lies at the prune's edge
is kept or pruned as the port did (`mss1.prune`), and a pseudo-view is
rendered at the port's pose where it agrees with the reference's
(`mss1.target_pose`).

The step profiled after the window is a step of the root on a train frame,
so that K1's and K2's work and times come from the same render.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from .. import compare, port
from ..reference import mss1, splat
from ..reference import train as ref
from ..scene import Scene, make_scene, trained_root

FIELDS = ref.FIELDS


def _child_scene(sc: Scene, frames) -> Scene:
    """The scene's frames `frames` as a scene of their own, its poses in
    the coordinates of its first frame."""
    inv0 = np.linalg.inv(sc.poses[frames[0]].astype(np.float64))
    poses = np.stack([sc.poses[f].astype(np.float64) @ inv0
                      for f in frames]).astype(np.float32)
    return Scene(sc.K_true, sc.K, sc.height, sc.width, poses, poses[:0],
                 {i: sc.rgb[f] for i, f in enumerate(frames)},
                 {i: sc.depth[f] for i, f in enumerate(frames)}, {}, {})


def port_readings(tr, root, children, steps: int, init: dict) -> dict:
    """The port's readings of `steps` steps of
    `tr.train_nonleaf_phase1(root, children, steps)`, watched from outside:
    each step's draw (("pseudo", frame, alpha) or ("rgb", frame)), its
    pseudo pose (the w2c the port interpolated; None on a frame's step)
    and its loss, the first step's gradient from Adam's first moment, the
    change of the rows `init` holds (the root's first live rows) and the
    densify statistics; the counts are 0 (`Job.reference`)."""
    seen = {"loss": [], "m1": None, "frames": [], "alpha": None,
            "pseudo": None, "pose": None, "poses": []}
    frame_of = {id(tr.device_frame("rgb", k)): ("rgb", k)
                for k in root.to_visit_frames}

    def step_seen(a, kw, out):
        seen["loss"].append(out[2]["loss"])
        if seen["m1"] is None:
            seen["m1"] = out[1].m
        gt = a[3] if len(a) > 3 else kw["gt_image"]
        seen["frames"].append(seen["pseudo"]
                              or frame_of.get(id(gt), (None, -1)))
        seen["poses"].append(seen["pose"] if seen["pseudo"] else None)
        seen["pseudo"] = None

    def alpha_seen(a, kw, out):
        seen["alpha"] = float(a[2] if len(a) > 2 else kw["alpha"])

    def pose_seen(a, kw, out):
        seen["pose"] = out.detach().cpu().numpy().astype(np.float32)

    pseudo_view = tr._pseudo_view

    def pseudo_seen(bundle, kids, indices, fidx):
        out = pseudo_view(bundle, kids, indices, fidx)
        seen["pseudo"] = ("pseudo", fidx, seen["alpha"])
        return out

    tr._pseudo_view = pseudo_seen
    try:
        with port.watch("ht3dgs_torch.train.step", "gaussian_train_step",
                        step_seen), \
                port.watch("ht3dgs_torch.core.se3", "se3_interp",
                           alpha_seen), \
                port.watch("ht3dgs_torch.core.se3", "se3_to_matrix",
                           pose_seen):
            tr.train_nonleaf_phase1(root, children, steps)
    finally:
        del tr._pseudo_view
    st, n = root.state, init["means"].shape[0]
    return {
        "loss": [[float(x)] for x in seen["loss"]],
        "grad": {f: compare.norm(seen["m1"][f][:n]) / (1 - ref.BETA1)
                 for f in FIELDS},
        "change": {f: compare.norm(getattr(st, f)[:n] - init[f])
                   for f in FIELDS},
        "stats": {"accum": compare.norm(st.grad_accum[:n]),
                  "denom": compare.norm(st.grad_denom[:n])},
        "frames": seen["frames"], "poses": seen["poses"],
        "count_pseudo_pose": 0, "count_pseudo_image": 0}


def merge_readings(children: list, merged: dict) -> dict:
    """A merge read as a prune step (`compare.gaps`' "densify"): the rows
    it pruned and the norms of the merged rows, field by field."""
    n_in = sum(c["rows"]["means"].shape[0] for c in children)
    return {"counts": {"prune": n_in - merged["means"].shape[0]},
            "rows": {f: compare.norm(merged[f]) for f in FIELDS}}


def port_merge(tr, children: list, poses: np.ndarray):
    """The root as the hierarchy makes it from two children: the port's
    `merge_two` into a bundle of the first's model at the root's poses."""
    from ht3dgs_torch.train.hierarchy import ModelBundle

    c0, c1 = children
    root = ModelBundle(
        state=c0.state, opt=c0.opt, radius=c0.radius,
        spatial_scale=c0.spatial_scale, poses=poses.copy(),
        start_fidx=c0.start_fidx, to_visit_frames=list(c0.to_visit_frames))
    tr.merge_two(root, c1, np.linalg.inv(root.get_RT(c1.start_fidx)))
    root.to_visit_frames = sorted(set(c0.to_visit_frames
                                      + c1.to_visit_frames))
    return root


def next_pseudo(tr, root, children, ratio: float):
    """The trainer's next pseudo-view, rendered through its `_pseudo_view`
    with a copy of its random stream (the stream is left as it was):
    (frame, alpha, the w2c it interpolated, image)."""
    indices = root.to_visit_frames
    draw = random.Random()
    draw.setstate(tr.rng.getstate())
    while True:
        f = draw.choice(indices)
        if draw.random() < ratio:
            break
    stream, tr.rng = tr.rng, random.Random()
    tr.rng.setstate(draw.getstate())
    pose = []
    try:
        with port.watch("ht3dgs_torch.core.se3", "se3_to_matrix",
                        lambda a, kw, out: pose.append(
                            out.detach().cpu().numpy().astype(np.float32))):
            _, image = tr._pseudo_view(root, children, indices, f)
    finally:
        tr.rng = stream
    return f, draw.random(), pose[-1], image.clone()


def reference_pseudo(rng, children: list, poses, indices, ratio: float,
                     pseudo, K, height: int, width: int, sh_degree: int):
    """The reference's next pseudo-view from its random stream, against
    the port's `pseudo` (`next_pseudo`): (the entries of the port's pose
    off the reference's, the pixels at which the images differ; every
    pixel if the port drew another frame or alpha)."""
    while True:
        d = mss1.draw(rng, indices, ratio)
        if d[0] == "pseudo":
            break
    f, alpha, port_pose, port_image = pseudo
    same = (f, alpha) == d[1:]
    pose, off = mss1.target_pose(poses, indices, d[1], d[2],
                                 port_pose if same else None)
    _, image = mss1.pseudo_image(children, poses, indices, d[1], pose, K,
                                 height, width, sh_degree)
    return off, mss1.pixels_off(port_image if same else None, image)


class Job:
    def __init__(self, ctx):
        from ht3dgs_torch.core import adam
        from ht3dgs_torch.core.gaussians import GaussianState
        from ht3dgs_torch.train.hierarchy import ModelBundle
        from ht3dgs_torch.train.hierarchy import _round_capacity \
            as port_capacity

        self.ctx = ctx
        cfg, tr_cfg = ctx.config, ctx.traffic
        dev = ctx.device
        self.steps = int(tr_cfg["steps"])
        self.per_call = int(tr_cfg["steps_per_call"])
        self.start = int(tr_cfg["start_iteration"])
        sc = self.scene = make_scene(cfg, ctx.seed, dev, mids=())
        self.F = sc.n_frames
        deg = self.deg = int(cfg["ModelParams"]["sh_degree"])
        n = int(tr_cfg["rows"])
        tr = self.tr = port.trainer(cfg, sc, ctx.seed, dev)
        for k in range(self.F - 1):
            tr.pose_dict[f"rel_pose_{k}_to_{k + 1}"] = (
                sc.poses[k + 1] @ np.linalg.inv(sc.poses[k])).astype(
                    np.float32)
        level = int(cfg["PipelineParams"]["train_level"])
        lists = tr.partition(self.F, level)[1]

        # the two children, frozen; their rows are the reference's too
        self.children, self.child_rows, radii = [], [], []
        for i, frames in enumerate(lists):
            cap = port_capacity(int(1.5 * n))
            rows = trained_root(_child_scene(sc, frames), n, cap, deg,
                                ctx.seed + 1 + i, dev)
            radius = float(rows["means"][:n].norm(dim=1).max())
            radii.append(radius)
            inv0 = np.linalg.inv(sc.poses[frames[0]].astype(np.float64))
            poses = (sc.poses.astype(np.float64) @ inv0).astype(np.float32)
            zeros = torch.zeros(cap, device=dev)
            state = GaussianState(
                **{f: rows[f] for f in FIELDS}, live=rows["live"],
                max_radii2d=zeros.clone(), grad_accum=zeros.clone(),
                grad_denom=zeros.clone(),
                active_sh_degree=torch.tensor(deg, dtype=torch.int32,
                                              device=dev), max_sh_degree=deg)
            self.children.append(ModelBundle(
                state=state, opt=adam.init(state.params()), radius=radius,
                spatial_scale=radius, poses=poses, start_fidx=frames[0],
                to_visit_frames=list(frames)))
            self.child_rows.append({"rows": {f: rows[f][:n] for f in FIELDS},
                                    "poses": poses, "start": frames[0],
                                    "frames": list(frames)})
        # the root's position learning rate scales by its first child's
        # extent, as the merge leaves it
        self.scale = radii[0]

        # the root: the merge of the two, at the scene's true poses
        root = self.bundle = port_merge(tr, self.children, sc.poses)
        live = root.state.live
        self.rows = int(live.sum())
        if not bool(live[:self.rows].all()):
            raise RuntimeError("the merged root's live rows are not packed")
        self.init = {f: getattr(root.state, f)[:self.rows].clone()
                     for f in FIELDS}
        tr.global_iteration = self.start
        self.indices = root.to_visit_frames
        self.mpix = sc.height * sc.width / 1e6
        self.ratio = float(cfg["OptimizationParams"]["mss_phase1_ratio"])
        self.sched = dataclasses.replace(
            tr.sched, densification_interval=tr.sched.
            mss_phase1_densification_interval)

        # the compared steps, which are also the warm-up
        for k in self.indices:
            # every real frame's camera, made now: the trainer caches them,
            # and making one copies to the device, which waits for its queue
            tr._frame_camera_gt(root, k, False)
        self.readings = port_readings(tr, root, self.children, self.steps,
                                      self.init)
        self.port_poses = self.readings.pop("poses")
        self.readings["densify"] = merge_readings(self.child_rows, self.init)
        self.pseudo = next_pseudo(tr, root, self.children, self.ratio)

    def round(self):
        self.tr.train_nonleaf_phase1(self.bundle, self.children,
                                     self.per_call)
        return self.per_call, self.per_call * self.mpix

    def reckon_step(self):
        """One more step of the root on a train frame (the trainer's next
        draw of a frame, from a copy of its random stream), and the view it
        renders."""
        tr, root = self.tr, self.bundle
        draw = random.Random()
        draw.setstate(tr.rng.getstate())
        k = draw.choice(self.indices)
        cam, gt = tr._frame_camera_gt(root, k, False)
        st = root.state
        sc = self.scene
        views = [({f: getattr(st, f) for f in FIELDS}, st.live,
                  splat.Camera(sc.poses[k], sc.K, sc.height, sc.width,
                               self.ctx.device), int(st.active_sh_degree))]

        def run():
            tr.global_iteration += 1
            tr.host_train_step(root, cam, gt, tr.global_iteration,
                               sched=self.sched)
        return run, views

    def release(self):
        del self.tr, self.bundle, self.children

    def reference(self):
        """The reference's readings of the merge, the compared steps and
        the next pseudo-view, from the children's rows and the scene."""
        sc, cfg = self.scene, self.ctx.config
        merged = mss1.merge(self.child_rows, sc.poses,
                            float(cfg["PipelineParams"]["prune_ratio"]),
                            sc.K, sc.height, sc.width, self.deg,
                            port_merged=self.init)
        rng = random.Random(self.ctx.seed)
        draws = [mss1.draw(rng, self.indices, self.ratio)
                 for _ in range(self.steps)]
        r = mss1.steps(merged, self.child_rows, sc.poses, sc.rgb, draws,
                       self.port_poses, cfg["OptimizationParams"],
                       self.start, self.scale, sc.K, sc.height, sc.width,
                       self.deg)
        r["frames"] = draws
        r["densify"] = merge_readings(self.child_rows, merged)
        off, r["count_pseudo_image"] = reference_pseudo(
            rng, self.child_rows, sc.poses, self.indices, self.ratio,
            self.pseudo, sc.K, sc.height, sc.width, self.deg)
        r["count_pseudo_pose"] += off
        return r
