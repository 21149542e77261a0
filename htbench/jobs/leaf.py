"""A leaf of the hierarchy: `HTGaussianTrainer.train_leaf` on the last
frame of leaf 0 of the configuration's partition, with replay sampling over
the leaf's frames and midpoint (VFI) frames at their half-step poses.

Set-up partitions the train frames as the trainer does (`partition`, from
the relative poses Phase A would have found: the scene's true ones), and
makes the leaf the trainer's way from its first frame's init cloud
(`prepare_pcd` / `make_model`, at the configuration's capacity_presize),
with the leaf's poses anchored at that frame. The trainer's iteration count
starts at `start_iteration`, inside the densification window, so
densify/prune (every densification_interval_leaf) and the tile-capacity
check (every 50 steps) fire in the window as in a leaf; the SH degree is
the one a leaf has there (one band a 1000 iterations). A window round is
one call of `train_leaf` over `steps_per_call` steps (the call's
single_step; the configuration's 300 is a leaf frame's whole budget).

Compared: the first `steps` steps, the last of them a densify step (the
frames the port drew, the losses, the first gradient from Adam's first
moment, the change up to the densify step, the densify statistics it
reads, and what densify/prune made of the rows: `compare.densify_readings`
of its live rows before and after). The reference makes the leaf from the
same frame and depth, draws the frames itself with Python's
`random.Random(seed)` in the trainer's order, and densifies by its own
rule with its own split noise.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .. import compare, faults, port
from ..reference import splat
from ..reference import train as ref
from ..scene import make_scene

FIELDS = ref.FIELDS
FAULTS = faults.COMMON + ("densify",)


class Job:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, tr_cfg = ctx.config, ctx.traffic
        dev = ctx.device
        o = cfg["OptimizationParams"]
        self.steps = int(tr_cfg["steps"])
        self.per_call = int(tr_cfg["steps_per_call"])
        self.start = int(tr_cfg["start_iteration"])
        self.degree = min(self.start // 1000,
                          int(cfg["ModelParams"]["sh_degree"]))
        interval = int(o["densification_interval_leaf"])
        its = range(self.start + 1, self.start + self.steps + 1)
        if [i for i in its if i % interval == 0] != [its[-1]] or any(
                i % o["opacity_reset_interval"] == 0 for i in its):
            raise ValueError("the last compared step, and no other, has to "
                             "densify, and none may reset the opacity")
        sc = self.scene = make_scene(cfg, ctx.seed, dev)
        self.F = sc.n_frames
        tr = self.tr = port.trainer(cfg, sc, ctx.seed, dev)
        for k in range(self.F - 1):
            tr.pose_dict[f"rel_pose_{k}_to_{k + 1}"] = (
                sc.poses[k + 1] @ np.linalg.inv(sc.poses[k])).astype(
                    np.float32)
            tr.pose_dict[f"rel_pose_{k}_to_{k}.5"] = (
                sc.mid_poses[k] @ np.linalg.inv(sc.poses[k])).astype(
                    np.float32)
        level = int(cfg["PipelineParams"]["train_level"])
        self.frames = tr.partition(self.F, level)[level][0]
        first = self.frames[0]
        self.anchor = np.linalg.inv(sc.poses[first])
        self.bundle = tr.make_model(tr.prepare_pcd(first))
        self.bundle.poses = np.stack([p @ self.anchor for p in sc.poses]
                                     ).astype(np.float32)
        self.bundle.start_fidx = first
        st = self.bundle.state
        st.active_sh_degree = torch.tensor(self.degree, dtype=torch.int32,
                                           device=dev)
        self.rows = int(st.n_live())
        self.radius = self.bundle.radius
        tr.global_iteration = self.start
        self.view = self.frames[-1]
        self.mpix = sc.height * sc.width / 1e6

        # the compared steps, which are also the warm-up
        init = {f: getattr(st, f) for f in FIELDS}
        seen = {"loss": [], "m1": None, "frames": []}
        frame_of = {}
        for k in range(self.F):
            frame_of[id(tr.device_frame("rgb", k))] = ("rgb", k)
        for k in range(self.F - 1):
            frame_of[id(tr.device_frame("vfi", k))] = ("vfi", k)
        # every camera a step can draw, made now (see mss2_root)
        for k in self.frames:
            for vfi in (False, True):
                tr._frame_camera_gt(self.bundle, k, vfi)

        def step_seen(a, kw, out):
            seen["loss"].append(out[2]["loss"])
            if seen["m1"] is None:
                seen["m1"] = out[1].m
            seen["frames"].append(frame_of.get(id(a[3]), (None, -1)))

        n = self.rows

        def densify_seen(a, kw, out):
            st_in, st_out = a[0], out[0]
            seen["change"] = {f: compare.norm(getattr(st_in, f)[:n]
                                              - init[f][:n]) for f in FIELDS}
            seen["stats"] = {"accum": compare.norm(st_in.grad_accum[:n]),
                             "denom": compare.norm(st_in.grad_denom[:n])}
            seen["densify"] = compare.densify_readings(
                {f: getattr(st_in, f)[st_in.live] for f in FIELDS},
                {f: getattr(st_out, f)[st_out.live] for f in FIELDS})

        with port.watch("ht3dgs_torch.train.step", "gaussian_train_step",
                        step_seen), \
                port.watch("ht3dgs_torch.train.step", "densify_and_prune",
                           densify_seen):
            self.call(self.steps)
        self.readings = {
            "loss": [[float(x)] for x in seen["loss"]],
            "grad": {f: compare.norm(seen["m1"][f][:n]) / (1 - ref.BETA1)
                     for f in FIELDS},
            "change": seen.get("change"), "stats": seen.get("stats"),
            "densify": seen.get("densify"),
            "frames": seen["frames"], "count_rows": n}

    def call(self, n):
        self.tr.sched.single_step = n
        self.tr.train_leaf(self.bundle, self.view, self.view - 1,
                           list(self.frames))

    def round(self):
        self.call(self.per_call)
        return self.per_call, self.per_call * self.mpix

    def reckon_step(self):
        draw = random.Random()
        draw.setstate(self.tr.rng.getstate())
        k, vfi = self._draw(draw)
        st = self.bundle.state
        views = [({f: getattr(st, f) for f in FIELDS}, st.live,
                  self._cam(k, vfi), int(st.active_sh_degree))]
        return (lambda: self.call(1)), views

    def release(self):
        del self.tr, self.bundle

    # -- the reference ----------------------------------------------------
    def _draw(self, rng: random.Random):
        """The trainer's draw of one leaf step: replay sampling over the
        leaf's frames (70% from their recent half), then whether the
        midpoint frame stands in."""
        visited = list(self.frames)
        last = max(1, len(visited) // 2)
        if rng.random() < 0.7:
            i = rng.randint(last, len(visited) - 1)
        else:
            i = rng.randint(1, last)
        k = visited[i]
        ratio = self.ctx.config["OptimizationParams"]["mss_phase2_ratio"]
        vfi = k + 1 < self.F and rng.random() < ratio
        return k, vfi

    def _cam(self, k, vfi):
        sc = self.scene
        pose = (sc.mid_poses[k] if vfi else sc.poses[k]) @ self.anchor
        return splat.Camera(pose.astype(np.float32), sc.K, sc.height,
                            sc.width, self.ctx.device)

    def reference(self):
        """The reference's readings of the compared steps, from the scene's
        frame, depth and poses alone."""
        sc, cfg = self.scene, self.ctx.config
        first = self.frames[0]
        pts, col = ref.cloud(sc.rgb[first], torch.clamp(sc.depth[first],
                                                        min=0.01), sc.K)
        m = ref.model(pts, col, int(cfg["ModelParams"]["sh_degree"]))
        rng = random.Random(self.ctx.seed)
        draws = [self._draw(rng) for _ in range(self.steps)]
        gen = torch.Generator(device=self.ctx.device)
        gen.manual_seed(self.ctx.seed)
        r = ref.view_steps(
            m, [(self._cam(k, v), sc.vfi[k] if v else sc.rgb[k])
                for k, v in draws], cfg["OptimizationParams"], self.start,
            ref.radius(pts), self.degree, densify_gen=gen)
        r["frames"] = [("vfi", k) if v else ("rgb", k) for k, v in draws]
        r["count_rows"] = pts.shape[0]
        return r
