"""MSS phase 2 of a root: `HTGaussianTrainer.train_nonleaf_phase2` over
every train frame, half of the steps on the midpoint (VFI) frames at their
half-step poses.

The root is made on the device from the seed (`scene.trained_root`: a
trained model's statistics on the scene's surfaces) at `rows` live rows
and the capacity the trainer's `_round_capacity` gives, at the full SH
degree, with the scene's true poses as the poses Phase A would have found
and the midpoint poses as the half-step poses. The trainer's iteration
count starts at `start_iteration`: inside the densification window, so the
step accumulates the densify statistics, and away from the interval's
multiples. A window round is one call of `steps_per_call` steps.

Compared: the first `steps` steps (the frames the port drew, each step's
loss, the first step's gradient from Adam's first moment, the change after
the last, and the densify statistics the steps accumulated). The reference
draws the frames itself with Python's `random.Random(seed)` in the
trainer's order.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .. import compare, port
from ..reference import splat
from ..reference import train as ref
from ..scene import make_scene, trained_root

FIELDS = ref.FIELDS


class Job:
    def __init__(self, ctx):
        from ht3dgs_torch.core import adam
        from ht3dgs_torch.core.gaussians import GaussianState
        from ht3dgs_torch.train.hierarchy import ModelBundle, _round_capacity \
            as port_capacity

        self.ctx = ctx
        cfg, tr_cfg = ctx.config, ctx.traffic
        dev = ctx.device
        self.steps = int(tr_cfg["steps"])
        self.per_call = int(tr_cfg["steps_per_call"])
        self.start = int(tr_cfg["start_iteration"])
        sc = self.scene = make_scene(cfg, ctx.seed, dev)
        self.F = sc.n_frames
        deg = int(cfg["ModelParams"]["sh_degree"])
        n = int(tr_cfg["rows"])
        cap = port_capacity(n)
        self.root = trained_root(sc, n, cap, deg, ctx.seed, dev)
        self.radius = float(self.root["means"][:n].norm(dim=1).max())
        tr = self.tr = port.trainer(cfg, sc, ctx.seed, dev)
        zeros = torch.zeros(cap, device=dev)
        state = GaussianState(
            **{f: self.root[f].clone() for f in FIELDS},
            live=self.root["live"].clone(), max_radii2d=zeros.clone(),
            grad_accum=zeros.clone(), grad_denom=zeros.clone(),
            active_sh_degree=torch.tensor(deg, dtype=torch.int32,
                                          device=dev), max_sh_degree=deg)
        self.bundle = ModelBundle(
            state=state, opt=adam.init(state.params()), radius=self.radius,
            spatial_scale=self.radius, poses=sc.poses.copy())
        for k in range(self.F - 1):
            tr.pose_dict[f"rel_pose_{k}_to_{k}.5"] = (
                sc.mid_poses[k] @ np.linalg.inv(sc.poses[k])).astype(
                    np.float32)
        tr.global_iteration = self.start
        self.indices = list(range(self.F))
        self.mpix = sc.height * sc.width / 1e6
        self.rows = n

        # the compared steps, which are also the warm-up
        init = {f: self.root[f] for f in FIELDS}
        seen = {"loss": [], "m1": None, "frames": []}
        frame_of = {}

        def step_seen(a, kw, out):
            seen["loss"].append(out[2]["loss"])
            if seen["m1"] is None:
                seen["m1"] = out[1].m
            gt = a[3] if len(a) > 3 else kw["gt_image"]
            seen["frames"].append(frame_of.get(id(gt), (None, -1)))

        for kind in ("rgb", "vfi"):
            for k in range(self.F if kind == "rgb" else self.F - 1):
                frame_of[id(tr.device_frame(kind, k))] = (kind, k)
        # every camera a step can draw, made now: the trainer caches them,
        # and making one copies to the device, which waits for its queue
        for k in range(self.F):
            for vfi in (False, True):
                tr._frame_camera_gt(self.bundle, k, vfi)
        with port.watch("ht3dgs_torch.train.step", "gaussian_train_step",
                        step_seen):
            tr.train_nonleaf_phase2(self.bundle, self.indices, self.steps)
        st = self.bundle.state
        r = {"loss": [[float(x)] for x in seen["loss"]],
             "grad": {f: compare.norm(seen["m1"][f][:n]) / (1 - ref.BETA1)
                      for f in FIELDS},
             "change": {f: compare.norm(getattr(st, f)[:n] - init[f][:n])
                        for f in FIELDS},
             "stats": {"accum": compare.norm(st.grad_accum[:n]),
                       "denom": compare.norm(st.grad_denom[:n])},
             "frames": seen["frames"]}
        self.readings = r

    def round(self):
        self.tr.train_nonleaf_phase2(self.bundle, self.indices,
                                     self.per_call)
        return self.per_call, self.per_call * self.mpix

    def reckon_step(self):
        """One more step, and the view it renders: the trainer's next
        draw, taken from a copy of its random stream."""
        tr = self.tr
        draw = random.Random()
        draw.setstate(tr.rng.getstate())
        k, vfi = self._draw(draw)
        st = self.bundle.state
        cam = self._cam(k, vfi)
        views = [({f: getattr(st, f) for f in FIELDS}, st.live, cam,
                  int(st.active_sh_degree))]
        return (lambda: tr.train_nonleaf_phase2(self.bundle, self.indices,
                                                1)), views

    def release(self):
        del self.tr, self.bundle

    # -- the reference ----------------------------------------------------
    def _draw(self, rng: random.Random):
        """The trainer's draw of one MSS phase 2 step: a frame, and
        whether its midpoint frame stands in (not for the last frame)."""
        ratio = self.ctx.config["OptimizationParams"]["mss_phase2_ratio"]
        k = rng.choice(self.indices)
        vfi = k + 1 < self.F and rng.random() < ratio
        return k, vfi

    def _cam(self, k, vfi):
        sc = self.scene
        pose = sc.mid_poses[k] if vfi else sc.poses[k]
        return splat.Camera(pose, sc.K, sc.height, sc.width, self.ctx.device)

    def reference(self):
        """The reference's readings of the compared steps, from the root
        and the scene alone."""
        sc, o = self.scene, self.ctx.config["OptimizationParams"]
        n, deg = self.rows, int(self.ctx.config["ModelParams"]["sh_degree"])
        rng = random.Random(self.ctx.seed)
        draws = [self._draw(rng) for _ in range(self.steps)]
        r = ref.view_steps(
            {f: self.root[f][:n] for f in FIELDS},
            [(self._cam(k, v), sc.vfi[k] if v else sc.rgb[k])
             for k, v in draws], o, self.start, self.radius, deg)
        r["frames"] = [("vfi", k) if v else ("rgb", k) for k, v in draws]
        return r
