"""Phase A: the first chunk of the trainer's batched relative-pose fits.

Set-up makes the chunk's models as `compute_relative_poses_batched` does:
for each of the chunk's frame pairs (f - 1, f), a model of frame f - 1 and
one of the midpoint (VFI) frame, from their init clouds
(`HTGaussianTrainer.prepare_pcd` / `make_model`), all at the chunk's
shared capacity. A window round is what one pass of `_fit_pairs` runs, in
the configuration's ratio of fit to pose iterations, at `fit_iters` and
`pose_iters` per call (the trainer's calls take 1000 and 300: one call
would outlast a window):
- `_batched_fit` of the frame models, and of the VFI models;
- `_batched_pose` of the frame models against the VFI frames (half-step
  1), and of the VFI models against frame f (half-step 2).
Each fit call carries on from the last one's models and optimizer.

Compared: the first `steps` fit steps of the frame models and the first
`steps` pose steps of those models (as the fits left them) against their
VFI frames, each step's loss per model, the first step's gradient (from
Adam's first moment) and the change after the last.
"""

from __future__ import annotations

import torch

from .. import compare, port
from ..reference import splat
from ..reference import train as ref
from ..scene import make_scene

FIELDS = ref.FIELDS


class Job:
    def __init__(self, ctx):
        from ht3dgs_torch.train import hierarchy

        self.ctx = ctx
        cfg, tr_cfg = ctx.config, ctx.traffic
        dev = ctx.device
        self.B = B = int(cfg["PipelineParams"]["phase_a_batch"])
        self.fit_iters = int(tr_cfg["fit_iters"])
        self.pose_iters = int(tr_cfg["pose_iters"])
        self.steps = int(tr_cfg["steps"])
        # the chunk's pairs (f - 1, f): frames 0..B, midpoints 0..B-1
        self.scene = make_scene(cfg, ctx.seed, dev, frames=range(B + 1),
                                mids=range(B))
        tr = self.tr = port.trainer(cfg, self.scene, ctx.seed, dev)
        prev, nxt = list(range(B)), list(range(1, B + 1))
        pcds = [tr.prepare_pcd(k) for k in prev]
        vpcds = [tr.prepare_pcd(k, use_vfi_frame=True) for k in prev]
        cap = max(hierarchy._round_capacity(int(len(p.points) * 1.5))
                  for p in pcds + vpcds)
        self.capacity = cap
        self.rows = [len(p.points) for p in pcds]
        self.A = [tr.make_model(p, capacity=cap) for p in pcds]
        self.V = [tr.make_model(p, capacity=cap) for p in vpcds]
        self.cams = [tr.camera_for(k) for k in prev]
        self.cams_ref = [tr.camera_for(k) for k in nxt]
        self.gts = [tr.device_frame("rgb", k) for k in prev]
        self.gts_v = [tr.device_frame("vfi", k) for k in prev]
        self.gts_ref = [tr.device_frame("rgb", k) for k in nxt]
        self.mpix = B * self.scene.height * self.scene.width / 1e6

        # the compared steps, which are also the warm-up: kept of them are
        # the losses, Adam's first moment after the first step and the
        # models after the last
        init = [{f: getattr(b.state, f) for f in FIELDS} for b in self.A]
        seen = {"loss": [], "m1": None, "last": None}

        def fit_seen(a, kw, out):
            seen["loss"].append(out[2]["loss"])
            if seen["m1"] is None:
                seen["m1"] = out[1].m
            seen["last"] = out[0]

        pose_seen = {"loss": [], "m1": None, "last": None}

        def pose_seen_(a, kw, out):
            pose_seen["loss"].append(out[2])
            if pose_seen["m1"] is None:
                pose_seen["m1"] = out[1].m["pose"]
            pose_seen["last"] = out[0]

        with port.watch("ht3dgs_torch.train.phase_a", "fit_step", fit_seen):
            self.fit(self.A, self.cams, self.gts, self.steps)
        with port.watch("ht3dgs_torch.train.phase_a", "pose_step",
                        pose_seen_):
            self.pose(self.A, self.cams, self.gts_v, self.steps)
        self.readings = self._readings(init, seen, pose_seen)
        del seen, pose_seen, init
        self.fit(self.V, self.cams, self.gts_v, 1)
        self.pose(self.V, self.cams_ref, self.gts_ref, 1)

    # -- the port's calls -------------------------------------------------
    def fit(self, bundles, cams, gts, n):
        """`_batched_fit` for n iterations; its models and optimizers
        (returned by `phase_a.batched_fit`) go back into the bundles."""
        self.tr.sched.phase_a_fit_iters = n
        got = []
        with port.watch("ht3dgs_torch.train.phase_a", "batched_fit",
                        lambda a, kw, out: got.append(out)):
            states = self.tr._batched_fit(bundles, cams, gts)
        for b, s, o in zip(bundles, states, got[0][1]):
            b.state, b.opt = s, o

    def pose(self, bundles, cams, gts, n):
        self.tr.sched.phase_a_pose_iters = n
        return self.tr._batched_pose([b.state for b in bundles], cams, gts)

    def round(self):
        """One window round: (batched steps, megapixels rendered)."""
        F, P = self.fit_iters, self.pose_iters
        self.fit(self.A, self.cams, self.gts, F)
        self.fit(self.V, self.cams, self.gts_v, F)
        self.pose(self.A, self.cams, self.gts_v, P)
        self.pose(self.V, self.cams_ref, self.gts_ref, P)
        n = 2 * F + 2 * P
        return n, n * self.mpix

    def reckon_step(self):
        """One more fit step of the frame models, and the views it
        rendered: (run, views) with views a list of (params, live, camera,
        sh degree)."""
        views = []
        for b, cam in zip(self.A, self.cams):
            st = b.state
            views.append(({f: getattr(st, f) for f in FIELDS}, st.live,
                          self._ref_cam(cam), int(st.active_sh_degree)))
        return (lambda: self.fit(self.A, self.cams, self.gts, 1)), views

    def release(self):
        del self.tr, self.A, self.V, self.cams, self.cams_ref
        del self.gts, self.gts_v, self.gts_ref

    # -- readings ---------------------------------------------------------
    def _readings(self, init, seen, pose_seen):
        B = self.B
        r = {"loss": [[float(x) for x in l] for l in seen["loss"]],
             "grad": {}, "change": {}}
        for b in range(B):
            n = self.rows[b]
            for f in FIELDS:
                k = f"m{b}.{f}"
                r["grad"][k] = compare.norm(seen["m1"][f][b, :n]) / (
                    1 - ref.BETA1)
                r["change"][k] = compare.norm(
                    getattr(seen["last"], f)[b, :n] - init[b][f][:n])
        r["pose_loss"] = [[float(x) for x in l] for l in pose_seen["loss"]]
        r["pose_grad"] = {f"m{b}": compare.norm(pose_seen["m1"][b])
                          / (1 - ref.BETA1) for b in range(B)}
        r["pose_change"] = {f"m{b}": compare.norm(pose_seen["last"][b])
                            for b in range(B)}
        r["count_rows"] = sum(self.rows)
        return r

    @staticmethod
    def _ref_cam(cam):
        """The reference's camera of one of the port's."""
        K = [[float(cam.fx), 0, float(cam.cx)], [0, float(cam.fy),
                                                  float(cam.cy)]]
        return splat.Camera(cam.world_view, K, cam.height, cam.width,
                            cam.world_view.device)

    def reference(self):
        """The reference's readings of the compared steps, from the
        scene's frames and depths alone."""
        sc, cfg = self.scene, self.ctx.config
        o = cfg["OptimizationParams"]
        lam = o["lambda_dssim"]
        B, S, dev = self.B, self.steps, self.ctx.device
        models = []
        for k in range(B):
            pts, col = ref.cloud(sc.rgb[k], torch.clamp(sc.depth[k],
                                                        min=0.01), sc.K)
            m = ref.model(pts, col, cfg["ModelParams"]["sh_degree"])
            m["radius"] = ref.radius(pts)
            models.append(m)
        cams = [splat.Camera(torch.eye(4), sc.K, sc.height, sc.width, dev)
                for _ in range(B)]
        fitted, losses, first = ref.fit(
            models, cams, [sc.rgb[k] for k in range(B)], o, S, lam)
        r = {"loss": losses, "grad": {}, "change": {}}
        for b in range(B):
            for f in FIELDS:
                k = f"m{b}.{f}"
                r["grad"][k] = compare.norm(first[b][f])
                r["change"][k] = compare.norm(fitted[b][f] - models[b][f])
        lr = o["rotation_lr"] if o.get("pose_lr") is None else o["pose_lr"]
        taus, plosses, pfirst = ref.pose_fit(
            fitted, cams, [sc.vfi[k] for k in range(B)], lr, S, lam)
        r["pose_loss"] = plosses
        r["pose_grad"] = {f"m{b}": compare.norm(pfirst[b]) for b in range(B)}
        r["pose_change"] = {f"m{b}": compare.norm(taus[b]) for b in range(B)}
        r["count_rows"] = sum(m["means"].shape[0] for m in models)
        return r
