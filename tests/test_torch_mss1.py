"""MSS phase 1 (`HTGaussianTrainer.train_nonleaf_phase1`) of the port held
to the benchmark's plain reference (`htbench/reference/mss1.py`) on the
CPU, at 64x48 with two 3,000-row children made from seeds on the photo
scene's surfaces and the root the port's `merge_two` makes of them: the
merge, a bounded call of 4 steps (its draws, pseudo poses, losses, first
gradient, change and densify statistics) and the next pseudo-view; faults
planted in the port's merge (the wrong half kept, the second child left
unmoved, a tenth fewer rows pruned) and in its pseudo-view (the
children's models swapped, alpha forced to 0) that the comparison
catches; and the unbounded call's draws and step count for the whole
phase."""

import json
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from htbench import compare, port  # noqa: E402
from htbench.jobs import mss1_root as job  # noqa: E402
from htbench.reference import mss1  # noqa: E402
from htbench.scene import make_scene, trained_root  # noqa: E402
from ht3dgs_torch.core import adam  # noqa: E402
from ht3dgs_torch.core.gaussians import GaussianState  # noqa: E402
from ht3dgs_torch.train.hierarchy import ModelBundle  # noqa: E402

from port_utils import torch_threads_per_worker  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 21
ROWS, CAP, START, STEPS = 3000, 8192, 3000, 4
# 6 frames at stride 8: frame 4 is the test frame, train frames 0-4
CHILD_FRAMES = ([0, 1, 2, 3], [2, 3, 4])
# at 64x48 a pixel whose transmittance stop flips by rounding moves a loss
# by ~1e-4, and the first gradient, the change and the statistics with it
# (at the cells' 1600x900 such a pixel moves them by ~1e-7)
TOL = {"loss": 1e-3, "grad": 1e-3, "change": 1e-3, "stats_accum": 1e-3,
       "stats_denom": 0.0, "count_frames": 0.0, "count_pseudo_pose": 0.0,
       "densify_prune": 0.0, "densify_rows": 0.0}
# a wrong merge moves the merged rows' norms or the pruned count by this
# share or more (the wrong half: 0.28; the second child unmoved: 0.04; a
# tenth fewer pruned: 0.1)
FAULT_ROWS = 0.01
# a fault's pseudo-view differs from the reference's at this many pixels
# of the 3,072 or more (the swapped model shows other planes' texture, and
# alpha 0 moves the view by alpha of a frame's step)
FAULT_PIXELS = 300


def _config():
    with open(os.path.join(REPO, "htbench", "configs",
                           "tanks-church.json")) as f:
        cfg = json.load(f)
    cfg["scene"].update(n_frames=6, height=48, width=64)
    cfg["PipelineParams"]["render_mode"] = "tiled"
    return cfg


def _bundle(rows, poses, frames, dev):
    zeros = torch.zeros(CAP, device=dev)
    st = GaussianState(
        **{f: rows[f] for f in job.FIELDS}, live=rows["live"],
        max_radii2d=zeros.clone(), grad_accum=zeros.clone(),
        grad_denom=zeros.clone(),
        active_sh_degree=torch.tensor(3, dtype=torch.int32, device=dev),
        max_sh_degree=3)
    radius = float(rows["means"][:ROWS].norm(dim=1).max())
    return ModelBundle(state=st, opt=adam.init(st.params()), radius=radius,
                       spatial_scale=radius, poses=poses,
                       start_fidx=frames[0], to_visit_frames=list(frames))


class Phase1:
    """The port's trainer, the frozen children and the root, on the CPU."""

    def __init__(self, tmp):
        dev = torch.device("cpu")
        here = os.getcwd()
        os.chdir(tmp)
        try:
            self.cfg = _config()
            sc = self.scene = make_scene(self.cfg, SEED, dev, mids=())
            self.tr = port.trainer(self.cfg, sc, SEED, dev)
        finally:
            os.chdir(here)
        self.children, self.child_rows = [], []
        for i, frames in enumerate(CHILD_FRAMES):
            inv0 = np.linalg.inv(sc.poses[frames[0]].astype(np.float64))
            rows = trained_root(job._child_scene(sc, frames), ROWS, CAP, 3,
                                SEED + 1 + i, dev)
            poses = (sc.poses @ inv0).astype(np.float32)
            self.children.append(_bundle(rows, poses, frames, dev))
            self.child_rows.append({
                "rows": {f: rows[f][:ROWS] for f in job.FIELDS},
                "poses": poses, "start": frames[0], "frames": list(frames)})
        # the port's importance of each child, kept for the merge's faults
        self.importance = []
        calc = self.tr.calc_importance

        def recorded(bundle, frames):
            self.importance.append(calc(bundle, frames))
            return self.importance[-1]

        self.tr.calc_importance = recorded
        self.root = job.port_merge(self.tr, self.children, sc.poses)
        del self.tr.calc_importance
        n = int(self.root.state.live.sum())
        self.init = {f: getattr(self.root.state, f)[:n].clone()
                     for f in job.FIELDS}
        self.ratio = self.cfg["OptimizationParams"]["mss_phase1_ratio"]
        self.prune_ratio = self.cfg["PipelineParams"]["prune_ratio"]
        self.tr.global_iteration = START

    def merged(self):
        """The reference's merge of the children."""
        sc = self.scene
        return mss1.merge(self.child_rows, sc.poses, self.prune_ratio, sc.K,
                          sc.height, sc.width, 3, port_merged=self.init)

    def reference(self, port_poses):
        """(the reference's readings of the merge and STEPS steps, its
        random stream after them)."""
        sc = self.scene
        rng = random.Random(SEED)
        idx = self.root.to_visit_frames
        draws = [mss1.draw(rng, idx, self.ratio) for _ in range(STEPS)]
        merged = self.merged()
        r = mss1.steps(merged, self.child_rows, sc.poses, sc.rgb, draws,
                       port_poses, self.cfg["OptimizationParams"], START,
                       self.children[0].spatial_scale, sc.K, sc.height,
                       sc.width, 3)
        r["frames"] = draws
        r["densify"] = job.merge_readings(self.child_rows, merged)
        return r, rng

    def pixels_off(self, pseudo, rng):
        """(the entries of the pseudo-view's pose off the reference's, its
        pixels off the reference's)."""
        sc = self.scene
        state = rng.getstate()
        try:
            return job.reference_pseudo(
                rng, self.child_rows, sc.poses, self.root.to_visit_frames,
                self.ratio, pseudo, sc.K, sc.height, sc.width, 3)
        finally:
            rng.setstate(state)


@pytest.fixture(scope="module")
def phase1(tmp_path_factory):
    p = Phase1(str(tmp_path_factory.mktemp("mss1")))
    port_r = job.port_readings(p.tr, p.root, p.children, STEPS, p.init)
    port_r["densify"] = job.merge_readings(p.child_rows, p.init)
    ref_r, rng = p.reference(port_r.pop("poses"))
    return p, port_r, ref_r, rng


def test_bounded_call_matches_the_reference(phase1):
    """The merge and 4 steps of the port's phase 1 (a bounded call)
    against the reference's merge and steps from its own merged rows: the
    draws exact, both kinds of step among them, the pseudo poses agreeing,
    the numbers within TOL."""
    p, port_r, ref_r, _ = phase1
    assert len(port_r["loss"]) == STEPS
    kinds = {d[0] for d in ref_r["frames"]}
    assert kinds == {"pseudo", "rgb"}, ref_r["frames"]
    got = compare.gaps(port_r, ref_r)
    assert set(got) == set(TOL)
    for k, v in got.items():
        assert v <= TOL[k], (k, v)


def test_next_pseudo_view_matches_the_reference(phase1):
    """The next pseudo-view through the port's `_pseudo_view` (a copy of
    the trainer's random stream; the stream itself left as it was) against
    the reference's render of the same child at the same pose."""
    p, _, _, rng = phase1
    state = p.tr.rng.getstate()
    pseudo = job.next_pseudo(p.tr, p.root, p.children, p.ratio)
    assert p.tr.rng.getstate() == state
    assert pseudo[1] > 0.2     # alpha: the alpha-0 fault below shows
    assert p.pixels_off(pseudo, rng) == (0, 0)


def test_swapped_children_fail_the_pseudo_view(phase1):
    """Each child rendering the other's model (frames and first frame
    kept): the pseudo-view is caught."""
    p, _, _, rng = phase1
    c0, c1 = p.children
    swapped = [ModelBundle(state=b.state, opt=b.opt, radius=b.radius,
                           spatial_scale=b.spatial_scale, poses=a.poses,
                           start_fidx=a.start_fidx,
                           to_visit_frames=a.to_visit_frames)
               for a, b in ((c0, c1), (c1, c0))]
    pseudo = job.next_pseudo(p.tr, p.root, swapped, p.ratio)
    off, pixels = p.pixels_off(pseudo, rng)
    assert off == 0 and pixels >= FAULT_PIXELS


def test_alpha_zero_fails_the_pseudo_view(phase1, monkeypatch):
    """The interpolation with alpha forced to 0 (the pose of the frame
    itself): the pose and the pseudo-view are caught."""
    from ht3dgs_torch.core import se3

    p, _, _, rng = phase1
    interp = se3.se3_interp
    monkeypatch.setattr(se3, "se3_interp",
                        lambda p0, p1, alpha: interp(p0, p1, 0.0))
    pseudo = job.next_pseudo(p.tr, p.root, p.children, p.ratio)
    off, pixels = p.pixels_off(pseudo, rng)
    assert off > 0 and pixels >= FAULT_PIXELS


@pytest.mark.parametrize("fault", ["wrong_half", "unmoved", "ratio"])
def test_a_wrong_merge_fails_the_merged_rows(phase1, fault, monkeypatch):
    """The port's merge keeping the half of the rows with the lowest
    importance, leaving the second child's means in its own coordinates,
    or pruning at 0.9 of the ratio: the merged rows' norms or the pruned
    count are caught."""
    from ht3dgs_torch.train import hierarchy
    from ht3dgs_torch.train import step as t_step

    p, _, ref_r, _ = phase1
    # the children's importance as the port computed it for the sound merge
    it = iter(p.importance)
    monkeypatch.setattr(p.tr, "calc_importance", lambda b, f: next(it))
    prune = t_step.jit_importance_prune
    if fault == "wrong_half":
        monkeypatch.setattr(t_step, "jit_importance_prune",
                            lambda st, opt, imp, r: prune(st, opt, -imp, r))
    elif fault == "ratio":
        monkeypatch.setattr(t_step, "jit_importance_prune",
                            lambda st, opt, imp, r: prune(st, opt, imp,
                                                          0.9 * r))
    else:
        merge_two = hierarchy.HTGaussianTrainer.merge_two
        monkeypatch.setattr(
            hierarchy.HTGaussianTrainer, "merge_two",
            lambda tr, dst, src, t: merge_two(tr, dst, src,
                                              np.eye(4, dtype=np.float32)))
    root = job.port_merge(p.tr, p.children, p.scene.poses)
    n = int(root.state.live.sum())
    merged = {f: getattr(root.state, f)[:n] for f in job.FIELDS}
    got = compare.gaps({"densify": job.merge_readings(p.child_rows, merged)},
                       {"densify": ref_r["densify"]})
    assert max(got["densify_prune"], got["densify_rows"]) >= FAULT_ROWS


def test_unbounded_call_runs_the_whole_phase(phase1, monkeypatch):
    """num_iterations None: mss_phase1_iteration_per_frame steps a frame
    of the children, the draws the reference's rule makes from the
    trainer's seed, one iteration a step; two bounded calls that add up to
    the phase make the same draws (the renders are left out: the steps'
    targets are not looked at)."""
    from ht3dgs_torch.train import step as t_step

    p = phase1[0]
    monkeypatch.setattr(p.tr.sched, "mss_phase1_iteration_per_frame", 3)
    monkeypatch.setattr(p.tr, "rng", p.tr.rng)
    monkeypatch.setattr(p.tr, "global_iteration", p.tr.global_iteration)
    n = 3 * len(p.root.to_visit_frames)
    blank = torch.zeros(p.scene.height, p.scene.width, 3)
    monkeypatch.setattr(t_step, "render_eval",
                        lambda *a, **kw: {"image": blank})

    frame_of = {id(p.tr.device_frame("rgb", k)): k
                for k in p.root.to_visit_frames}

    def run(calls):
        p.tr.rng = random.Random(SEED)
        p.tr.global_iteration = START
        seen, pseudo = [], []
        real = p.tr._pseudo_view

        def pseudo_view(bundle, kids, idx, fidx):
            pseudo.append(fidx)
            return real(bundle, kids, idx, fidx)

        def step(bundle, camera, gt, iteration, **kw):
            seen.append((iteration, ("pseudo", pseudo[-1]) if gt is blank
                         else ("rgb", frame_of[id(gt)])))
            return {}

        monkeypatch.setattr(p.tr, "_pseudo_view", pseudo_view)
        monkeypatch.setattr(p.tr, "host_train_step", step)
        for c in calls:
            before = len(seen)
            p.tr.train_nonleaf_phase1(p.root, p.children, c)
            assert len(seen) - before == (c or n)
        return seen

    seen = run([None])
    rng = random.Random(SEED)
    want = [mss1.draw(rng, p.root.to_visit_frames, p.ratio)[:2]
            for _ in range(n)]
    assert seen == list(zip(range(START + 1, START + n + 1), want))
    assert p.tr.rng.getstate() == rng.getstate()
    assert run([5, n - 5]) == seen
