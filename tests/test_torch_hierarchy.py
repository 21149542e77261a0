"""ht3dgs_torch's hierarchical trainer against ht3dgs on the CPU: the
partition and the frame-sampling stream, colour importance, merges, the
checkpoint layout both ways; the port's Phase A batch against its own
per-model steps; and a port-only end-to-end run.

The JAX package's batched fits and its hierarchical_training are not run
here: their CPU compiles take minutes. The port's batched fits are held to
the port's gaussian_train_step / pose_train_step, which test_torch_step
holds to JAX's."""

import logging
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ht3dgs.core import adam as j_adam  # noqa: E402
from ht3dgs.data.readers import FrameInfo as JFrame  # noqa: E402
from ht3dgs.train import hierarchy as j_hier  # noqa: E402
from ht3dgs.utils.config import load_configs as j_load_configs  # noqa: E402
from ht3dgs_torch import interop  # noqa: E402
from ht3dgs_torch.core import adam as t_adam  # noqa: E402
from ht3dgs_torch.core.camera import (intrinsics_from_fov,  # noqa: E402
                                      make_camera)
from ht3dgs_torch.core.gaussians import PARAM_FIELDS  # noqa: E402
from ht3dgs_torch.core.se3 import se3_exp  # noqa: E402
from ht3dgs_torch.data.readers import FrameInfo as TFrame  # noqa: E402
from ht3dgs_torch.train import hierarchy as t_hier  # noqa: E402
from ht3dgs_torch.train import phase_a  # noqa: E402
from ht3dgs_torch.train import step as t_step  # noqa: E402
from ht3dgs_torch.utils import synthetic  # noqa: E402
from ht3dgs_torch.utils.config import load_configs  # noqa: E402

from port_utils import jax_state, rich_scene  # noqa: E402
from port_utils import torch_threads_per_worker  # noqa: E402,F401

H, W = 40, 56
LOG = logging.getLogger("test_torch_hierarchy")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _bare(cls, n_frames=4, **attrs):
    """A trainer built with __new__ and the attributes these tests read."""
    tr = cls.__new__(cls)
    _, tr.pipe_cfg, tr.optim_cfg = j_load_configs()
    tr.pipe_cfg.render_mode = "oracle"
    K = intrinsics_from_fov(1.2, H, W)
    frame = JFrame if cls is j_hier.HTGaussianTrainer else TFrame
    tr.data = [frame(uid=i, image_path=None, image_name=f"{i:04d}", width=W,
                     height=H, intrinsics=K, fovx=1.2, fovy=1.0)
               for i in range(n_frames)]
    tr.logger = LOG
    tr._mode, tr._tile_args = "oracle", None
    tr.device, tr._cameras = torch.device("cpu"), {}
    for k, v in attrs.items():
        setattr(tr, k, v)
    return tr


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        poses[i] = _np(t_hier.se3.se3_to_matrix(se3_exp(torch.tensor(
            rng.normal(0, 0.03, 6), dtype=torch.float32))))
    return poses


def _bundles(arrs, poses, radius=2.0):
    js = jax_state(arrs)
    ts = interop.state_from_numpy(arrs, device="cpu")
    jb = j_hier.ModelBundle(state=js, opt=j_adam.init(js.params()),
                            radius=radius, spatial_scale=radius,
                            poses=poses.copy())
    tb = t_hier.ModelBundle(state=ts, opt=t_adam.init(ts.params()),
                            radius=radius, spatial_scale=radius,
                            poses=poses.copy())
    return jb, tb


@pytest.mark.parametrize("strategy", ["even", "v1"])
def test_partition_and_frame_sampling_match_jax(strategy):
    rels = {f"rel_pose_{i}_to_{i + 1}": p
            for i, p in enumerate(_poses(16, seed=1))}
    trs = [_bare(c, pose_dict=dict(rels), rng=random.Random(7))
           for c in (j_hier.HTGaussianTrainer, t_hier.HTGaussianTrainer)]
    for tr in trs:
        tr.pipe_cfg.partition_strategy = strategy
    for n, level in ((9, 1), (16, 2), (16, 1)):
        assert trs[1].partition(n, level) == trs[0].partition(n, level)
    rng = np.random.default_rng(2)
    visited = [list(range(int(k))) for k in rng.integers(2, 12, 200)]
    draws = [[tr.sample_training_frame(v) for v in visited] for tr in trs]
    assert draws[0] == draws[1]
    assert trs[0].rng.random() == trs[1].rng.random()


def test_calc_importance_and_merge_match_jax(monkeypatch):
    """calc_importance on the oracle against JAX's (1e-5 of its max); then
    merge_two with the same given importances gives the same merged state,
    so the only difference the card brings is the importance's rounding."""
    poses = _poses(4, seed=3)
    dst_arrs, src_arrs = rich_scene(160, seed=0), rich_scene(96, seed=1)
    jd, td = _bundles(dst_arrs, poses, radius=2.0)
    js, ts = _bundles(src_arrs, poses, radius=2.5)
    for b in (jd, td):
        b.to_visit_frames = [0, 1, 2]
    for b in (js, ts):
        b.to_visit_frames, b.start_fidx = [2, 3], 2
    jt = _bare(j_hier.HTGaussianTrainer)
    tt = _bare(t_hier.HTGaussianTrainer)
    imp_j = [np.asarray(jt.calc_importance(b, b.to_visit_frames))
             for b in (jd, js)]
    imp_t = [tt.calc_importance(b, b.to_visit_frames) for b in (td, ts)]
    for a, b in zip(imp_t, imp_j):
        assert b.max() > 0
        np.testing.assert_allclose(_np(a), b, rtol=0, atol=1e-5 * b.max())

    # merge with the same importances (ties included)
    given = [np.round(b * 4 / b.max()).astype(np.float32) for b in imp_j]
    for tr, conv in ((jt, jnp.asarray), (tt, torch.from_numpy)):
        it = iter([conv(g) for g in given])
        monkeypatch.setattr(tr, "calc_importance",
                            lambda b, frames, it=it: next(it))
    transform = np.linalg.inv(poses[2])
    jt.merge_two(jd, js, transform)
    tt.merge_two(td, ts, transform)
    assert td.state.capacity == jd.state.capacity
    np.testing.assert_array_equal(_np(td.state.live),
                                  np.asarray(jd.state.live))
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(_np(getattr(td.state, f)),
                                   np.asarray(getattr(jd.state, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
        assert not _np(td.opt.m[f]).any() and not _np(td.opt.v[f]).any()
    assert int(td.opt.step) == 0 and td.radius == jd.radius == 2.5


def _fit_inputs(seed=0):
    """Two small models; model 1's target is its own render plus a little
    noise (PSNR > 35), so it stops early; model 0's is another frame."""
    rng = np.random.default_rng(seed)
    K = intrinsics_from_fov(1.2, H, W)
    states, cams, gts = [], [], []
    for b in range(2):
        st = synthetic.make_scene_states(120, seed=seed + b, device="cpu")
        cam = make_camera(H, W, K, world_view=_poses(1, seed + b)[0],
                          device="cpu")
        states.append(st)
        cams.append(cam)
    gts.append(torch.from_numpy(rng.random((H, W, 3)).astype(np.float32)))
    img = t_step.render_eval(states[1], cams[1], mode="oracle")["image"]
    gts.append((img + 0.003 * torch.from_numpy(
        rng.standard_normal((H, W, 3)).astype(np.float32))).clamp(0, 1))
    return states, cams, gts


@pytest.mark.parametrize("poll", [25, 2])
def test_batched_fit_equals_per_model_steps(poll):
    states, cams, gts = _fit_inputs()
    n_iters, max_steps = 6, 50
    lr_args = ([1e-2, 2e-2], [1e-4, 2e-4], max_steps,
               {"sh_dc": [2.5e-3] * 2, "sh_rest": [1.25e-4] * 2,
                "opacity_logit": [0.05] * 2, "log_scales": [5e-3] * 2,
                "quats": [1e-3] * 2})
    out, opts = phase_a.batched_fit(
        states, [t_adam.init(s.params()) for s in states], cams, gts,
        lr_args, mode="oracle", n_iters=n_iters, poll=poll)

    def sequence(b, n):
        s, o = states[b], t_adam.init(states[b].params())
        for it in range(1, n + 1):
            lrs = {k: v[b] for k, v in lr_args[3].items()}
            lrs["means"] = t_adam.expon_lr(it, lr_args[0][b], lr_args[1][b],
                                           max_steps)
            s, o, _ = t_step.gaussian_train_step(
                s, o, cams[b], gts[b], lrs, mode="oracle",
                track_stats=False)
        return s, o

    # stop_after = n_iters // 2: model 1 stops after its 4th update
    for b, n in ((0, n_iters), (1, 4)):
        s, o = sequence(b, n)
        assert int(opts[b].step) == n
        for f in PARAM_FIELDS:
            np.testing.assert_allclose(_np(getattr(out[b], f)),
                                       _np(getattr(s, f)), rtol=0,
                                       atol=1e-6, err_msg=f"{b} {f}")
            np.testing.assert_allclose(_np(opts[b].v[f]), _np(o.v[f]),
                                       rtol=0, atol=1e-6)
    longer, _ = sequence(1, n_iters)
    assert not torch.equal(out[1].means, longer.means)

    # the pose fit: one tangent per model, no early stop
    bases = se3_exp(torch.tensor([[0.02, -0.01, 0.0, 0.01, 0.0, -0.01],
                                  [0.0, 0.01, 0.02, 0.0, 0.01, 0.0]]))
    deltas = phase_a.batched_pose_fit(states, bases, cams, gts, 3e-3,
                                      mode="oracle", n_iters=5)
    for b in range(2):
        d, o = torch.zeros(6), t_step.init_pose_opt("cpu")
        for _ in range(5):
            d, o, _ = t_step.pose_train_step(states[b], d, bases[b], o,
                                             cams[b], gts[b], 3e-3,
                                             mode="oracle")
        np.testing.assert_allclose(_np(deltas[b]), _np(d), rtol=0, atol=1e-6)


def tiny_cfg(img_dir, depth_dir):
    """The JAX e2e's tiny configuration (test_hierarchy_e2e.tiny_cfg), with
    Phase A's budgets cut from 40 / 25 to 16 / 10 iterations to keep the
    CPU run short."""
    model, pipe, optim = load_configs()
    model.FovX = 1.2
    model.eval = False
    model.source_path = img_dir
    model.data_type = "images_only"
    model.expname, model.category, model.seq_name = "test", "synt", "a"
    pipe.train_level = 1
    pipe.render_mode = "oracle"
    pipe.capacity_presize = 2.0
    pipe.depth_provider = "precomputed"
    pipe.depth_dir = depth_dir
    pipe.vfi_provider = "blend"
    pipe.init_max_points = 300
    optim.single_step = 12
    optim.phase_a_fit_iters = 16
    optim.phase_a_pose_iters = 10
    optim.leaf_init_iters = 40
    optim.reset_recovery_iters = 5
    optim.mss_phase1_iteration_per_frame = 3
    optim.num_iterations_per_frame_each_level = [6, 6, 6]
    optim.densification_interval = 50
    optim.densification_interval_leaf = 50
    optim.densify_from_iter = 20
    return model, pipe, optim


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("synt")
    scene = synthetic.generate(n_frames=9, height=H, width=W,
                               n_gaussians=300, seed=3, device="cpu")
    img_dir = synthetic.write_images_only(scene, str(d / "images"),
                                          depth_dir=str(d / "depth"))
    cwd = os.getcwd()
    os.chdir(d)
    try:
        tr = t_hier.HTGaussianTrainer(img_dir, *tiny_cfg(img_dir,
                                                         str(d / "depth")),
                                      seed=0, device="cpu")
        tr.result_path = os.path.abspath(tr.result_path)
        bundle = tr.hierarchical_training()
    finally:
        os.chdir(cwd)
    return tr, bundle


def test_hierarchical_training_e2e(trained):
    tr, bundle = trained
    assert tr.seq_len == 9
    assert bundle.poses is not None and np.all(np.isfinite(bundle.poses))
    assert bundle.to_visit_frames == list(range(9))
    for f in range(1, 9):
        assert np.all(np.isfinite(tr.pose_dict[f"rel_pose_{f - 1}_to_{f}"]))
        assert f"rel_pose_{f - 1}_to_{f - 1}.5" in tr.pose_dict
    ckpt = os.path.join(tr.result_path, "chkpnt", "model.npz")
    n_before = int(bundle.state.n_live())
    b2 = tr.load_checkpoint(ckpt)
    assert int(b2.state.n_live()) == n_before
    np.testing.assert_array_equal(_np(b2.state.means), _np(bundle.state.means))
    _, out_a = tr.render_frame(bundle, 0)
    _, out_b = tr.render_frame(b2, 0)
    assert torch.equal(out_a["image"], out_b["image"])
    assert tr.n_capacity_grows == 0
    assert set(tr.timer.summary()) == {"phase_a", "leaf", "merge",
                                       "nonleaf_phase1", "nonleaf_phase2",
                                       "eval"}
    assert tr.evaluate_on_training_images(save_images=False) > 18.0


def test_checkpoints_load_across_packages(trained, tmp_path):
    """model.npz written by the port loads in JAX's load_checkpoint with
    equal arrays, and the reverse; breadcrumbs round-trip in the port and
    refuse another configuration."""
    tr, bundle = trained
    ckpt = os.path.join(tr.result_path, "chkpnt", "model.npz")
    jt = _bare(j_hier.HTGaussianTrainer)
    jb = jt.load_checkpoint(ckpt)
    for f in PARAM_FIELDS + ("live", "grad_accum", "active_sh_degree"):
        np.testing.assert_array_equal(np.asarray(getattr(jb.state, f)),
                                      _np(getattr(bundle.state, f)))
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(jb.opt.v[f]),
                                      _np(bundle.opt.v[f]))
    np.testing.assert_array_equal(jb.poses, bundle.poses)

    # JAX writes, the port reads
    arrs = rich_scene(64, seed=5)
    jb2, _ = _bundles(arrs, _poses(3, seed=6))
    jt.result_path, jt.pose_dict, jt.seq_len = str(tmp_path), {}, 3
    os.makedirs(tmp_path / "pose")
    jt.gs_bundle = jb2
    jt.save_checkpoint()
    tb2 = _bare(t_hier.HTGaussianTrainer).load_checkpoint(
        str(tmp_path / "chkpnt" / "model.npz"))
    for f in PARAM_FIELDS + ("live", "max_radii2d", "active_sh_degree"):
        np.testing.assert_array_equal(_np(getattr(tb2.state, f)),
                                      np.asarray(getattr(jb2.state, f)))
    assert tb2.state.max_sh_degree == jb2.state.max_sh_degree
    assert int(tb2.opt.step) == 0 and tb2.radius == jb2.radius

    # breadcrumbs: the JAX layout with the generator's state
    tr._crumb_fp = "fp-a"
    tr.gen.manual_seed(9)
    tr._save_bundle_breadcrumb(bundle, "lv9_seg0")
    draw = torch.randn(3, generator=tr.gen)
    r = tr._load_bundle_breadcrumb("lv9_seg0")
    tr._commit_crumb_rng(r)
    assert torch.equal(torch.randn(3, generator=tr.gen), draw)
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(r.state, f), getattr(bundle.state, f))
    assert r.to_visit_frames == bundle.to_visit_frames
    tr._crumb_fp = "fp-b"
    assert tr._load_bundle_breadcrumb("lv9_seg0") is None
    # JAX reads the port's crumb arrays (all but the RNG)
    with np.load(tr._bundle_breadcrumb_path("lv9_seg0")) as z:
        assert "torch_rng" in z.files and "jax_key" not in z.files
        np.testing.assert_array_equal(z["means"], _np(bundle.state.means))
