"""ht3dgs_torch's single-device hierarchical trainer at the paper's depth,
train_level 2 (4 leaves, 2 merged level-1 non-leaves, the root with MSS
phase 1 from merged children), on a 10-frame 32x24 synthetic scene
rendered by the oracle; the photo scene's packaged photograph; and the
measurement of the trained root: its step timed at the tile arguments the
training used, not at the eval sweep's, and the blend kernels' work
counts behind their bounds.

The JAX package's hierarchical_training is not run here (its CPU compile
takes minutes): the partition, the pose-chaining rule
(`ht3dgs.train.hierarchy`, the merge's "chain poses for the newly covered
frames") and the checkpoint loader are the JAX package's own, applied to
the port's run."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ht3dgs.train import hierarchy as j_hier  # noqa: E402
from ht3dgs.utils import photo_scene as j_photo  # noqa: E402
from ht3dgs.utils.config import load_configs as j_load_configs  # noqa: E402
from ht3dgs_torch.core.gaussians import PARAM_FIELDS  # noqa: E402
from ht3dgs_torch.raster.blend import blend_fwd_plain  # noqa: E402
from ht3dgs_torch.train import evals as t_evals  # noqa: E402
from ht3dgs_torch.train import hierarchy as t_hier  # noqa: E402
from ht3dgs_torch.train import step as t_step  # noqa: E402
from ht3dgs_torch.utils import photo_scene as t_photo  # noqa: E402
from ht3dgs_torch.utils import profiling  # noqa: E402
from ht3dgs_torch.utils import synthetic  # noqa: E402
from ht3dgs_torch.utils.config import load_configs  # noqa: E402
from ht3dgs_torch.utils.profiling import StepCounter  # noqa: E402

from port_utils import torch_threads_per_worker  # noqa: E402,F401

N_FRAMES, H, W = 10, 24, 32


def level2_cfg(img_dir, depth_dir):
    """test_torch_hierarchy.tiny_cfg's budgets, smaller where the run allows
    (Phase A 16 / 10, fitting each pair directly as the photo tiers do;
    leaf init 20; 10 steps per leaf frame), at train_level 2 with the
    paper's v1 partition."""
    model, pipe, optim = load_configs()
    model.FovX = 1.2
    model.eval = False
    model.source_path = img_dir
    model.data_type = "images_only"
    model.expname, model.category, model.seq_name = "test", "synt", "lv2"
    pipe.train_level = 2
    pipe.partition_strategy = "v1"
    pipe.render_mode = "oracle"
    pipe.capacity_presize = 2.0
    pipe.depth_provider = "precomputed"
    pipe.depth_dir = depth_dir
    pipe.vfi_provider = "blend"
    pipe.train_pose_mode = None
    pipe.init_max_points = 300
    optim.single_step = 10
    optim.phase_a_fit_iters = 16
    optim.phase_a_pose_iters = 10
    optim.leaf_init_iters = 20
    optim.reset_recovery_iters = 5
    optim.mss_phase1_iteration_per_frame = 3
    optim.num_iterations_per_frame_each_level = [6, 6, 6]
    optim.densification_interval = 50
    optim.densification_interval_leaf = 50
    optim.densify_from_iter = 20
    return model, pipe, optim


@pytest.fixture(scope="module")
def level2(tmp_path_factory):
    d = tmp_path_factory.mktemp("lv2")
    scene = synthetic.generate(n_frames=N_FRAMES, height=H, width=W,
                               n_gaussians=300, seed=3, device="cpu")
    img_dir = synthetic.write_images_only(scene, str(d / "images"),
                                          depth_dir=str(d / "depth"))
    counter = StepCounter()
    originals = counter.watch_trainer(t_hier.HTGaussianTrainer)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        tr = t_hier.HTGaussianTrainer(
            img_dir, *level2_cfg(img_dir, str(d / "depth")), seed=0,
            device="cpu")
        tr.result_path = os.path.abspath(tr.result_path)
        root = tr.hierarchical_training()
    finally:
        os.chdir(cwd)
        StepCounter.restore(originals)
    return tr, root, counter


def _jax_partition(pose_dict):
    jt = j_hier.HTGaussianTrainer.__new__(j_hier.HTGaussianTrainer)
    _, jt.pipe_cfg, _ = j_load_configs()
    jt.pipe_cfg.partition_strategy = "v1"
    jt.pose_dict = pose_dict
    return jt.partition(N_FRAMES, 2)


def test_level2_hierarchy(level2):
    tr, root, counter = level2
    lists = _jax_partition(dict(tr.pose_dict))
    assert tr.partition(N_FRAMES, 2) == lists
    assert [len(lists[lv]) for lv in (2, 1, 0)] == [4, 2, 1]

    # every bundle the trainer finished, each with its segment's frames
    done = {b["tag"]: b for b in counter.bundles if b["tag"] != "merge"}
    assert sorted(done) == sorted(f"lv{lv}_seg{i}" for lv in (2, 1, 0)
                                  for i in range(len(lists[lv])))
    for lv in (2, 1, 0):
        for i, frames in enumerate(lists[lv]):
            b = done[f"lv{lv}_seg{i}"]
            assert b["frames"] == [frames[0], frames[-1]]
            assert 0 < b["live"] <= b["capacity"]
    merges = [b for b in counter.bundles if b["tag"] == "merge"]
    assert [m["frames"] for m in merges] == [
        [lists[1][0][0], lists[1][0][-1]], [lists[1][1][0], lists[1][1][-1]],
        [0, N_FRAMES - 1]]
    assert root.to_visit_frames == list(range(N_FRAMES))

    summary = tr.timer.summary()
    assert summary["merge"]["count"] == 3
    # MSS phase 1 at both non-leaf levels: two level-1 segments, the root
    assert summary["nonleaf_phase1"]["count"] == 3
    assert summary["nonleaf_phase2"]["count"] == 3
    assert summary["leaf"]["count"] == 4

    # each frame's pose chains from the one before it by Phase A's relative
    # pose, across both levels' merge boundaries (the JAX rule)
    for f in range(1, N_FRAMES):
        rel = tr.pose_dict[f"rel_pose_{f - 1}_to_{f}"]
        np.testing.assert_array_equal(
            root.poses[f], (rel @ root.poses[f - 1]).astype(np.float32))
    np.testing.assert_array_equal(root.poses[0], np.eye(4, dtype=np.float32))

    assert tr.evaluate_on_training_images(save_images=False) > 18.0


def test_level2_root_checkpoint_loads_in_jax(level2):
    tr, root, _ = level2
    jt = j_hier.HTGaussianTrainer.__new__(j_hier.HTGaussianTrainer)
    jb = jt.load_checkpoint(os.path.join(tr.result_path, "chkpnt",
                                         "model.npz"))
    for f in PARAM_FIELDS + ("live", "grad_accum", "active_sh_degree"):
        np.testing.assert_array_equal(np.asarray(getattr(jb.state, f)),
                                      getattr(root.state, f).numpy())
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(jb.opt.m[f]),
                                      root.opt.m[f].numpy())
    np.testing.assert_array_equal(jb.poses, root.poses)
    assert jb.radius == root.radius


def test_photo_packaged_without_matplotlib(tmp_path, monkeypatch):
    """The packaged photograph is matplotlib's file byte for byte, and the
    photo scene is built with matplotlib unimportable."""
    import matplotlib

    src = os.path.join(matplotlib.get_data_path(), "sample_data",
                       "grace_hopper.jpg")
    with open(src, "rb") as a, open(t_photo.PHOTO, "rb") as b:
        assert a.read() == b.read()
    want = j_photo._load_photo()

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401,F811
    np.testing.assert_array_equal(t_photo._load_photo(), want)
    poses, K = t_photo.write_dataset(str(tmp_path), n_frames=2, height=24,
                                     width=32)
    assert poses.shape == (2, 4, 4) and np.isfinite(K).all()
    assert sorted(os.listdir(tmp_path / "train")) == ["r_000.png",
                                                       "r_001.png"]



def test_root_step_at_training_tile_args(level2):
    """A few tiled steps of the root (the trainer's own host_train_step) at a
    small K, then the eval sweep, which grows K past it: the counter holds
    the last step's tile arguments, and the root step the tools time takes
    them, not the sweep's."""
    tr, root, _ = level2
    saved = tr._mode, tr._tile_args
    bundle = t_hier.ModelBundle(**{f: getattr(root, f) for f in (
        "state", "opt", "radius", "spatial_scale", "poses")})
    cam = tr.camera_for(0, pose=bundle.get_RT(0))
    gt = tr.device_frame("rgb", 0)
    counter = StepCounter()
    originals = counter.wrap_steps()
    try:
        tr._mode = "tiled"
        tr._tile_args = (("dup_factor", 32), ("max_per_tile", 4))
        for it in (1, 2):
            tr.host_train_step(bundle, cam, gt, it, densify=False,
                               reset=False)
        trained = dict(tr._tile_args)
        t_evals.settle_eval_tile_args(tr, bundle.state, cam)
        swept = dict(tr._tile_args)
        StepCounter.restore(originals)
        originals = []
        assert counter.steps[None] == 2
        assert counter.train_tile_args == trained == counter.tile_args[None]
        assert swept["max_per_tile"] > trained["max_per_tile"]

        args = profiling.root_tile_args(tr, counter)
        assert args == {"train": trained, "eval": swept}
        step = profiling.root_step(tr, bundle)
        timed = StepCounter()
        originals = timed.wrap_steps()
        t_step.gaussian_train_step(**step, tile_args=args["train"])
    finally:
        StepCounter.restore(originals)
        tr._mode, tr._tile_args = saved
    assert timed.train_tile_args["max_per_tile"] == trained["max_per_tile"]
    # the timed step ran on copies: the bundle is not stepped
    assert step["state"].means is not bundle.state.means
    assert torch.equal(step["state"].means, bundle.state.means)


def test_blend_work_counts():
    """blend_work's counts on ragged tiles (counts 0, 1, K and past K;
    opaque entries that stop pixels early) against a count entry by entry
    from the plain forward's ncon."""
    rng = np.random.default_rng(5)
    T, K, th, tw = 4, 6, 4, 4
    P = th * tw
    meta = np.array([[0, 0, 0, 0], [1, 4, 0, 0], [K, 0, 4, 0],
                     [K + 3, 4, 4, 0]], np.int32)
    ent = np.zeros((T, K, 16), np.float32)
    ent[..., 0:2] = meta[:, None, 1:3] + rng.uniform(-2, 6, (T, K, 2))
    ent[..., 2], ent[..., 4] = 0.5, 0.5
    ent[..., 5:8] = rng.random((T, K, 3))
    ent[..., 8] = 0.3
    ent[..., 9] = rng.uniform(1, 5, (T, K))
    # tiles 2 and 3: two flat opaque entries, then in tile 2 a third that
    # stops every pixel; in tile 3 a pixel stops at the first entry after
    # them that reaches it
    ent[2:, :3, 2], ent[2:, :3, 4], ent[2:, :3, 8] = 1e-4, 1e-4, 0.99
    ent[3, 2, 2], ent[3, 2, 4] = 0.5, 0.5
    ent_t, meta_t = torch.from_numpy(ent), torch.from_numpy(meta)
    ncon = blend_fwd_plain(ent_t, meta_t, th, tw)[3]
    got = profiling.blend_work(ent_t, meta_t, ncon, P)

    nc = ncon.numpy().astype(int)
    assert (nc[2] == 2).all() and len(np.unique(nc[3])) > 2
    n_eval = n_kept = n_slot = rows = 0
    for t in range(T):
        c = min(int(meta[t, 0]), K)
        rows += c
        last = 0
        for p in range(P):
            for k in range(c):
                n_eval += 1          # entry k evaluated at pixel p
                if k == nc[t, p]:
                    break            # it stopped the pixel
                n_kept += 1
                last = max(last, k + 1)
        n_slot += last * P
    assert got["n_eval"] == n_eval
    assert got["n_kept"] == n_kept
    assert got["n_slot"] == n_slot
    assert got["fwd_bytes"] == rows * 64 + T * 16 + T * P * 6 * 4
    assert got["bwd_bytes"] == (n_slot // P) * 64 + T * 16 + T * P * 7 * 4 \
        + T * K * 64
