"""ht3dgs_torch's multi-rank trainer on gloo CPU ranks (port only: no JAX
hierarchical_training or batched fit is compiled here).

- hierarchical_training on a 2 x 2 mesh of 4 ranks (tests/
  test_parallel_nonleaf.py's train_level 2 setting at 24x32 px,
  with its budgets cut to keep the run short): the ranks end
  bit-equal, the root covers every frame and passes the PSNR gate, a run
  ended after its leaves and resumed from its crumbs ends where the
  uninterrupted run did, and the JAX package loads the root's model.npz.
  Each rank works in a directory of its own, as on hosts that share no
  disk: only rank 0's holds the crumbs and Phase A's poses;
- `ht3dgs_torch.run.main(["--distributed", ...], device="cpu")` on 2
  ranks with a 2 x 2 mesh configured, which the world is too small for:
  the leaves take the sequential path (the root's 1 x 2 mesh fits), and
  Phase A is dealt over the 2 ranks with its poses bit-equal to one
  process's.

Each rank pool starts once per module through ht3dgs_torch's spawn, one
torch thread per rank, bounded to 120 s."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ht3dgs.train import hierarchy as j_hier  # noqa: E402
from ht3dgs_torch.core.gaussians import PARAM_FIELDS  # noqa: E402
from ht3dgs_torch.parallel import checks  # noqa: E402
from ht3dgs_torch.parallel import mesh as t_mesh  # noqa: E402
from ht3dgs_torch.train import hierarchy as t_hier  # noqa: E402
from ht3dgs_torch.utils import synthetic  # noqa: E402
from ht3dgs_torch.utils.config import load_configs  # noqa: E402

from port_utils import torch_threads_per_worker  # noqa: E402,F401

FRAMES, H, W = 12, 24, 32


def _video(d, n_frames, h, w, n_gaussians):
    scene = synthetic.generate(n_frames=n_frames, height=h, width=w,
                               n_gaussians=n_gaussians, seed=5, device="cpu")
    img = synthetic.write_images_only(scene, os.path.join(d, "images"),
                                      depth_dir=os.path.join(d, "depth"))
    return img, os.path.join(d, "depth")


def mesh_cfg(img_dir, depth_dir, expname="mesh"):
    """tests/test_parallel_nonleaf.py's configuration (train_level 2, a
    (2, 2) mesh, oracle renders) with its Phase A budgets (30 / 20), leaf
    init (30), steps per frame (10), recovery (4) and init points (300)
    cut to 12 / 8, 12, 5, 3 and 100."""
    model, pipe, optim = load_configs()
    model.FovX = 1.2
    model.eval = False
    model.source_path = img_dir
    model.data_type = "images_only"
    model.expname, model.category, model.seq_name = expname, "synt", "a"
    pipe.train_level = 2
    pipe.render_mode = "oracle"
    pipe.capacity_presize = 2.0
    pipe.depth_provider = "precomputed"
    pipe.depth_dir = depth_dir
    pipe.vfi_provider = "blend"
    pipe.init_max_points = 100
    pipe.mesh_segments = 2
    pipe.mesh_tiles = 2
    optim.single_step = 5
    optim.phase_a_fit_iters = 12
    optim.phase_a_pose_iters = 8
    optim.leaf_init_iters = 12
    optim.reset_recovery_iters = 3
    optim.mss_phase1_iteration_per_frame = 2
    optim.num_iterations_per_frame_each_level = [4, 4, 4]
    optim.densification_interval = 40
    optim.densification_interval_leaf = 40
    optim.densify_from_iter = 15
    return model, pipe, optim


def train_and_resume(tmp_path_factory, world, n_frames=FRAMES):
    d = str(tmp_path_factory.mktemp(f"mesh{world}"))
    img, depth = _video(d, n_frames, H, W, 200)
    a, c = zip(*t_mesh.spawn(checks.train_and_resume, world, device="cpu",
                             args=(img, d, mesh_cfg(img, depth)),
                             timeout=120.0))
    return a, c


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return train_and_resume(tmp_path_factory, 4)


def assert_resumed(a, c):
    """The resumed run (c) ends with the uninterrupted run's (a) root,
    poses and generator on every rank, though the stopped run left its
    resume files in rank 0's directory alone."""
    assert any(f.startswith("chkpnt") for f in c[0]["resume_files"])
    assert "pose/pose_partial.npz" in c[0]["resume_files"]
    for rc in c[1:]:
        assert rc["resume_files"] == []
    for ra, rc in zip(a, c):
        assert rc["digest"] == ra["digest"]
        np.testing.assert_array_equal(rc["poses"], ra["poses"])
        np.testing.assert_array_equal(rc["gen"], ra["gen"])
        assert rc["global_iteration"] == ra["global_iteration"]


def test_hierarchy_2x2_ranks_bit_equal(four):
    a, _ = four
    assert len({r["digest"] for r in a}) == 1
    for r in a[1:]:
        np.testing.assert_array_equal(r["poses"], a[0]["poses"])
        np.testing.assert_array_equal(r["gen"], a[0]["gen"])
        assert r["global_iteration"] == a[0]["global_iteration"]
        assert r["pose_dict"].keys() == a[0]["pose_dict"].keys()
        for k, v in r["pose_dict"].items():
            np.testing.assert_array_equal(v, a[0]["pose_dict"][k])
    root = a[0]
    assert root["frames"] == list(range(FRAMES))
    assert np.all(np.isfinite(root["poses"]))
    live = root["state"]["live"]
    assert np.all(np.isfinite(root["state"]["means"][live]))
    # the leaves, level 1 and the root's tile-split image ran on the mesh
    assert {"leaf_parallel", "nonleaf_parallel", "merge"} <= set(
        root["phases"])
    assert not {"leaf", "nonleaf_phase1", "nonleaf_phase2"} & set(
        root["phases"])
    assert root["psnr"] > 10.5      # test_parallel_nonleaf.py's gate


def test_hierarchy_2x2_crumb_resume(four):
    """A run ended after its leaf chunks and merges, then resumed from the
    crumbs in rank 0's directory, ends with the uninterrupted run's root
    on every rank."""
    assert_resumed(*four)


def test_hierarchy_2x2_root_loads_in_jax(four):
    a, _ = four
    ckpt = os.path.join(a[0]["result_path"], "chkpnt", "model.npz")
    jb = j_hier.HTGaussianTrainer.__new__(
        j_hier.HTGaussianTrainer).load_checkpoint(ckpt)
    for f in PARAM_FIELDS + ("live",):
        np.testing.assert_array_equal(np.asarray(getattr(jb.state, f)),
                                      a[0]["state"][f])
    np.testing.assert_array_equal(jb.poses, a[0]["poses"])


def _cli_args(img, depth, config):
    return [
        "--config", config, "--data_path_train", img,
        "--data_type_train", "images_only",
        "--FovX", "1.2", "--no-eval", "--expname", "dist", "--category",
        "s", "--seq_name", "x", "--train_level", "1", "--render_mode",
        "oracle", "--depth_provider", "precomputed", "--depth_dir", depth,
        "--vfi_provider", "blend", "--multi_source_supervision", "base+vfi",
        "--init_max_points", "120", "--capacity_presize", "2.0",
        "--phase_a_batch", "4", "--single_step", "3",
        "--phase_a_fit_iters", "8", "--phase_a_pose_iters", "5",
        "--leaf_init_iters", "6", "--reset_recovery_iters", "2",
        "--mss_phase1_iteration_per_frame", "1",
        "--mesh_segments", "2", "--mesh_tiles", "2"]


def test_run_main_distributed_two_ranks_sequential(tmp_path):
    """run.main --distributed on 2 ranks of a 2 x 2 mesh configuration:
    the world is smaller than S x T, so the leaves take the sequential
    path (on rank 0, broadcast to rank 1) and the root the 1 x 2 mesh;
    Phase A's 6 pairs are dealt over both ranks, and the poses equal a
    one-process Phase A's bit for bit."""
    d = str(tmp_path)
    img, depth = _video(d, 7, 24, 32, 150)
    config = os.path.join(d, "cfg.yml")
    with open(config, "w") as f:      # a list the command line cannot set
        f.write("OptimizationParams:\n"
                "  num_iterations_per_frame_each_level: [2, 2, 2]\n")
    argv = ["--mode", "train", "--distributed"] + _cli_args(img, depth,
                                                            config)
    t_mesh.spawn(checks.run_main, 2, device="cpu", args=(argv, d),
                 timeout=120.0)
    out = os.path.join(d, "output", "dist", "s_x")
    with open(os.path.join(out, "output.log")) as f:
        log = f.read()
    assert "[mesh] 2 x 2 on 2 ranks: sequential path" in log
    assert "[mesh] 1 x 2 on 2 ranks: mesh path" in log
    with open(os.path.join(out, "phase_timing.json")) as f:
        phases = set(json.load(f))
    assert {"leaf", "nonleaf_parallel"} <= phases
    assert "leaf_parallel" not in phases
    assert "[Phase A/batched] 6 pairs, batch 4, 2 ranks" in log
    with np.load(os.path.join(out, "pose", "pose.npz")) as z:
        dist_poses = dict(z)
    assert os.path.exists(os.path.join(out, "chkpnt", "model.npz"))
    assert dist_poses["poses_pred"].shape == (7, 4, 4)

    # one process, one thread (as each rank), Phase A only
    from ht3dgs_torch.utils.config import configs_from_cli

    model, pipe, optim, _ = configs_from_cli(
        ["--mode", "pose_only", "--expname", "one"]
        + _cli_args(img, depth, config))
    n = torch.get_num_threads()
    cwd = os.getcwd()
    os.chdir(d)
    try:
        torch.set_num_threads(1)
        tr = t_hier.HTGaussianTrainer(img, model, pipe, optim,
                                      device="cpu")
        tr.derive_schedule()
        tr._phase_a()
    finally:
        torch.set_num_threads(n)
        os.chdir(cwd)
    rel = [k for k in tr.pose_dict if k.startswith("rel_pose_")]
    assert len(rel) == 18      # each pair and its two VFI half-steps
    for k in rel:
        np.testing.assert_array_equal(dist_poses[k], tr.pose_dict[k])
