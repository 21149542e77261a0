"""ht3dgs_torch's data layer and utilities against ht3dgs on the CPU:
configs and their fingerprint, the images_only reader, point clouds from
depth, the synthetic scene, PNG output, and the depth / VFI providers."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
PIL_Image = pytest.importorskip("PIL.Image")

from ht3dgs.data import pointcloud as j_pcd  # noqa: E402
from ht3dgs.data import readers as j_readers  # noqa: E402
from ht3dgs.train.hierarchy import HTGaussianTrainer as JTrainer  # noqa: E402
from ht3dgs.utils import config as j_config  # noqa: E402
from ht3dgs.utils import image as j_image  # noqa: E402
from ht3dgs.utils import synthetic as j_synth  # noqa: E402
from ht3dgs_torch.data import depth as t_depth  # noqa: E402
from ht3dgs_torch.data import pointcloud as t_pcd  # noqa: E402
from ht3dgs_torch.data import readers as t_readers  # noqa: E402
from ht3dgs_torch.data import vfi as t_vfi  # noqa: E402
from ht3dgs_torch.train import hierarchy as t_hier  # noqa: E402
from ht3dgs_torch.utils import config as t_config  # noqa: E402
from ht3dgs_torch.utils import image as t_image  # noqa: E402
from ht3dgs_torch.utils import synthetic as t_synth  # noqa: E402

from port_utils import torch_threads_per_worker  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fingerprint(cls, cfgs, lists, seq_len=16, seed=3):
    tr = cls.__new__(cls)
    _, tr.pipe_cfg, tr.optim_cfg = cfgs
    tr.seq_len, tr.seed = seq_len, seed
    return tr._config_fingerprint(lists)


def test_load_configs_and_fingerprint_match_jax():
    path = os.path.join(REPO, "configs", "tanks", "Francis.yml")
    over = {"single_step": 25, "render_mode": "tiled"}
    j = j_config.load_configs(path, over)
    t = t_config.load_configs(path, over)
    for a, b in zip(j, t):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert t[2].single_step == 25 and t[1].train_level == 2
    assert (t_config.resolve_mode_paths(t[0], "eval_pose")
            == j_config.resolve_mode_paths(j[0], "eval_pose"))
    lists = {0: [list(range(16))], 1: [list(range(9)), list(range(8, 16))]}
    fp = _fingerprint(t_hier.HTGaussianTrainer, t, lists)
    assert fp == _fingerprint(JTrainer, j, lists)
    assert fp != _fingerprint(t_hier.HTGaussianTrainer, t, lists, seed=4)
    # the CLI parser takes the same flags
    argv = ["--mode", "pose_only", "--single_step", "7", "--no-eval",
            "--FovX", "1.1"]
    jm, jp, jo, _ = j_config.configs_from_cli(argv)
    tm, tp, to, _ = t_config.configs_from_cli(argv)
    for a, b in ((jm, tm), (jp, tp), (jo, to)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_read_images_only_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(10):
        PIL_Image.fromarray(rng.integers(0, 256, (30, 44, 3), np.uint8)
                            ).save(tmp_path / f"{i:04d}.png")
    j = j_readers.read_images_only(str(tmp_path), 1.2, do_split=True)
    t = t_readers.read_images_only(str(tmp_path), 1.2, do_split=True)
    np.testing.assert_array_equal(t.i_train, j.i_train)
    np.testing.assert_array_equal(t.i_test, j.i_test)
    assert t.nerf_radius == j.nerf_radius
    for a, b in zip(t.train_frames + t.test_frames,
                    j.train_frames + j.test_frames):
        assert (a.image_name, a.width, a.height, a.fovx, a.fovy) == \
            (b.image_name, b.width, b.height, b.fovx, b.fovy)
        np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
        np.testing.assert_array_equal(a.load_image(), b.load_image())
    # a frame handed in memory needs no file
    img = rng.random((30, 44, 3)).astype(np.float32)
    f = t_readers.FrameInfo(uid=0, image_path=None, image_name="m",
                            width=44, height=30,
                            intrinsics=t.train_frames[0].intrinsics,
                            fovx=1.2, fovy=1.0, _image=img)
    assert f.load_image() is img


def test_pcd_from_depth_image_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.random((24, 32, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
    K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
    for down in (True, False):
        j = j_pcd.pcd_from_depth_image(img, depth, K, voxel_size=0.05,
                                       down_sample=down)
        t = t_pcd.pcd_from_depth_image(img, depth, K, voxel_size=0.05,
                                       down_sample=down)
        assert t.points.shape == j.points.shape
        if down:
            assert len(t.points) < 24 * 32

        def rows(p):
            a = np.concatenate([p.points, p.colors], axis=1)
            return a[np.lexsort(a.T[::-1])]

        np.testing.assert_allclose(rows(t), rows(j), rtol=0, atol=1e-6)


def test_synthetic_generate_matches_jax():
    j = j_synth.generate(n_frames=6, height=40, width=56, n_gaussians=200,
                         seed=2)
    t = t_synth.generate(n_frames=6, height=40, width=56, n_gaussians=200,
                         seed=2, device="cpu")
    np.testing.assert_array_equal(t.poses_w2c, j.poses_w2c)
    np.testing.assert_array_equal(t.intrinsics, j.intrinsics)
    np.testing.assert_allclose(t.frames, j.frames, rtol=0, atol=3e-5)
    np.testing.assert_allclose(t.depths, j.depths, rtol=0, atol=3e-4)
    assert t.frames.std() > 0.05


def test_save_image_and_providers(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.random((17, 23, 3)).astype(np.float32)
    gt = rng.random((17, 23, 3)).astype(np.float32)
    j_image.save_image(str(tmp_path / "j" / "a.png"), img, gt_image=gt)
    t_image.save_image(str(tmp_path / "t" / "a.png"), img, gt_image=gt)
    a = np.asarray(PIL_Image.open(tmp_path / "t" / "a.png"))
    b = np.asarray(PIL_Image.open(tmp_path / "j" / "a.png"))
    assert a.shape == (17, 46, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)

    # depth: precomputed .npy maps, clamped at the near plane; VFI blend
    d = rng.uniform(-0.5, 2.0, (17, 23)).astype(np.float32)
    np.save(tmp_path / "f0.npy", d)
    prov = t_depth.make_depth_provider("precomputed",
                                       directory=str(tmp_path))
    np.testing.assert_array_equal(prov(img, "f0"), np.maximum(d, 0.01))
    assert (t_depth.make_depth_provider("constant")(img, "x") == 1).all()
    np.testing.assert_array_equal(
        t_vfi.make_vfi_provider("blend")(img, gt, "0_to_1"), 0.5 * (img + gt))
    assert t_vfi.make_vfi_provider("none") is None
    # IFRNet needs a checkpoint (test_torch_ifrnet runs it with one)
    with pytest.raises(ValueError, match="checkpoint"):
        t_vfi.make_vfi_provider("ifrnet", device="cpu")
