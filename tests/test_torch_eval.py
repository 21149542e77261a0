"""ht3dgs_torch's eval modes against ht3dgs on the CPU: the novel-view
trajectory, LPIPS, eval_pose, eval_nvs end to end (test-time pose fits of
every frame, then PSNR/SSIM per frame) on one model.npz the port wrote,
the frozen model during eval_nvs, render_nvs, and PLY files both ways."""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ht3dgs.data import ply as j_ply  # noqa: E402
from ht3dgs.eval import metrics as j_metrics  # noqa: E402
from ht3dgs.eval import traj as j_traj  # noqa: E402
from ht3dgs.train import evals as j_evals  # noqa: E402
from ht3dgs.train import hierarchy as j_hier  # noqa: E402
from ht3dgs.utils.config import load_configs as j_load_configs  # noqa: E402
from ht3dgs_torch import interop  # noqa: E402
from ht3dgs_torch.core import adam as t_adam  # noqa: E402
from ht3dgs_torch.core import se3 as t_se3  # noqa: E402
from ht3dgs_torch.core.gaussians import PARAM_FIELDS  # noqa: E402
from ht3dgs_torch.data import ply as t_ply  # noqa: E402
from ht3dgs_torch.eval import metrics as t_metrics  # noqa: E402
from ht3dgs_torch.eval import traj as t_traj  # noqa: E402
from ht3dgs_torch.train import evals as t_evals  # noqa: E402
from ht3dgs_torch.train import hierarchy as t_hier  # noqa: E402
from ht3dgs_torch.utils import synthetic  # noqa: E402
from ht3dgs_torch.utils.config import load_configs  # noqa: E402

from port_utils import STATE_FIELDS, jax_state, rich_scene  # noqa: E402
from port_utils import torch_threads_per_worker  # noqa: E402,F401

H, W, FRAMES = 40, 56, 8


def _np(x):
    return x.detach().cpu().numpy()


def _random_pose_chain(n, seed, sigma=0.05):
    rng = np.random.default_rng(seed)
    d = torch.tensor(rng.normal(0, sigma, (n, 6)), dtype=torch.float32)
    return _np(t_se3.se3_to_matrix(t_se3.se3_exp(d)))


@pytest.mark.parametrize("n_frames,n_novel", [(2, 7), (16, 120)])
def test_interp_poses_bspline_matches_jax(n_frames, n_novel):
    c2ws = np.linalg.inv(_random_pose_chain(n_frames, seed=n_frames))
    ours = t_traj.interp_poses_bspline(c2ws, n_novel)
    ref = j_traj.interp_poses_bspline(c2ws, n_novel)
    assert ours.shape == (n_novel, 4, 4) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def _random_vgg_weights(rng):
    w, cin, ci = {}, 3, 0
    for v in t_metrics._VGG_CFG:
        if v == "M":
            continue
        w[f"conv{ci}_w"] = (rng.standard_normal((v, cin, 3, 3))
                            * np.sqrt(2.0 / (cin * 9))).astype(np.float32)
        w[f"conv{ci}_b"] = (0.01 * rng.standard_normal(v)).astype(np.float32)
        cin, ci = v, ci + 1
    for i, c in enumerate([64, 128, 256, 512, 512]):
        w[f"lin{i}"] = (rng.random((1, c, 1, 1)) * 0.1).astype(np.float32)
    return w


@pytest.fixture
def lpips_weights(tmp_path, monkeypatch):
    path = str(tmp_path / "lpips_vgg.npz")
    np.savez(path, **_random_vgg_weights(np.random.default_rng(0)))
    monkeypatch.setenv("HT3DGS_LPIPS_WEIGHTS", path)
    j_metrics._cached = None
    yield path
    j_metrics._cached = None


@pytest.mark.parametrize("hw", [(32, 32), (48, 64)])
def test_lpips_matches_jax(lpips_weights, hw):
    rng = np.random.default_rng(hw[1])
    img0, img1 = (rng.random(hw + (3,)).astype(np.float32) for _ in range(2))
    ours = t_metrics.lpips(img0, img1, device="cpu")
    ref = j_metrics.lpips(img0, img1)
    assert ours > 0.0
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    assert t_metrics.lpips(torch.from_numpy(img0), torch.from_numpy(img0)) \
        == pytest.approx(0.0, abs=1e-9)


def test_try_lpips_nan_without_weights(monkeypatch, tmp_path):
    monkeypatch.setenv("HT3DGS_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    img = torch.zeros(8, 8, 3)
    assert np.isnan(t_metrics.try_lpips(img, img))
    with pytest.raises(FileNotFoundError):
        t_metrics.lpips(img, img)


def test_eval_pose_matches_jax(tmp_path):
    gt = _random_pose_chain(9, seed=1, sigma=0.2)
    pred = gt.copy()
    pred[:, :3, 3] = 1.7 * pred[:, :3, 3] + 0.01   # another scale, noise
    pred = _random_pose_chain(9, seed=2, sigma=0.01) @ pred
    res, text = [], []
    for pkg, mod in (("torch", t_evals), ("jax", j_evals)):
        os.makedirs(tmp_path / pkg)
        pose_file = str(tmp_path / pkg / "pose.npz")
        np.savez(pose_file, poses_pred=pred)
        tr = types.SimpleNamespace(
            model_cfg=types.SimpleNamespace(pose_path=""),
            result_path=str(tmp_path), gt_poses_w2c=lambda: gt)
        res.append(mod.eval_pose(tr, pose_file=pose_file))
        text.append((tmp_path / pkg / "pose_eval.txt").read_text())
    for k in ("ATE", "RPE_trans_x100", "RPE_rot_deg"):
        assert np.isfinite(res[0][k]) and res[0][k] > 0
        np.testing.assert_allclose(res[0][k], res[1][k], rtol=0, atol=1e-6)
    assert text[0] == text[1]


def _configs(load, d):
    model, pipe, optim = load()
    model.FovX = 1.2
    model.eval = False
    model.source_path = os.path.join(d, "images")
    model.data_type = "images_only"
    model.expname, model.category, model.seq_name = "ev", "s", "x"
    pipe.render_mode = "oracle"
    pipe.depth_provider = "precomputed"
    pipe.depth_dir = os.path.join(d, "depth")
    optim.eval_nvs_epochs = 2
    return model, pipe, optim


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A 300-Gaussian, 8-frame 40x56 synthetic video and a model.npz +
    pose.npz that the port wrote: the true scene at perturbed poses."""
    d = str(tmp_path_factory.mktemp("evalnvs"))
    scene = synthetic.generate(n_frames=FRAMES, height=H, width=W,
                               n_gaussians=300, seed=7, device="cpu")
    synthetic.write_images_only(scene, os.path.join(d, "images"),
                                depth_dir=os.path.join(d, "depth"))
    cwd = os.getcwd()
    os.chdir(d)
    try:
        tr = t_hier.HTGaussianTrainer(os.path.join(d, "images"),
                                      *_configs(load_configs, d),
                                      device="cpu")
    finally:
        os.chdir(cwd)
    tr.result_path = os.path.join(d, tr.result_path)
    poses = _random_pose_chain(FRAMES, seed=0, sigma=0.02) @ scene.poses_w2c
    st = scene.state
    tr.gs_bundle = t_hier.ModelBundle(
        state=st, opt=t_adam.init(st.params()), radius=1.0,
        spatial_scale=1.0, poses=poses.astype(np.float32))
    os.makedirs(os.path.join(tr.result_path, "pose"))
    tr.save_checkpoint()
    return d, tr


def _outputs(tr):
    return (os.path.join(tr.result_path, "chkpnt", "model.npz"),
            os.path.join(tr.result_path, "pose", "pose.npz"),
            os.path.join(tr.result_path, "test", "test.txt"))


def test_eval_nvs_matches_jax(model_dir, monkeypatch):
    """JAX's eval_nvs (batched pose fits, 2 epochs) and the port's on the
    same files: per-frame PSNR within 1e-4 dB, SSIM within 1e-5, and the
    same test.txt layout."""
    d, tr = model_dir
    ckpt, pose_file, test_txt = _outputs(tr)
    ours = tr.eval_nvs(checkpoint=ckpt, pose_file=pose_file)
    text = open(test_txt).read()
    monkeypatch.chdir(d)
    jt = j_hier.HTGaussianTrainer(os.path.join(d, "images"),
                                  *_configs(j_load_configs, d))
    ref = jt.eval_nvs(checkpoint=ckpt, pose_file=pose_file)
    text_j = open(test_txt).read()
    assert len(ours["rows"]) == len(ref["rows"]) == FRAMES
    a, b = np.array(ours["rows"]), np.array(ref["rows"])
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 1], b[:, 1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=0, atol=1e-5)
    assert np.isnan(a[:, 3]).all() and np.isnan(b[:, 3]).all()
    # the fits moved the poses: the perturbed poses render worse
    assert ours["psnr"] > 30.0
    assert [ln.split()[0] for ln in text.splitlines()] == \
        [ln.split()[0] for ln in text_j.splitlines()]


def test_eval_nvs_leaves_the_model_frozen(model_dir, monkeypatch):
    """Every tensor of the checkpoint's state is bit-equal after eval_nvs:
    the pose fits share one model and write nothing into it."""
    d, tr = model_dir
    ckpt, pose_file, _ = _outputs(tr)
    loaded = {}
    load = tr.load_checkpoint

    def spy(path):
        b = load(path)
        loaded["state"] = b.state
        loaded["before"] = {f: getattr(b.state, f).clone()
                            for f in STATE_FIELDS}
        return b

    monkeypatch.setattr(tr, "load_checkpoint", spy)
    res = tr.eval_nvs(checkpoint=ckpt, pose_file=pose_file)
    assert np.isfinite(res["psnr"])
    for f, before in loaded["before"].items():
        assert torch.equal(getattr(loaded["state"], f), before), f


def test_render_nvs_writes_frames(model_dir):
    d, tr = model_dir
    ckpt, pose_file, _ = _outputs(tr)
    out = tr.render_nvs(checkpoint=ckpt, pose_file=pose_file, n_novel=6)
    img_dir = os.path.join(tr.result_path, "nvs", "bspline", "img_out")
    names = sorted(os.listdir(img_dir))
    assert names == [f"{i:04d}.png" for i in range(6)]
    assert out.endswith(".mp4") or out == os.path.dirname(img_dir)
    from PIL import Image

    img = np.asarray(Image.open(os.path.join(img_dir, names[0])))
    assert img.shape == (H, W, 3) and img.std() > 1.0


def test_ply_both_ways(tmp_path):
    """The port's PLY and JAX's are the same bytes for the same state, and
    each package reads the other's to equal arrays."""
    arrs = rich_scene(64, seed=4)
    t_state = interop.state_from_numpy(arrs, device="cpu")
    t_path, j_path = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    t_ply.save_ply(t_state, t_path)
    j_ply.save_ply(jax_state(arrs), j_path)
    assert open(t_path, "rb").read() == open(j_path, "rb").read()

    j_read = j_ply.load_ply(t_path, max_sh_degree=3, capacity=80)
    t_read = t_ply.load_ply(j_path, max_sh_degree=3, capacity=80,
                            device="cpu")
    assert t_read.capacity == 80 and int(t_read.n_live()) == 60
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(_np(getattr(t_read, f)),
                                      np.asarray(getattr(j_read, f)),
                                      err_msg=f)
    live = arrs["live"]
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(_np(getattr(t_read, f))[:60],
                                      arrs[f][live], err_msg=f)
