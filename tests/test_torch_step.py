"""ht3dgs_torch.train against ht3dgs.train on the CPU: one
gaussian_train_step of each Adam flavour and one pose_train_step through
the tiled renderer, on the same synthetic scene carried across with
ht3dgs_torch.interop; and the npz checkpoint the JAX trainer writes.

Adam after one step from zero moments moves every parameter by about ±lr
for ANY nonzero gradient (eps 1e-15), so gradient noise at 1e-12 can flip
it: new parameters are compared where |g| > 1e-6 max|g| on both sides, and
elsewhere only held to |Δ| <= 2 lr. The gradients themselves are compared
through the first moments (m = 0.1 g)."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ht3dgs.core import adam as j_adam  # noqa: E402
from ht3dgs.core import gaussians as G  # noqa: E402
from ht3dgs.core.camera import intrinsics_from_fov, make_camera  # noqa: E402
from ht3dgs.train import hierarchy as j_hier  # noqa: E402
from ht3dgs.train import step as j_step  # noqa: E402
from ht3dgs_torch import interop  # noqa: E402
from ht3dgs_torch.core import adam as t_adam  # noqa: E402
from ht3dgs_torch.train import step as t_step  # noqa: E402

from port_utils import camera_arrays, jax_state, rich_scene  # noqa: E402

H, W = 48, 64
TILE_ARGS = dict(tile_h=16, tile_w=16, max_per_tile=128, dup_factor=8)
LRS = dict(means=1e-3, quats=1e-3, log_scales=5e-3, sh_dc=2.5e-3,
           sh_rest=1.25e-4, opacity_logit=0.05)


@pytest.fixture(scope="module")
def scene():
    arrs = rich_scene(160, seed=0)
    cam = make_camera(H, W, intrinsics_from_fov(1.2, H, W))
    rng = np.random.default_rng(5)
    gt = rng.random((H, W, 3)).astype(np.float32)
    return arrs, cam, gt


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close_rel(a, b, rel, name):
    """|a - b| <= rel * max|b| (a field's tolerance scales with its max)."""
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rel * max(np.abs(b).max(), 1e-30),
                               err_msg=name)


def _adam_rule(p_new_t, p_new_j, p_old, g_t, g_j, lr, name):
    """New parameters agree where both gradients are above 1e-6 of the
    field's max; elsewhere both moved by at most 2 lr."""
    p_new_t, p_new_j, p_old, g_t, g_j = map(
        _np, (p_new_t, p_new_j, p_old, g_t, g_j))
    thr = 1e-6 * np.abs(g_j).max()
    big = (np.abs(g_j) > thr) & (np.abs(g_t) > thr)
    np.testing.assert_allclose(p_new_t[big], p_new_j[big], rtol=0,
                               atol=1e-6, err_msg=name)
    for p in (p_new_t, p_new_j):
        assert (np.abs(p - p_old)[~big] <= 2 * lr).all(), name


@pytest.mark.parametrize("apply_adam", ["all", "skip", "no_opacity"])
def test_gaussian_train_step(scene, apply_adam):
    arrs, cam, gt = scene
    js = jax_state(arrs)
    j_opt = j_adam.init(js.params())
    js2, j_opt2, jm = j_step.gaussian_train_step(
        js, j_opt, cam, jnp.asarray(gt),
        {k: jnp.asarray(v) for k, v in LRS.items()}, mode="tiled",
        apply_adam=apply_adam, tile_args=tuple(sorted(TILE_ARGS.items())))

    ts = interop.state_from_numpy(arrs, "cpu")
    tc = interop.camera_from_numpy(camera_arrays(cam), "cpu")
    t_opt = t_adam.init(ts.params())
    ts2, t_opt2, tm = t_step.gaussian_train_step(
        ts, t_opt, tc, torch.tensor(gt), LRS, mode="tiled",
        apply_adam=apply_adam, tile_args=TILE_ARGS)

    np.testing.assert_allclose(_np(tm["loss"]), _np(jm["loss"]), rtol=1e-5)
    for k in ("loss_rgb", "loss_dssim", "psnr"):
        np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for k in ("n_visible", "n_dropped", "n_dropped_m", "n_dropped_tile"):
        assert int(tm[k]) == int(jm[k]), k
    for f in ("grad_accum", "max_radii2d"):
        _close_rel(getattr(ts2, f), getattr(js2, f), 1e-4, f)
    np.testing.assert_array_equal(_np(ts2.grad_denom), _np(js2.grad_denom))

    assert int(t_opt2.step) == int(j_opt2.step)
    for f in G.PARAM_FIELDS:
        if apply_adam == "skip":
            np.testing.assert_array_equal(_np(getattr(ts2, f)), arrs[f])
            continue
        assert np.abs(_np(j_opt2.m[f])).max() > 0 or (
            apply_adam == "no_opacity" and f == "opacity_logit"), f
        _close_rel(t_opt2.m[f], j_opt2.m[f], 1e-4, f"m {f}")
        _close_rel(t_opt2.v[f], j_opt2.v[f], 2e-4, f"v {f}")
        _adam_rule(getattr(ts2, f), getattr(js2, f), arrs[f], t_opt2.m[f],
                   j_opt2.m[f], LRS[f], f)


def test_pose_train_step_and_render_eval(scene):
    arrs, cam, _ = scene
    js = jax_state(arrs)
    ts = interop.state_from_numpy(arrs, "cpu")
    tc = interop.camera_from_numpy(camera_arrays(cam), "cpu")
    ta = tuple(sorted(TILE_ARGS.items()))
    true_pose = np.asarray([0.03, -0.02, 0.01, 0.0, 0.02, 0.0, 1.0],
                           np.float32)
    true_pose[3:] /= np.linalg.norm(true_pose[3:])
    j_gt = j_step.render_eval(js, cam, jnp.asarray(true_pose), mode="tiled",
                              tile_args=ta)
    t_gt = t_step.render_eval(ts, tc, torch.tensor(true_pose), mode="tiled",
                              tile_args=TILE_ARGS)
    np.testing.assert_allclose(_np(t_gt["image"]), _np(j_gt["image"]),
                               atol=3e-5)

    base = np.asarray([0, 0, 0, 0, 0, 0, 1], np.float32)
    delta = np.zeros(6, np.float32)
    lr = 1e-3
    jd, j_opt, jm = j_step.pose_train_step(
        js, jnp.asarray(delta), jnp.asarray(base), j_step.init_pose_opt(),
        cam, j_gt["image"], jnp.asarray(lr), mode="tiled", tile_args=ta)
    td, t_opt, tm = t_step.pose_train_step(
        ts, torch.tensor(delta), torch.tensor(base),
        t_step.init_pose_opt("cpu"), tc, t_gt["image"], lr, mode="tiled",
        tile_args=TILE_ARGS)
    np.testing.assert_allclose(_np(tm["loss"]), _np(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(_np(tm["grad_norm"]), _np(jm["grad_norm"]),
                               rtol=1e-4)
    _close_rel(t_opt.m["pose"], j_opt.m["pose"], 1e-4, "m pose")
    _adam_rule(td, jd, delta, t_opt.m["pose"], j_opt.m["pose"], lr, "pose")


def test_checkpoint_npz_from_jax_trainer(tmp_path, scene):
    """The npz that HTGaussianTrainer.save_checkpoint writes loads into the
    port with every array intact."""
    arrs, _, _ = scene
    js = jax_state(arrs)
    rng = np.random.default_rng(3)
    opt = j_adam.AdamState(
        m={f: jnp.asarray(rng.standard_normal(arrs[f].shape), jnp.float32)
           for f in G.PARAM_FIELDS},
        v={f: jnp.asarray(rng.random(arrs[f].shape), jnp.float32)
           for f in G.PARAM_FIELDS},
        step=jnp.asarray(7, jnp.int32))
    poses = rng.standard_normal((3, 4, 4)).astype(np.float32)
    bundle = j_hier.ModelBundle(state=js, opt=opt, radius=2.5,
                                spatial_scale=1.5, poses=poses)
    trainer = types.SimpleNamespace(
        gs_bundle=bundle, result_path=str(tmp_path), seq_len=3,
        pose_dict={}, logger=types.SimpleNamespace(info=lambda *_: None),
        save_pose_dict=lambda *_: None)
    path = str(tmp_path / "model.npz")
    j_hier.HTGaussianTrainer.save_checkpoint(trainer, path)

    ts, t_opt, extras = interop.load_checkpoint_npz(path, "cpu")
    for f in G.PARAM_FIELDS + ("live", "max_radii2d", "grad_accum",
                               "grad_denom", "active_sh_degree"):
        np.testing.assert_array_equal(_np(getattr(ts, f)),
                                      _np(getattr(js, f)), err_msg=f)
        if f in G.PARAM_FIELDS:
            np.testing.assert_array_equal(_np(t_opt.m[f]), _np(opt.m[f]))
            np.testing.assert_array_equal(_np(t_opt.v[f]), _np(opt.v[f]))
    assert ts.max_sh_degree == js.max_sh_degree
    assert int(t_opt.step) == 7
    np.testing.assert_array_equal(extras["poses"], poses)
    assert (extras["radius"], extras["spatial_scale"]) == (2.5, 1.5)
