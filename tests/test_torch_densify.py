"""ht3dgs_torch's densify/prune, opacity reset, importance prune and the
SE(3) helpers of the hierarchy against ht3dgs on the CPU, on the same
numpy inputs. The split noise of densify is drawn from JAX's key, as
`ht3dgs.train.densify` draws it, and handed to the port."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ht3dgs.core import adam as j_adam  # noqa: E402
from ht3dgs.core import camera as j_camera  # noqa: E402
from ht3dgs.core import se3 as j_se3  # noqa: E402
from ht3dgs.core import sh as j_sh  # noqa: E402
from ht3dgs.core.gaussians import PARAM_FIELDS  # noqa: E402
from ht3dgs.train import densify as j_densify  # noqa: E402
from ht3dgs_torch import interop  # noqa: E402
from ht3dgs_torch.core import camera as t_camera  # noqa: E402
from ht3dgs_torch.core import se3 as t_se3  # noqa: E402
from ht3dgs_torch.core import sh as t_sh  # noqa: E402
from ht3dgs_torch.train import densify as t_densify  # noqa: E402

from port_utils import jax_state, rich_scene  # noqa: E402
from port_utils import torch_threads_per_worker  # noqa: E402,F401

EXTENT = 3.0


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _densify_inputs(pad: int, seed: int = 0):
    """rich_scene with hot rows (clone and split), low-opacity rows, dead
    rows, random Adam moments, and `pad` dead rows of extra capacity."""
    rng = np.random.default_rng(seed + 7)
    arrs = rich_scene(160, seed=seed)
    n = 160
    arrs["grad_denom"] = rng.integers(0, 4, n).astype(np.float32)
    arrs["grad_accum"] = (rng.uniform(0, 1e-3, n)
                          * arrs["grad_denom"]).astype(np.float32)
    # max scales both sides of percent_dense * extent and 0.1 * extent
    scales = rng.uniform(0.002, 0.045, (n, 3))
    scales[::5] *= 10.0
    arrs["log_scales"] = np.log(scales).astype(np.float32)
    if pad:
        for f in list(arrs):
            x = arrs[f]
            if isinstance(x, np.ndarray) and x.ndim and x.shape[0] == n:
                arrs[f] = np.concatenate(
                    [x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    cap = n + pad
    m = {f: rng.standard_normal(arrs[f].shape).astype(np.float32)
         for f in PARAM_FIELDS}
    v = {f: rng.random(arrs[f].shape).astype(np.float32)
         for f in PARAM_FIELDS}
    return arrs, m, v, cap


def _states(arrs, m, v, step=7):
    js = jax_state(arrs)
    jo = j_adam.AdamState(m={k: jnp.asarray(x) for k, x in m.items()},
                          v={k: jnp.asarray(x) for k, x in v.items()},
                          step=jnp.asarray(step, jnp.int32))
    ts = interop.state_from_numpy(arrs, device="cpu")
    to = interop.adam_from_numpy(m, v, step, device="cpu")
    return js, jo, ts, to


def _same_state(ts, to, js, jo, tol=1e-6):
    np.testing.assert_array_equal(_np(ts.live), np.asarray(js.live))
    for f in PARAM_FIELDS:
        for a, b, name in ((getattr(ts, f), getattr(js, f), f),
                           (to.m[f], jo.m[f], f"m[{f}]"),
                           (to.v[f], jo.v[f], f"v[{f}]")):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                       atol=tol, err_msg=name)
    for f in ("max_radii2d", "grad_accum", "grad_denom"):
        np.testing.assert_array_equal(_np(getattr(ts, f)),
                                      np.asarray(getattr(js, f)))
    assert int(to.step) == int(jo.step)


@pytest.mark.parametrize("pad,use_screen", [(0, False), (0, True),
                                            (200, True)])
def test_densify_and_prune_matches_jax(pad, use_screen):
    arrs, m, v, cap = _densify_inputs(pad)
    js, jo, ts, to = _states(arrs, m, v)
    key = jax.random.PRNGKey(11)
    args = (2e-4, 0.005, EXTENT, 0.01, 20.0)
    js2, jo2, jd = j_densify.densify_and_prune(
        js, jo, key, *[jnp.asarray(a) for a in args],
        jnp.asarray(use_screen))
    # the noise densify_and_prune draws from its key (densify.py:107-112)
    noise = tuple(torch.tensor(np.asarray(
        jax.random.normal(k, (cap, 3), jnp.float32)))
        for k in jax.random.split(key))
    ts2, to2, td = t_densify.densify_and_prune(ts, to, noise, *args,
                                               use_screen)
    assert int(td) == int(jd)
    _same_state(ts2, to2, js2, jo2)
    # the case exercises clones, splits, prunes and (without padding) the
    # capacity overflow
    live = arrs["live"]
    grads = np.where(arrs["grad_denom"] > 0, arrs["grad_accum"]
                     / np.maximum(arrs["grad_denom"], 1.0), 0.0)
    hot = live & (grads >= 2e-4)
    big = np.exp(arrs["log_scales"]).max(1) > 0.01 * EXTENT
    assert (hot & big).any() and (hot & ~big).any()
    assert int(_np(ts2.live).sum()) != int(live.sum())
    assert (int(td) > 0) == (pad == 0)


def test_reset_opacity_matches_jax():
    arrs, m, v, _ = _densify_inputs(0, seed=1)
    js, jo, ts, to = _states(arrs, m, v)
    js2, jo2 = j_densify.reset_opacity(js, jo)
    ts2, to2 = t_densify.reset_opacity(ts, to)
    _same_state(ts2, to2, js2, jo2)


@pytest.mark.parametrize("ratio", [0.5, 0.3])
def test_importance_prune_matches_jax(ratio):
    """Tied importances (zeros, repeated values) and dead rows: the rows
    dropped must be JAX's, exactly."""
    arrs, m, v, _ = _densify_inputs(40, seed=2)
    rng = np.random.default_rng(3)
    imp = (rng.integers(0, 4, arrs["live"].shape[0]) * 0.25
           ).astype(np.float32)
    imp[::7] = 0.0
    js, jo, ts, to = _states(arrs, m, v)
    js2, _ = j_densify.importance_prune(js, jo, jnp.asarray(imp),
                                        jnp.asarray(ratio))
    ts2, to2 = t_densify.importance_prune(ts, to, torch.from_numpy(imp),
                                          ratio)
    np.testing.assert_array_equal(_np(ts2.live), np.asarray(js2.live))
    assert to2 is to
    assert int(_np(ts2.live).sum()) < int(arrs["live"].sum())


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def test_se3_helpers_match_jax():
    rng = np.random.default_rng(4)
    # matrix_to_quat near each of its four branches (w, x, y, z dominant),
    # on the ties between them, and at random
    mats = [_rot([0.3, -0.2, 1.0], 0.4), _rot([1, 0.01, 0.02], 3.1),
            _rot([0.02, 1, 0.01], 3.1), _rot([0.01, 0.02, 1], 3.1),
            _rot([1, 0, 0], np.pi), _rot([0, 1, 0], np.pi),
            _rot([0, 0, 1], np.pi), _rot([1, 1, 1], 2 * np.pi / 3),
            _rot([1, 1, 0], np.pi), np.eye(3)]
    mats += [_rot(rng.standard_normal(3), a)
             for a in rng.uniform(0, np.pi, 20)]
    mats = np.stack(mats).astype(np.float32)
    q_j = np.asarray(j_se3.matrix_to_quat(jnp.asarray(mats)))
    q_t = _np(t_se3.matrix_to_quat(torch.from_numpy(mats)))
    np.testing.assert_allclose(q_t, q_j, rtol=0, atol=1e-6)

    T = np.tile(np.eye(4, dtype=np.float32), (len(mats), 1, 1))
    T[:, :3, :3] = mats
    T[:, :3, 3] = rng.standard_normal((len(mats), 3))
    p_j = j_se3.se3_from_matrix(jnp.asarray(T))
    p_t = t_se3.se3_from_matrix(torch.from_numpy(T))
    np.testing.assert_allclose(_np(p_t), np.asarray(p_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(t_se3.se3_to_matrix(p_t)),
                               np.asarray(j_se3.se3_to_matrix(p_j)),
                               rtol=0, atol=1e-6)
    for alpha in (0.0, 0.3, 0.77, 1.0):
        a = j_se3.se3_interp(p_j[:-1], p_j[1:], alpha)
        b = t_se3.se3_interp(p_t[:-1], p_t[1:], alpha)
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_se3.se3_from_Rt(mats[3], T[3, :3, 3]),
                               j_se3.se3_from_Rt(mats[3], T[3, :3, 3]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        _np(t_se3.se3_identity((2, 3), device="cpu")),
        np.asarray(j_se3.se3_identity((2, 3))))
    assert t_camera.focal2fov(51.5, 56) == j_camera.focal2fov(51.5, 56)
    sh = rng.standard_normal((5, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(t_sh.sh2rgb(torch.from_numpy(sh))),
                               np.asarray(j_sh.sh2rgb(jnp.asarray(sh))),
                               rtol=0, atol=1e-7)
