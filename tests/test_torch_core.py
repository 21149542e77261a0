"""ht3dgs_torch.core against ht3dgs.core on the CPU: SH, camera, SE(3)
(values and autograd gradients), Gaussian state init and Adam."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ht3dgs.core import adam as j_adam  # noqa: E402
from ht3dgs.core import camera as j_cam  # noqa: E402
from ht3dgs.core import gaussians as j_g  # noqa: E402
from ht3dgs.core import se3 as j_se3  # noqa: E402
from ht3dgs.core import sh as j_sh  # noqa: E402
from ht3dgs_torch.core import adam as t_adam  # noqa: E402
from ht3dgs_torch.core import camera as t_cam  # noqa: E402
from ht3dgs_torch.core import gaussians as t_g  # noqa: E402
from ht3dgs_torch.core import se3 as t_se3  # noqa: E402
from ht3dgs_torch.core import sh as t_sh  # noqa: E402

from port_utils import torch_threads_per_worker  # noqa: E402,F401


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _grad(t):
    """A leaf's gradient; zeros where autograd found it unused."""
    return np.zeros(t.shape, np.float32) if t.grad is None else _np(t.grad)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_values_and_grads(deg):
    rng = np.random.default_rng(deg)
    sh = rng.standard_normal((50, 16, 3)).astype(np.float32)
    d = rng.standard_normal((50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mask = np.asarray(j_sh.sh_degree_mask(jnp.asarray(deg), 3))
    np.testing.assert_array_equal(_np(t_sh.sh_degree_mask(deg, 3)), mask)
    np.testing.assert_array_equal(
        _np(t_sh.sh_degree_mask(torch.tensor(deg), 3)), mask)

    def j_f(s, x):
        return jnp.sum(j_sh.eval_sh(deg, s, x) ** 2)

    j_val, (j_gs, j_gd) = jax.jit(lambda s, x: (
        j_sh.eval_sh(deg, s, x), jax.grad(j_f, argnums=(0, 1))(s, x)))(
        jnp.asarray(sh), jnp.asarray(d))
    ts = torch.tensor(sh, requires_grad=True)
    td = torch.tensor(d, requires_grad=True)
    t_val = t_sh.eval_sh(deg, ts, td)
    (t_val ** 2).sum().backward()
    np.testing.assert_allclose(_np(t_val), _np(j_val), atol=1e-5)
    np.testing.assert_allclose(_grad(ts), _np(j_gs), atol=1e-4)
    np.testing.assert_allclose(_grad(td), _np(j_gd), atol=1e-4)
    rgb = rng.random((7, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(t_sh.rgb2sh(torch.tensor(rgb))),
                               _np(j_sh.rgb2sh(rgb)), rtol=1e-6)


def test_camera_matches():
    rng = np.random.default_rng(0)
    h, w = 37, 53
    K = t_cam.intrinsics_from_fov(1.1, h, w, fovy=0.9)
    np.testing.assert_array_equal(K, j_cam.intrinsics_from_fov(1.1, h, w,
                                                               fovy=0.9))
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32)
    T = rng.standard_normal(3).astype(np.float32)
    jc = j_cam.make_camera(h, w, K, R=R, T=T)
    tc = t_cam.make_camera(h, w, K, R=R, T=T, device="cpu")
    for name in ("full_proj", "camera_center", "tan_half_fovx",
                 "tan_half_fovy"):
        np.testing.assert_allclose(_np(getattr(tc, name)),
                                   _np(getattr(jc, name)), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert (tc.height, tc.width) == (h, w)


def _poses(rng, n):
    t = rng.standard_normal((n, 3)).astype(np.float32)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return np.concatenate([t, q / np.linalg.norm(q, axis=1, keepdims=True)],
                          axis=1)


def _tangents(rng, n):
    tau = (0.5 * rng.standard_normal((n, 6))).astype(np.float32)
    tau[0] = 0.0                 # identity: the Taylor branches
    tau[1, 3:] = 1e-6            # tiny rotation
    return tau


@pytest.mark.parametrize("name", ["quat_mul", "quat_rotate", "so3_exp",
                                  "so3_log", "se3_exp", "se3_log", "se3_act",
                                  "se3_inv", "se3_mul", "se3_retr"])
def test_se3_values_and_grads(name):
    """Values and autograd gradients of sum(f(...)^2), including the
    identity tangent, where a NaN from the unselected branch of a `where`
    would show."""
    rng = np.random.default_rng(len(name))
    n = 16
    q = _poses(rng, n)[:, 3:]
    args = {
        "quat_mul": (q, _poses(rng, n)[:, 3:]),
        "quat_rotate": (q, rng.standard_normal((n, 3)).astype(np.float32)),
        "so3_exp": (_tangents(rng, n)[:, 3:],),
        "so3_log": (np.asarray(j_se3.so3_exp(_tangents(rng, n)[:, 3:])),),
        "se3_exp": (_tangents(rng, n),),
        "se3_log": (np.asarray(j_se3.se3_exp(_tangents(rng, n))),),
        "se3_act": (_poses(rng, n),
                    rng.standard_normal((n, 3)).astype(np.float32)),
        "se3_inv": (_poses(rng, n),),
        "se3_mul": (_poses(rng, n), _poses(rng, n)),
        "se3_retr": (_tangents(rng, n), _poses(rng, n)),
    }[name]
    jf, tf = getattr(j_se3, name), getattr(t_se3, name)
    j_val, j_grads = jax.jit(lambda *a: (jf(*a), jax.grad(
        lambda *b: jnp.sum(jf(*b) ** 2), argnums=tuple(range(len(a))))(*a)))(
        *map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    t_val = tf(*targs)
    (t_val ** 2).sum().backward()
    np.testing.assert_allclose(_np(t_val), _np(j_val), atol=2e-5)
    for ta, jg in zip(targs, j_grads):
        assert np.isfinite(_grad(ta)).all()
        np.testing.assert_allclose(_grad(ta), _np(jg), atol=1e-4,
                                   rtol=1e-4)


def test_create_from_pcd_and_sh_degree():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((300, 3)).astype(np.float32)
    cols = rng.random((300, 3)).astype(np.float32)
    js = j_g.create_from_pcd(pts, cols, capacity=320)
    ts = t_g.create_from_pcd(pts, cols, capacity=320, device="cpu")
    for f in j_g.PARAM_FIELDS + ("live", "max_radii2d", "grad_accum",
                                 "grad_denom"):
        np.testing.assert_allclose(_np(getattr(ts, f)), _np(getattr(js, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    assert ts.max_sh_degree == js.max_sh_degree == 3
    for _ in range(4):
        js = j_g.oneup_sh_degree(js)
        ts = t_g.oneup_sh_degree(ts)
        assert int(ts.active_sh_degree) == int(js.active_sh_degree)
    np.testing.assert_allclose(_np(ts.opacities()), _np(js.opacities()),
                               rtol=1e-6)


def test_adam_ten_steps_with_row_surgery():
    """Both sides get the same gradients: 10 steps, a zero_rows after the
    4th and a permute_rows after the 7th; a zero learning rate freezes."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((12, 3)).astype(np.float32),
          "b": rng.standard_normal((12, 1)).astype(np.float32)}
    lrs = {"a": 1e-2, "b": 0.0}
    mask = np.arange(12) % 3 == 0
    perm = rng.permutation(12)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    jst, tst = j_adam.init(jp), t_adam.init(tp)
    for i in range(10):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p0.items()}
        jp, jst = j_adam.apply(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jst,
            {k: jnp.asarray(v) for k, v in lrs.items()})
        tp, tst = t_adam.apply(tp, {k: torch.tensor(v) for k, v in g.items()},
                               tst, lrs)
        if i == 3:
            jst = j_adam.zero_rows(jst, jnp.asarray(mask))
            tst = t_adam.zero_rows(tst, torch.tensor(mask))
        if i == 6:
            jst = j_adam.permute_rows(jst, jnp.asarray(perm))
            tst = t_adam.permute_rows(tst, torch.tensor(perm))
    assert int(tst.step) == int(jst.step) == 10
    for k in p0:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), atol=2e-6)
        np.testing.assert_allclose(_np(tst.m[k]), _np(jst.m[k]), atol=1e-6)
        np.testing.assert_allclose(_np(tst.v[k]), _np(jst.v[k]), atol=1e-6)
    np.testing.assert_array_equal(_np(tp["b"]), p0["b"])
    for step in (-1, 0, 1, 100, 15000, 30000, 50000):
        for delay in (0, 500):
            kw = dict(lr_delay_steps=delay, lr_delay_mult=0.01)
            np.testing.assert_allclose(
                t_adam.expon_lr(step, 1.6e-4, 1.6e-6, 30000, **kw),
                float(j_adam.expon_lr(step, 1.6e-4, 1.6e-6, 30000, **kw)),
                rtol=1e-5)
