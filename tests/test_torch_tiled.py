"""ht3dgs_torch.raster (projection, binning, tiled and oracle renders)
against ht3dgs.raster on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ht3dgs.core.camera import intrinsics_from_fov, make_camera  # noqa: E402
from ht3dgs.raster import projection as j_proj  # noqa: E402
from ht3dgs.raster import render as j_render  # noqa: E402
from ht3dgs.raster import tiled as j_tiled  # noqa: E402
from ht3dgs_torch import interop  # noqa: E402
from ht3dgs_torch.raster import projection as t_proj  # noqa: E402
from ht3dgs_torch.raster import render as t_render  # noqa: E402
from ht3dgs_torch.raster import tiled as t_tiled  # noqa: E402

from port_utils import camera_arrays, jax_state, rich_scene  # noqa: E402


def _scene(n=160, h=48, w=64, seed=0):
    arrs = rich_scene(n, seed)
    js = jax_state(arrs)
    cam = make_camera(h, w, intrinsics_from_fov(1.2, h, w))
    return (js, cam, interop.state_from_numpy(arrs, "cpu"),
            interop.camera_from_numpy(camera_arrays(cam), "cpu"))


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _proj_inputs(s):
    return (s.means, s.scales(), s.quats, s.opacities(), s.sh(), s.live)


def test_project_values_and_grads(scene):
    """Every Projected field, and the VJP into means, scales, quats,
    opacities and SH of a loss on all the differentiable fields."""
    js, cam, ts, tc = scene
    rng = np.random.default_rng(0)
    n = js.means.shape[0]
    wts = [rng.standard_normal(s).astype(np.float32)
           for s in ((n, 2), (n,), (n, 3), (n, 3), (n,))]

    def loss(p, depth_fn, wts):
        d = depth_fn(p.depths)
        return (p.means2d * wts[0]).sum() + (d * wts[1]).sum() \
            + (p.conics * wts[2]).sum() + (p.colors * wts[3]).sum() \
            + (p.opacities * wts[4]).sum()

    j_in = _proj_inputs(js)[:5]

    def j_f(*a):
        p = j_proj.project(*a, js.live, cam, js.active_sh_degree, 3)
        return loss(p, lambda d: jnp.where(jnp.isfinite(d), d, 0.0),
                    [jnp.asarray(x) for x in wts])

    j_out, j_grads = jax.jit(lambda *a: (
        j_proj.project(*a, js.live, cam, js.active_sh_degree, 3),
        jax.grad(j_f, argnums=tuple(range(5)))(*a)))(*j_in)

    t_in = [x.detach().requires_grad_(True) for x in _proj_inputs(ts)[:5]]
    t_out = t_proj.project(*t_in, ts.live, tc, ts.active_sh_degree, 3)
    loss(t_out, lambda d: torch.where(torch.isfinite(d), d, 0.0),
         [torch.tensor(x) for x in wts]).backward()

    assert t_out.valid.any() and not t_out.valid.all()
    for f in j_proj.Projected._fields:
        a = getattr(t_out, f).detach().numpy()
        b = np.asarray(getattr(j_out, f))
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5, err_msg=f)
    for name, ta, jg in zip(("means", "scales", "quats", "opacities", "sh"),
                            t_in, j_grads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(ta.grad.numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * np.abs(jg).max(), err_msg=name)


# (height, width, max_per_tile, dup_factor): no drops, per-tile drops,
# global M drops with a fractional dup, a size that is not a tile multiple
_BINNING = [(48, 64, 256, 16), (48, 64, 8, 16), (48, 64, 128, 1.25),
            (37, 53, 64, 4)]


@pytest.mark.parametrize("h,w,K,dup", _BINNING)
def test_binning_matches(h, w, K, dup):
    """ent rows k < count, meta, total and the drop counters exactly; the
    binning VJP to 1e-5 relative."""
    js, cam, ts, _ = _scene(n=160, h=h, w=w, seed=1)
    jp = j_proj.project(*_proj_inputs(js), cam, js.active_sh_degree, 3)
    attrs = j_tiled._pack_attr_rows(jp)
    geom = (h, w, 16, 16, K, dup)
    rng = np.random.default_rng(2)
    noise = rng.standard_normal((j_tiled._cdiv(h, 16) * j_tiled._cdiv(w, 16),
                                 K, 16)).astype(np.float32)

    @jax.jit
    def j_f(a, noise):
        outs, vjp = jax.vjp(lambda a: j_tiled.build_tile_lists_from_rows(
            a, jp.valid, jp.depths, *geom), a)
        # cotangents on rows k < count only, as every blend backward gives
        rows = jnp.arange(K)[None, :] < outs[1][:, :1]
        d_ent = noise[..., :10] * rows[..., None]
        zero_cts = jax.tree.map(
            lambda x: np.zeros(x.shape, jax.dtypes.float0)
            if x.dtype.kind in "iub" else jnp.zeros_like(x), outs[1:])
        return outs, vjp((d_ent,) + tuple(zero_cts))[0]

    (j_ent, j_meta, j_total, j_ndm, j_ndt, _), j_d = jax.tree.map(
        np.asarray, j_f(attrs, noise))
    t_attrs = torch.tensor(np.asarray(attrs), requires_grad=True)
    ent, meta, total, ndm, ndt = t_tiled.build_tile_lists_from_rows(
        t_attrs, torch.tensor(np.asarray(jp.valid)),
        torch.tensor(np.asarray(jp.depths)), *geom)

    np.testing.assert_array_equal(meta.numpy(), j_meta)
    assert (int(total), int(ndm), int(ndt)) == (int(j_total), int(j_ndm),
                                                int(j_ndt))
    if (K, dup) != (256, 16):
        assert int(ndm) + int(ndt) > 0
    rows = np.arange(K)[None, :] < j_meta[:, :1]
    np.testing.assert_array_equal(ent.detach().numpy()[rows][:, :10],
                                  j_ent[rows])

    d_ent = noise * rows[..., None]
    (t_d,) = torch.autograd.grad(ent, [t_attrs], torch.tensor(d_ent))
    np.testing.assert_allclose(t_d.numpy()[:, :10], np.asarray(j_d)[:, :10],
                               rtol=1e-5, atol=1e-5 * np.abs(j_d).max())


def test_capacity_modes_not_ported(scene):
    _, _, ts, tc = scene
    for kw in (dict(route_bf16=True), dict(compact_n=64)):
        with pytest.raises(NotImplementedError):
            t_render(ts, tc, mode="tiled", tile_args=kw)


@pytest.mark.parametrize("mode", ["oracle", "tiled"])
def test_render_matches(scene, mode):
    """Image, depth, alpha and radii of a posed render, and the gradient
    of a loss on them into the means."""
    js, cam, ts, tc = scene
    pose = np.asarray([0.02, -0.01, 0.03, 0.01, 0.02, -0.01, 1.0],
                      np.float32)
    pose[3:] /= np.linalg.norm(pose[3:])
    bg = np.asarray([0.2, 0.1, 0.4], np.float32)
    ta = dict(tile_h=16, tile_w=16, max_per_tile=256, dup_factor=8)
    kw = dict(mode=mode, tile_args=ta if mode == "tiled" else None)

    def j_f(m):
        out = j_render(js.replace_params(dict(js.params(), means=m)), cam,
                       pose=jnp.asarray(pose), bg_color=jnp.asarray(bg), **kw)
        return jnp.mean(out["image"] ** 2) + 0.01 * jnp.mean(out["depth"]), out

    (_, j_out), j_g = jax.jit(jax.value_and_grad(j_f, has_aux=True))(
        js.means)
    tm = ts.means.detach().requires_grad_(True)
    t_out = t_render(ts.replace_params(dict(ts.params(), means=tm)), tc,
                     pose=torch.tensor(pose), bg_color=torch.tensor(bg), **kw)
    (t_out["image"].pow(2).mean() + 0.01 * t_out["depth"].mean()).backward()
    for k, tol in (("image", 3e-5), ("alpha", 3e-5), ("depth", 3e-4)):
        np.testing.assert_allclose(t_out[k].detach().numpy(),
                                   np.asarray(j_out[k]), atol=tol, err_msg=k)
    np.testing.assert_array_equal(t_out["radii"].numpy(),
                                  np.asarray(j_out["radii"]))
    j_g = np.asarray(j_g)
    np.testing.assert_allclose(tm.grad.numpy(), j_g, rtol=1e-4,
                               atol=1e-4 * np.abs(j_g).max())
