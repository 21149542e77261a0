"""ht3dgs_torch's multi-device path against ht3dgs's on the CPU: the sharded
SSIM and depth losses, the hierarchy step on a 2 x 2 mesh (three apply
codes and an inactive segment), compact_n with route_bf16, and the
Gaussian-sharded step.

The port's side runs once per module on 4 gloo ranks (ht3dgs_torch's
spawn, one torch thread each, 120 s bound); JAX's side runs meanwhile in
this process, on the 8 virtual CPU devices of tests/conftest.py. Tolerances
are the port tests': loss 1e-5 relative, gradients 1e-4 of their max (the
Adam first moments after one step from zero, 0.1 x the gradient), new
parameters where both gradients are above 1e-6 of the max."""

import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ht3dgs.core import adam as j_adam  # noqa: E402
from ht3dgs.core import gaussians as JG  # noqa: E402
from ht3dgs.core.camera import intrinsics_from_fov, make_camera  # noqa: E402
from ht3dgs.parallel import gauss_shard as j_gs  # noqa: E402
from ht3dgs.parallel import mesh as j_mesh  # noqa: E402
from ht3dgs.raster import render as j_render  # noqa: E402
from ht3dgs.train import losses as j_losses  # noqa: E402
from ht3dgs_torch import interop  # noqa: E402
from ht3dgs_torch.core.gaussians import PARAM_FIELDS  # noqa: E402
from ht3dgs_torch.parallel import checks  # noqa: E402
from ht3dgs_torch.parallel import mesh as t_mesh  # noqa: E402
from ht3dgs_torch.raster import render as t_render  # noqa: E402

from port_utils import camera_arrays, rich_scene, state_arrays  # noqa: E402
from port_utils import jax_state  # noqa: E402
from port_utils import torch_threads_per_worker  # noqa: E402,F401

H = W = 32
TARGS = dict(tile_h=8, tile_w=16, max_per_tile=128)
GAUSS_TARGS = dict(tile_h=8, tile_w=16, max_per_tile=256, dup_factor=32)
LR = 1e-2
APPLY = [dict(apply_code=j_mesh.APPLY_ALL, track_stats=True),
         dict(apply_code=j_mesh.APPLY_SKIP, track_stats=True),
         dict(apply_code=j_mesh.APPLY_NO_OPACITY, track_stats=True),
         dict(apply_code=j_mesh.APPLY_ALL, track_stats=False,
              active=[True, False])]
# Gaussian-sharded configurations: (cull_cap, compact_n); the first is
# held to JAX, all of them to the port's single-device step
GAUSS = [(32, 96), (32, None), (None, 96)]


def make_segment(seed, n=64, cap=128):
    """tests/test_parallel.py's segment: anisotropic scales and a common
    off-identity rotation, so no gradient is rounding noise."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32) * 0.4
    pts[:, 2] += 3.0
    state = JG.create_from_pcd(pts, rng.random((n, 3)).astype(np.float32),
                               capacity=cap)
    q = np.tile([0.1, -0.05, 0.08, 1.0], (cap, 1)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dataclasses.replace(
        state, log_scales=state.log_scales + jnp.asarray(
            rng.normal(0.0, 0.4, (cap, 3)).astype(np.float32)),
        quats=jnp.asarray(q))


def _inputs():
    cam = make_camera(H, W, intrinsics_from_fov(1.2, H, W))
    states = [make_segment(0), make_segment(1)]
    gts = [np.asarray(j_render(make_segment(s), cam, mode="oracle")["image"])
           for s in (99, 98)]
    lrs = {k: LR for k in PARAM_FIELDS}
    rng = np.random.default_rng(0)
    img = [rng.random((H, 16, 3), np.float32) for _ in range(2)]
    dep = [rng.random((H, 16), np.float32) * 3.0 for _ in range(2)]
    gstate = make_segment(0, n=96, cap=128)
    return dict(cam=cam, states=states, gts=gts, lrs=lrs, img=img, dep=dep,
                gstate=gstate)


def _port_jobs(x):
    camd = camera_arrays(x["cam"])
    segs = [dict(state=state_arrays(s), camera=camd, gt=g, lrs=x["lrs"])
            for s, g in zip(x["states"], x["gts"])]
    gauss = [dict(cull_cap=c, tile_args=dict(GAUSS_TARGS, **(
        {"compact_n": n} if n else {}))) for c, n in GAUSS]
    return [
        (checks.loss_shares, (*x["img"], *x["dep"])),
        (checks.hierarchy_steps, (2, 2, segs, APPLY, H, W,
                                  dict(mode="tiled", tile_args=TARGS))),
        (checks.gauss_steps, (state_arrays(x["gstate"]), camd, x["gts"][0],
                              x["lrs"], H, W, gauss)),
        (checks.gauss_densify, (state_arrays(x["gstate"], grad_accum=np.ones(
            128, np.float32), grad_denom=np.ones(128, np.float32)), 0)),
    ]


def _jax_refs(x):
    refs = {}
    mesh14 = j_mesh.make_mesh(1, 4)
    a, b = (jnp.asarray(v) for v in x["img"])
    p, g = (jnp.asarray(v) for v in x["dep"])

    def sharded(fn):
        return jax.shard_map(lambda u, v: fn(u, v, "tile"), mesh=mesh14,
                             in_specs=(P("tile"), P("tile")), out_specs=P(),
                             check_vma=False)

    refs["losses"] = jax.jit(lambda a, b, p, g: (
        jax.value_and_grad(sharded(j_losses.ssim_sharded))(a, b),
        jax.value_and_grad(sharded(
            j_losses.scale_shift_invariant_depth_loss_sharded))(p, g),
        jax.value_and_grad(j_losses.ssim)(a, b),
        jax.value_and_grad(j_losses.scale_shift_invariant_depth_loss)(
            p, g)))(a, b, p, g)

    hstep = j_mesh.build_hierarchy_step(j_mesh.make_mesh(2, 2), H, W,
                                        mode="tiled", tile_args=TARGS)
    states = j_mesh.batch_segments(x["states"])
    opts = j_mesh.batch_segments([j_adam.init(s.params())
                                  for s in x["states"]])
    cams = j_mesh.batch_segments([x["cam"], x["cam"]])
    lrs = {k: jnp.full((2,), LR) for k in PARAM_FIELDS}
    gts = jnp.stack([jnp.asarray(v) for v in x["gts"]])
    refs["hier"] = [hstep(states, opts, cams, gts, lrs, **dict(
        c, active=jnp.asarray(c.get("active", [True, True]))))
        for c in APPLY]

    cull, n = GAUSS[0]
    gstep = j_gs.build_gauss_sharded_step(
        mesh14, H, W, cull_cap=cull,
        tile_args=dict(GAUSS_TARGS, compact_n=n, backend="xla"))
    gs = x["gstate"]
    sh, oh, m = gstep(j_gs.shard_state(gs, 4),
                      j_gs.shard_opt(j_adam.init(gs.params()), 4),
                      x["cam"], jnp.asarray(x["gts"][0]),
                      {k: jnp.asarray(LR) for k in PARAM_FIELDS})
    refs["gauss"] = (j_gs.unshard_state(sh), j_gs.unshard_opt(oh), m)
    return refs


@pytest.fixture(scope="module")
def runs():
    x = _inputs()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        port = ex.submit(t_mesh.spawn, checks.sequence, 4, device="cpu",
                         args=(_port_jobs(x),), timeout=120.0)
        refs = _jax_refs(x)
        ranks = port.result()
    return x, refs, ranks


def _close(a, b, scale, tol, what):
    err = np.abs(np.asarray(a) - np.asarray(b)).max(initial=0.0)
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def test_sharded_losses_match_jax_and_full_image(runs):
    """Value and gradient of the sharded SSIM and depth loss, summed over
    4 ranks, against JAX's sharded losses and the full-image losses; the
    rows next to each block edge (where a missing halo backward shows) are
    checked on their own."""
    _, refs, ranks = runs
    (jv, jg), (jdv, jdg), (fv, fg), (fdv, fdg) = jax.tree.map(
        np.asarray, refs["losses"])
    res = [r[0] for r in ranks]
    g = np.concatenate([r["ssim_grad"] for r in res])
    dg = np.concatenate([r["depth_grad"] for r in res])
    for v, ref in ((res[0]["ssim"], jv), (res[0]["ssim"], fv),
                   (res[0]["depth"], jdv), (res[0]["depth"], fdv)):
        assert abs(v - ref) <= 1e-5 * abs(ref)
    bh = H // 4
    edge = np.concatenate([np.arange(k * bh - 5, k * bh + 5)
                           for k in range(1, 4)])
    for got, refs_g, name, halo in ((g, (jg, fg), "ssim", 5),
                                    (dg, (jdg, fdg), "depth", 1)):
        rows = np.concatenate([np.arange(k * bh - halo, k * bh + halo)
                               for k in range(1, 4)])
        for ref in refs_g:
            _close(got, ref, np.abs(ref).max(), 1e-4, name)
            _close(got[rows], ref[rows], np.abs(ref[rows]).max(), 1e-4,
                   f"{name} block-edge rows")
    assert np.abs(fg[edge]).max() > 0.1 * np.abs(fg).max()


def _check_step(got, ref_state, ref_opt, ref_m, s, what):
    """One segment's step_result against JAX's stacked outputs."""
    ms = {k: np.asarray(ref_opt.m[k][s]) for k in PARAM_FIELDS}
    for k in PARAM_FIELDS:
        scale = max(np.abs(ms[k]).max(), 1e-30)
        _close(got[f"m_{k}"], ms[k], scale, 1e-4, f"{what} m[{k}]")
        both = (np.abs(got[f"m_{k}"]) > 1e-6 * scale) & (
            np.abs(ms[k]) > 1e-6 * scale)
        _close(got[k][both], np.asarray(ref_state.params()[k][s])[both],
               1.0, 1e-5, f"{what} {k}")
    ga = np.asarray(ref_state.grad_accum[s])
    _close(got["grad_accum"], ga, max(np.abs(ga).max(), 1e-30), 1e-4,
           f"{what} grad_accum")
    np.testing.assert_array_equal(got["max_radii2d"],
                                  np.asarray(ref_state.max_radii2d[s]))
    np.testing.assert_array_equal(got["grad_denom"],
                                  np.asarray(ref_state.grad_denom[s]))
    assert got["step"] == int(ref_opt.step[s]), what
    lm = float(ref_m["loss"][s])
    assert abs(got["metrics"]["loss"] - lm) <= 1e-5 * abs(lm), what
    for k in ("n_visible", "n_dropped", "n_dropped_m", "n_dropped_tile",
              "n_dropped_compact"):
        assert got["metrics"][k] == int(ref_m[k][s]), (what, k)


def test_hierarchy_step_2x2_matches_jax(runs):
    """The hierarchy step of each segment of a 2 x 2 mesh, for APPLY_ALL,
    APPLY_SKIP, APPLY_NO_OPACITY and with segment 1 inactive, against
    JAX's build_hierarchy_step on the (2, 2) mesh."""
    x, refs, ranks = runs
    for s, r in ((0, 0), (1, 2)):
        res = ranks[r][1]
        init = state_arrays(x["states"][s])
        for i, (c, (st, op, m)) in enumerate(zip(APPLY, refs["hier"])):
            _check_step(res[i], st, op, m, s, f"seg {s} call {i}")
            if c["apply_code"] == j_mesh.APPLY_SKIP or not c.get(
                    "active", [True, True])[s]:
                for k in PARAM_FIELDS:
                    np.testing.assert_array_equal(res[i][k], init[k])
        # APPLY_NO_OPACITY: the opacity moments and logits stay
        np.testing.assert_array_equal(res[2]["opacity_logit"],
                                      init["opacity_logit"])
    assert ranks[1][1] is None and ranks[3][1] is None


def test_compact_n_route_bf16_match_jax():
    """rasterize_tiled with compact_n (dropping live rows) and route_bf16
    against JAX's with the same arguments: counters exact, image 3e-5,
    the means gradient 1e-4 of its max."""
    arrs = rich_scene(160, seed=2)
    js = jax_state(arrs)
    ts = interop.state_from_numpy(arrs, "cpu")
    h, w = 48, 64
    cam = make_camera(h, w, intrinsics_from_fov(1.2, h, w))
    tcam = interop.camera_from_numpy(camera_arrays(cam), "cpu")
    ta = dict(tile_h=16, tile_w=16, max_per_tile=128, dup_factor=4,
              compact_n=64, route_bf16=True)
    keys = ("n_entries", "n_dropped", "n_dropped_m", "n_dropped_tile",
            "n_dropped_compact")

    def j_f(m):
        out = j_render(js.replace_params(dict(js.params(), means=m)), cam,
                       mode="tiled", tile_args=ta)
        return jnp.mean(out["image"] ** 2), out

    (_, j_out), j_g = jax.jit(jax.value_and_grad(j_f, has_aux=True))(
        js.means)
    tm = ts.means.detach().requires_grad_(True)
    t_out = t_render(ts.replace_params(dict(ts.params(), means=tm)), tcam,
                     mode="tiled", tile_args=ta)
    t_out["image"].pow(2).mean().backward()
    assert [int(t_out[k]) for k in keys] == [int(j_out[k]) for k in keys]
    assert int(t_out["n_dropped_compact"]) > 0
    np.testing.assert_allclose(t_out["image"].detach().numpy(),
                               np.asarray(j_out["image"]), atol=3e-5)
    j_g = np.asarray(j_g)
    _close(tm.grad.numpy(), j_g, np.abs(j_g).max(), 1e-4, "means grad")


def test_gauss_sharded_step_matches_jax(runs):
    """The Gaussian-row-sharded step on 4 ranks: shard_state / unshard_state
    and shard_opt / unshard_opt round trips, the (cull_cap 32, compact_n 96)
    step against JAX's build_gauss_sharded_step on the (1, 4) mesh, and
    every configuration against the port's single-device step."""
    from ht3dgs_torch.core import adam as t_adam
    from ht3dgs_torch.train import step as t_step

    x, refs, ranks = runs
    res = [r[2] for r in ranks]
    assert all(r["round_trip"] for r in res)
    j_state, j_opt, j_m = refs["gauss"]
    gs = interop.state_from_numpy(state_arrays(x["gstate"]), "cpu")
    s1, o1, m1 = t_step.gaussian_train_step(
        gs, t_adam.init(gs.params()), interop.camera_from_numpy(
            camera_arrays(x["cam"]), "cpu"), torch.tensor(x["gts"][0]),
        x["lrs"], mode="tiled", tile_args=GAUSS_TARGS)
    single = (state_arrays(s1), {k: v.numpy() for k, v in o1.m.items()},
              float(m1["loss"]))
    for i, (cull, n) in enumerate(GAUSS):
        got = {k: np.concatenate([r["results"][i][k] for r in res])
               for k in res[0]["results"][i] if k not in ("step",
                                                          "metrics")}
        met = res[0]["results"][i]["metrics"]
        assert met["n_culled_dropped"] == 0 and met["n_dropped_compact"] == 0
        refs_i = [(single[0], single[1], single[2], "single")]
        if i == 0:
            refs_i.append((
                {k: np.asarray(getattr(j_state, k)) for k in
                 PARAM_FIELDS + ("grad_accum", "max_radii2d")},
                {k: np.asarray(j_opt.m[k]) for k in PARAM_FIELDS},
                float(j_m["loss"]), "jax"))
        for st, ms, loss, name in refs_i:
            what = f"{name} cull {cull} compact {n}"
            assert abs(met["loss"] - loss) <= 1e-5 * abs(loss), what
            for k in PARAM_FIELDS:
                scale = max(np.abs(ms[k]).max(), 1e-30)
                _close(got[f"m_{k}"], ms[k], scale, 1e-4, f"{what} m[{k}]")
                both = (np.abs(got[f"m_{k}"]) > 1e-6 * scale) & (
                    np.abs(ms[k]) > 1e-6 * scale)
                _close(got[k][both], st[k][both], 1.0, 1e-5, f"{what} {k}")
            _close(got["grad_accum"], st["grad_accum"],
                   np.abs(st["grad_accum"]).max(), 1e-4, what)
            np.testing.assert_array_equal(got["max_radii2d"],
                                          st["max_radii2d"])


def test_gauss_sharded_densify(runs):
    """build_sharded_densify on 4 ranks from hot statistics (every live row
    clones or splits), as tests/test_parallel.py's densify check: no shard
    loses a Gaussian, every mean is finite, and the rows dropped for
    capacity are summed over the shards."""
    x, _, ranks = runs
    res = [r[3] for r in ranks]
    live0 = np.asarray(x["gstate"].live).reshape(4, -1).sum(axis=1)
    for r, n in zip(res, live0):
        assert r["live"].sum() >= n
        assert np.all(np.isfinite(r["means"]))
    assert res[0]["dropped"] == res[1]["dropped"] > 0
