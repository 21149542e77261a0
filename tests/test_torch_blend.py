"""ht3dgs_torch.raster.blend against ht3dgs.raster.pallas_blend on the CPU.

The port's plain forward and backward take the same packed entries as the
JAX blends: the XLA blend with its analytic backward, and the Pallas kernels
run through the Pallas interpreter, as tests/test_pallas_blend.py runs them.
chip_smoke.py holds the CUDA kernels against the same plain versions on the
card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ht3dgs.core import gaussians as G  # noqa: E402
from ht3dgs.core.camera import intrinsics_from_fov, make_camera  # noqa: E402
from ht3dgs.raster import pallas_blend as pb  # noqa: E402
from ht3dgs.raster.projection import project  # noqa: E402
from ht3dgs.raster.tiled import build_tile_lists  # noqa: E402
from ht3dgs_torch.raster import blend as tb  # noqa: E402

TILE = 16
P = TILE * TILE


def _entries(n=96, h=32, w=48, K=128, seed=0):
    """Packed entries [T, K, 16] and meta of a small scene, from the JAX
    binning, and cotangents of the size a mean-of-image loss gives."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 3.0
    st = G.create_from_pcd(pts, rng.random((n, 3)).astype(np.float32),
                           capacity=n)
    # opacities up to ~0.99, so that some pixels terminate
    st = dataclasses.replace(st, opacity_logit=jnp.asarray(
        rng.uniform(-3.0, 5.0, (n, 1)).astype(np.float32)))
    cam = make_camera(h, w, intrinsics_from_fov(1.2, h, w))

    @jax.jit
    def bin_entries(st):
        proj = project(st.means, st.scales(), st.quats, st.opacities(),
                       st.sh(), st.live, cam, jnp.asarray(3), 3)
        return build_tile_lists(proj, h, w, TILE, TILE, K, 16)[:2]

    ent, meta = bin_entries(st)
    ent = np.pad(np.asarray(ent), ((0, 0), (0, 0), (0, 6)))
    T = ent.shape[0]
    cts = tuple((rng.standard_normal(s) / P).astype(np.float32)
                for s in ((T, P, 3), (T, P), (T, P)))
    return ent, np.asarray(meta), cts


def _torch_blend(ent, meta, cts):
    """The port's plain forward and backward on numpy inputs."""
    te, tm = torch.tensor(ent), torch.tensor(meta)
    rgb, t_fin, dep, ncon = tb.blend_fwd(te, tm, TILE, TILE)
    d_ent = tb.blend_bwd(te, tm, t_fin, ncon,
                         *map(torch.tensor, cts), TILE, TILE)
    return dict(ent=ent, meta=meta, cts=cts, rgb=rgb, t_fin=t_fin, dep=dep,
                ncon=ncon, d_ent=d_ent)


@pytest.fixture(scope="module")
def case():
    return _torch_blend(*_entries())


def _jax_blend(ref, ent, meta, cts):
    """(rgb, T_fin, depth, ncon or None, d_ent) of a JAX blend."""
    if ref == "pallas":
        from jax.experimental.pallas import tpu as pltpu

        with pltpu.force_tpu_interpret_mode():
            ncon = pb._blend_tiles_pallas_raw(ent, meta, tile_h=TILE,
                                              tile_w=TILE)[3]
            out, vjp = jax.vjp(
                lambda e: pb.blend_pallas(e, meta, TILE, TILE), ent)
            (d_ent,) = vjp(tuple(map(jnp.asarray, cts)))
    else:
        ncon = None
        out, vjp = jax.vjp(lambda e: pb.blend_xla(e, meta, TILE, TILE), ent)
        (d_ent,) = vjp(tuple(map(jnp.asarray, cts)))
    return (*out, ncon, d_ent)


# the last 1080p tile's origin: the Pallas backward takes its gradient sums
# as pixel moments in tile-local coordinates (the form kernel K2 uses),
# blend_bwd_plain sums per pixel in image coordinates
FAR = (1904, 1072)


@pytest.mark.parametrize("ref, shift", [("xla", None), ("pallas", None),
                                        ("pallas", FAR)],
                         ids=["xla", "pallas", "pallas-far"])
def test_plain_blend_matches_jax(case, ref, shift):
    """Forward: image 3e-5, depth 3e-4, min(ncon, count) exact. Backward:
    d_ent 1e-5 abs on rows k < count, exact zeros elsewhere. With a shift,
    tile origins and entry centres move by it."""
    if shift is not None:
        ent, meta = case["ent"].copy(), case["meta"].copy()
        ent[:, :, 0:2] += np.asarray(shift, np.float32)
        meta[:, 1:3] += np.asarray(shift, np.int32)
        case = _torch_blend(ent, meta, case["cts"])
    rgb, t_fin, dep, ncon, d_ent = _jax_blend(
        ref, jnp.asarray(case["ent"]), jnp.asarray(case["meta"]),
        case["cts"])
    np.testing.assert_allclose(case["rgb"].numpy(), np.asarray(rgb),
                               atol=3e-5)
    np.testing.assert_allclose(case["t_fin"].numpy(), np.asarray(t_fin),
                               atol=3e-5)
    np.testing.assert_allclose(case["dep"].numpy(), np.asarray(dep),
                               atol=3e-4)
    count = case["meta"][:, :1]
    assert (case["ncon"].numpy() <= count).all()
    assert (case["ncon"].numpy() < count).any()     # some pixels terminate
    if ncon is not None:
        np.testing.assert_array_equal(case["ncon"].numpy(),
                                      np.minimum(np.asarray(ncon), count))
    got = case["d_ent"].numpy()
    rows = np.arange(got.shape[1])[None, :] < count
    assert np.abs(got[:, :, :tb.N_GRAD]).max() > 1e-3
    np.testing.assert_allclose(got[rows], np.asarray(d_ent)[rows], atol=1e-5)
    assert not got[~rows].any() and not got[:, :, tb.N_GRAD:].any()


def test_blend_autograd_function(case):
    """`blend` differentiates through the plain backward on the CPU; the
    kernel wrappers refuse what the kernels do not take."""
    te = torch.tensor(case["ent"], requires_grad=True)
    out = tb.blend(te, torch.tensor(case["meta"]), TILE, TILE)
    (g,) = torch.autograd.grad(
        out, [te], grad_outputs=tuple(map(torch.tensor, case["cts"])))
    np.testing.assert_array_equal(g.numpy(), case["d_ent"].numpy())
    with pytest.raises(ValueError, match="CUDA"):
        tb.blend_fwd(te.detach().to("meta"), torch.tensor(case["meta"]),
                     TILE, TILE)
    with pytest.raises(ValueError, match="built for"):
        tb.blend_bwd(te.detach().to("meta"), *[None] * 6, 4, 4)
