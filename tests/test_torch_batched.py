"""ht3dgs_torch's batch axis on the CPU: stacking, `render_batched` against
the JAX package's render of each model (and its `jax.vmap`), the
shared-state render under B poses, and the eval sweep in chunks.

The JAX package's batched fits are not run here (their CPU compiles take
minutes); test_torch_hierarchy holds the port's batched fits to its
per-model steps."""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ht3dgs.core.camera import intrinsics_from_fov as j_intr  # noqa: E402
from ht3dgs.core.camera import make_camera as j_make_camera  # noqa: E402
from ht3dgs.raster import render as j_render  # noqa: E402
from ht3dgs.train import phase_a as j_phase_a  # noqa: E402
from ht3dgs_torch import interop  # noqa: E402
from ht3dgs_torch.core import adam as t_adam  # noqa: E402
from ht3dgs_torch.core import se3 as t_se3  # noqa: E402
from ht3dgs_torch.core.camera import intrinsics_from_fov  # noqa: E402
from ht3dgs_torch.core.camera import make_camera  # noqa: E402
from ht3dgs_torch.data.readers import FrameInfo  # noqa: E402
from ht3dgs_torch.raster import render, render_batched  # noqa: E402
from ht3dgs_torch.train import hierarchy as t_hier  # noqa: E402
from ht3dgs_torch.train import phase_a  # noqa: E402
from ht3dgs_torch.utils.config import load_configs  # noqa: E402

from port_utils import camera_arrays, jax_state, rich_scene  # noqa: E402
from port_utils import torch_threads_per_worker  # noqa: E402,F401

H, W, N, B = 48, 64, 160, 3
# model 0's Gaussians are larger: 1704 entries against 1086 and 1243 at
# these cameras, so at dup_factor 9 (M = 1440) model 0 alone overflows M
BIG = 0.8
DUP_M = 9


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _w2c(seed):
    """A small random rotation and shift as a 4x4 world-to-camera."""
    g = torch.Generator().manual_seed(seed)
    tau = 0.03 * torch.randn(6, generator=g)
    return _np(t_se3.se3_to_matrix(t_se3.se3_exp(tau)))


@pytest.fixture(scope="module")
def models():
    """B models at one capacity and B cameras, in both packages."""
    arrs = [rich_scene(N, seed=b) for b in range(B)]
    arrs[0]["log_scales"] = arrs[0]["log_scales"] + BIG
    K = j_intr(1.2, H, W)
    j_cams = [j_make_camera(H, W, K, world_view=_w2c(b)) for b in range(B)]
    t_states = [interop.state_from_numpy(a, "cpu") for a in arrs]
    t_cams = [interop.camera_from_numpy(camera_arrays(c), "cpu")
              for c in j_cams]
    return [jax_state(a) for a in arrs], j_cams, t_states, t_cams


def test_stack_round_trip_and_mismatches(models):
    """stack/unstack give back every field bit for bit, and a stacked
    camera its cameras' projections (the centre, a batched product, to
    1e-7); a stack of mismatched capacities, SH degrees or image sizes
    raises ValueError."""
    _, _, states, cams = models
    st = phase_a.stack_states(states)
    assert st.means.shape == (B, N, 3) and st.capacity == N
    assert st.active_sh_degree.shape == (B,)
    for a, b in zip(states, phase_a.unstack_states(st)):
        for f in ("means", "quats", "log_scales", "sh_dc", "sh_rest",
                  "opacity_logit", "live", "grad_accum", "active_sh_degree"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert b.max_sh_degree == a.max_sh_degree
    cs = phase_a.stack_cameras(cams)
    assert cs.world_view.shape == (B, 4, 4) and cs.fx.shape == (B,)
    for b in range(B):
        assert torch.equal(cs.full_proj[b], cams[b].full_proj)
        np.testing.assert_allclose(_np(cs.camera_center[b]),
                                   _np(cams[b].camera_center), rtol=0,
                                   atol=1e-7)

    small = interop.state_from_numpy(rich_scene(N - 8, seed=5), "cpu")
    with pytest.raises(ValueError):
        phase_a.stack_states([states[0], small])
    lower = states[1].replace_params({})
    lower.active_sh_degree = torch.tensor(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        phase_a.stack_states([states[0], lower])
    other = make_camera(H, W + 16, intrinsics_from_fov(1.2, H, W + 16),
                        device="cpu")
    with pytest.raises(ValueError):
        phase_a.stack_cameras([cams[0], other])
    opts = [t_adam.init(s.params()) for s in states]
    assert phase_a.stack_opts(opts).step.shape == (B,)


# (mode, tile arguments, what the case exercises)
_CASES = [
    ("oracle", None, "oracle"),
    ("tiled", dict(tile_h=16, tile_w=16, max_per_tile=256,
                   dup_factor=DUP_M), "model 0 alone overflows M"),
    ("tiled", dict(tile_h=16, tile_w=16, max_per_tile=24, dup_factor=16),
     "tiles overflow K"),
]


@pytest.mark.parametrize("mode,targs,what", _CASES,
                         ids=[c[2] for c in _CASES])
def test_render_batched_matches_jax(models, mode, targs, what):
    """render_batched of B models under B cameras against the JAX
    package's render of each model (one jitted function called B times)
    and its jax.vmap: image and alpha 3e-5, depth 3e-4, radii and every
    per-model counter exact; the gradient of each model's loss into its
    own means 1e-4 of their max."""
    j_states, j_cams, t_states, t_cams = models
    kw = dict(mode=mode, tile_args=targs)

    def j_loss(m, s, c):
        out = j_render(s.replace_params(dict(s.params(), means=m)), c, **kw)
        return jnp.mean(out["image"] ** 2) + 0.01 * jnp.mean(out["depth"]), \
            out

    j_one = jax.jit(jax.value_and_grad(j_loss, has_aux=True))
    j_outs, j_grads = [], []
    for s, c in zip(j_states, j_cams):
        (_, out), g = j_one(s.means, s, c)
        j_outs.append(out)
        j_grads.append(np.asarray(g))
    j_vmap = jax.jit(jax.vmap(lambda s, c: j_render(s, c, **kw)))(
        j_phase_a.stack_states(j_states), j_phase_a.stack_cameras(j_cams))

    st = phase_a.stack_states(t_states)
    means = st.means.detach().requires_grad_(True)
    out = render_batched(st.replace_params(dict(st.params(), means=means)),
                         phase_a.stack_cameras(t_cams), **kw)
    (out["image"].pow(2).mean((1, 2, 3))
     + 0.01 * out["depth"].mean((1, 2))).sum().backward()

    counters = ("n_entries", "n_dropped_m", "n_dropped_tile",
                "n_dropped_compact") if mode == "tiled" else ()
    for b in range(B):
        for ref in (j_outs[b], jax.tree.map(lambda x: x[b], j_vmap)):
            for k, tol in (("image", 3e-5), ("alpha", 3e-5),
                           ("depth", 3e-4)):
                np.testing.assert_allclose(_np(out[k][b]),
                                           np.asarray(ref[k]), atol=tol,
                                           err_msg=f"{b} {k}")
            np.testing.assert_array_equal(_np(out["radii"][b]),
                                          np.asarray(ref["radii"]))
            for k in counters:
                assert int(out[k][b]) == int(ref[k]), (b, k)
        np.testing.assert_allclose(_np(means.grad[b]), j_grads[b], rtol=1e-4,
                                   atol=1e-4 * np.abs(j_grads[b]).max(),
                                   err_msg=f"{b} means grad")
    if what == "model 0 alone overflows M":
        assert [int(x) > 0 for x in out["n_dropped_m"]] == [True, False,
                                                             False]
    if what == "tiles overflow K":
        assert all(int(x) > 0 for x in out["n_dropped_tile"])


@pytest.mark.parametrize("mode", ["oracle", "tiled"])
def test_shared_state_under_poses(models, mode):
    """One model under B poses and B cameras (the eval_nvs and eval-sweep
    shape) against B single renders of the port: images 3e-5, depth 3e-4,
    radii and counters exact, and the gradient into each pose tangent 1e-4
    of its max."""
    _, _, t_states, t_cams = models
    state = t_states[1]
    targs = dict(tile_h=16, tile_w=16, max_per_tile=256, dup_factor=DUP_M)
    kw = dict(mode=mode, tile_args=targs if mode == "tiled" else None)
    g = torch.Generator().manual_seed(3)
    bases = t_se3.se3_exp(0.02 * torch.randn(B, 6, generator=g))
    deltas = torch.zeros(B, 6, requires_grad=True)
    out = render_batched(state, phase_a.stack_cameras(t_cams),
                         t_se3.se3_retr(deltas, bases), shared_state=True,
                         **kw)
    out["image"].pow(2).mean((1, 2, 3)).sum().backward()
    for b in range(B):
        d = torch.zeros(6, requires_grad=True)
        ref = render(state, t_cams[b], pose=t_se3.se3_retr(d, bases[b]),
                     **kw)
        ref["image"].pow(2).mean().backward()
        for k, tol in (("image", 3e-5), ("alpha", 3e-5), ("depth", 3e-4)):
            np.testing.assert_allclose(_np(out[k][b]), _np(ref[k]),
                                       atol=tol, err_msg=f"{b} {k}")
        assert torch.equal(out["radii"][b], ref["radii"])
        if mode == "tiled":
            for k in ("n_entries", "n_dropped_m", "n_dropped_tile"):
                assert int(out[k][b]) == int(ref[k]), (b, k)
        gd = _np(d.grad)
        np.testing.assert_allclose(_np(deltas.grad[b]), gd, rtol=1e-4,
                                   atol=1e-4 * np.abs(gd).max())
    with pytest.raises(ValueError):
        render_batched(phase_a.stack_states(t_states),
                       phase_a.stack_cameras(t_cams), shared_state=True)


def test_eval_sweep_batched_equals_per_frame(models, tmp_path, monkeypatch):
    """evaluate_on_training_images in chunks of eval_batch (3, so the last
    of 7 frames is a chunk of 1) against per-frame renders: every frame's
    image 3e-5 and PSNR 1e-4 dB, and the mean it returns."""
    _, _, t_states, _ = models
    n_frames = 7
    K = intrinsics_from_fov(1.2, H, W)
    tr = t_hier.HTGaussianTrainer.__new__(t_hier.HTGaussianTrainer)
    _, tr.pipe_cfg, tr.optim_cfg = load_configs()
    tr.pipe_cfg.eval_batch = 3
    tr.data = [FrameInfo(uid=i, image_path=None, image_name=f"{i:04d}",
                         width=W, height=H, intrinsics=K, fovx=1.2, fovy=1.0)
               for i in range(n_frames)]
    tr.seq_len, tr.result_path = n_frames, str(tmp_path)
    tr.logger = logging.getLogger("test_torch_batched")
    tr._mode, tr._tile_args = "oracle", None
    tr.device, tr._cameras = torch.device("cpu"), {}
    rng = np.random.default_rng(4)
    tr.rgb_images = {i: rng.random((H, W, 3)).astype(np.float32)
                     for i in range(n_frames)}
    poses = np.stack([_w2c(10 + i) for i in range(n_frames)])
    st = t_states[2]
    tr.gs_bundle = t_hier.ModelBundle(
        state=st, opt=t_adam.init(st.params()), radius=1.0,
        spatial_scale=1.0, poses=poses)

    saved = {}
    monkeypatch.setattr(t_hier, "save_image",
                        lambda path, img, gt_image: saved.setdefault(
                            int(path[-7:-4]), img))
    mean = tr.evaluate_on_training_images(save_images=True)
    assert sorted(saved) == list(range(n_frames))
    psnrs = []
    for f in range(n_frames):
        img = _np(render(st, tr.camera_for(f, pose=poses[f]),
                         mode="oracle")["image"])
        np.testing.assert_allclose(saved[f], img, atol=3e-5, err_msg=str(f))
        gt = tr.rgb_images[f]
        p = -10.0 * np.log10(max(float(np.mean((img - gt) ** 2)), 1e-12))
        got = -10.0 * np.log10(float(np.mean((saved[f] - gt) ** 2)))
        assert abs(got - p) < 1e-4, f
        psnrs.append(p)
    assert abs(mean - float(np.mean(psnrs))) < 1e-4
