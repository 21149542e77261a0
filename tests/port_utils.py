"""Shared helpers of the tests that hold `ht3dgs_torch` against `ht3dgs`:
both packages get the same numpy inputs."""

import numpy as np

from ht3dgs.core import gaussians as G

STATE_FIELDS = G.PARAM_FIELDS + ("live", "max_radii2d", "grad_accum",
                                 "grad_denom", "active_sh_degree")


def state_arrays(state, **overrides):
    """numpy arrays of a JAX GaussianState, as interop.state_from_numpy
    takes them."""
    arrs = {f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}
    arrs["max_sh_degree"] = state.max_sh_degree
    arrs.update(overrides)
    return arrs


def camera_arrays(cam):
    arrs = {k: np.asarray(getattr(cam, k))
            for k in ("world_view", "fx", "fy", "cx", "cy")}
    return dict(arrs, height=cam.height, width=cam.width)


def rich_scene(n=160, seed=0):
    """make_scene_states plus anisotropic scales, random rotations, SH
    degree 3 coefficients and spread opacities, so every parameter gets a
    gradient, and a few rows that are culled: dead slots, rows behind the
    near plane, opacities below the 1/255 cutoff. Returns numpy arrays."""
    from ht3dgs.utils.synthetic import make_scene_states

    rng = np.random.default_rng(seed + 100)
    st = make_scene_states(n, seed=seed)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    live = np.ones(n, bool)
    live[-4:] = False
    means = np.asarray(st.means).copy()
    means[-4:] = 0.0
    means[-8:-4, 2] = 0.1
    logit = rng.uniform(-2.0, 3.0, (n, 1)).astype(np.float32)
    logit[-12:-8] = -7.0
    return state_arrays(
        st, live=live, means=means, opacity_logit=logit,
        quats=q / np.linalg.norm(q, axis=1, keepdims=True),
        log_scales=(np.asarray(st.log_scales)
                    + 0.4 * rng.standard_normal((n, 3))).astype(np.float32),
        sh_rest=(0.1 * rng.standard_normal(np.asarray(st.sh_rest).shape)
                 ).astype(np.float32),
        active_sh_degree=np.asarray(3, np.int32))


def jax_state(arrs):
    import jax.numpy as jnp

    return G.GaussianState(
        **{f: jnp.asarray(arrs[f]) for f in STATE_FIELDS},
        max_sh_degree=int(arrs["max_sh_degree"]))
