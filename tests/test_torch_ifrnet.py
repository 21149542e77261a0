"""ht3dgs_torch.data.ifrnet against ht3dgs.data.ifrnet on the CPU: each op
and block on the same numpy inputs and weights, the whole network on
random_params(0) with and without /16 padding, the parameter spec, the
checkpoint loaders and the VFI provider."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ht3dgs.data import ifrnet as j_ifr  # noqa: E402
from ht3dgs_torch.data import ifrnet as t_ifr  # noqa: E402
from ht3dgs_torch.data import vfi as t_vfi  # noqa: E402

from port_utils import torch_threads_per_worker  # noqa: E402,F401


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return module


def _op_case(name, rng):
    """(port output NHWC, JAX output NHWC, tolerance) of one op."""
    x = rng.standard_normal((2, 10, 12, 5)).astype(np.float32)
    if name == "conv":
        conv = t_ifr.convrelu(5, 7, stride=2)
        p = {"0.weight": rng.standard_normal((7, 5, 3, 3)).astype(np.float32),
             "0.bias": rng.standard_normal(7).astype(np.float32),
             "1.weight": rng.uniform(0, 0.5, 7).astype(np.float32)}
        ours = _load(conv, p)(_nchw(x))
        ref = j_ifr._convrelu({f"c.{k}": jnp.asarray(v) for k, v in p.items()},
                              "c", jnp.asarray(x), stride=2)
        return _nhwc(ours), np.asarray(ref), 1e-4
    if name == "conv_transpose":
        deconv = torch.nn.ConvTranspose2d(5, 9, 4, 2, 1)
        w = rng.standard_normal((5, 9, 4, 4)).astype(np.float32)   # IOHW
        b = rng.standard_normal(9).astype(np.float32)
        ours = _load(deconv, {"weight": w, "bias": b})(_nchw(x))
        ref = j_ifr.conv_transpose2d_k4s2p1(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(b))
        assert ours.shape == (2, 9, 20, 24)
        return _nhwc(ours), np.asarray(ref), 1e-4
    if name == "prelu":
        a = rng.uniform(0, 0.5, 5).astype(np.float32)
        ours = _load(torch.nn.PReLU(5), {"weight": a})(_nchw(x))
        return _nhwc(ours), np.asarray(j_ifr.prelu(jnp.asarray(x),
                                                   jnp.asarray(a))), 0.0
    if name == "resize":
        ours = t_ifr.resize_bilinear(_nchw(x), 2.0)
        return (_nhwc(ours), np.asarray(j_ifr.resize_bilinear(jnp.asarray(x),
                                                              2.0)), 1e-5)
    if name == "warp":
        flow = (rng.standard_normal((2, 10, 12, 2)) * 3).astype(np.float32)
        ours = t_ifr.warp(_nchw(x), _nchw(flow))
        return (_nhwc(ours), np.asarray(j_ifr.warp(jnp.asarray(x),
                                                   jnp.asarray(flow))), 1e-5)
    if name == "resblock":
        c = 40   # 32 side channels and 8 others
        x = rng.standard_normal((1, 8, 10, c)).astype(np.float32)

        def randn(*shape):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)

        p = {"conv5.weight": randn(c, c, 3, 3), "conv5.bias": randn(c),
             "prelu.weight": randn(c)}
        for name, ch in (("conv1", c), ("conv2", 32), ("conv3", c),
                         ("conv4", 32)):
            p.update({f"{name}.0.weight": randn(ch, ch, 3, 3),
                      f"{name}.0.bias": randn(ch),
                      f"{name}.1.weight": randn(ch)})
        ours = _load(t_ifr.ResBlock(c), p)(_nchw(x))
        ref = j_ifr._resblock({f"r.{k}": jnp.asarray(v) for k, v in p.items()},
                              "r", jnp.asarray(x))
        return _nhwc(ours), np.asarray(ref), 1e-4
    raise ValueError(name)


@pytest.mark.parametrize("op", ["conv", "conv_transpose", "prelu", "resize",
                                "warp", "resblock"])
def test_op_matches_jax(op):
    ours, ref, tol = _op_case(op, np.random.default_rng(0))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)


def test_param_spec_and_random_params_match_jax():
    assert t_ifr.param_spec() == j_ifr.param_spec()
    net = t_ifr.IFRNet()
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == \
        j_ifr.param_spec()
    a, b = t_ifr.random_params(3), j_ifr.random_params(3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def nets():
    raw = t_ifr.random_params(0)
    return raw, t_ifr.from_params(raw, device="cpu")


@pytest.mark.parametrize("hw", [(32, 48), (40, 56)])
def test_network_matches_jax(nets, hw):
    """The midway frame of the whole network (40x56 is padded to 48x64)."""
    raw, net = nets
    rng = np.random.default_rng(hw[0])
    img0, img1 = (rng.random(hw + (3,)).astype(np.float32) for _ in range(2))
    ours = t_ifr.interpolate(net, img0, img1)
    ref = j_ifr.interpolate(None, {k: jnp.asarray(v) for k, v in raw.items()},
                            img0, img1)
    assert ours.shape == hw + (3,)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    assert np.abs(ours - 0.5 * (img0 + img1)).max() > 1e-3


def test_checkpoints_and_vfi_provider(nets, tmp_path):
    """A torch.save'd state dict (module. prefix, float64, an extra buffer)
    and an npz load to the same network; the 'ifrnet' provider runs it and
    needs a checkpoint."""
    raw, net = nets
    sd = {f"module.{k}": torch.from_numpy(v.copy()).double()
          for k, v in raw.items()}
    sd["module.optimizer_junk"] = torch.zeros(3)
    pth = str(tmp_path / "ckpt.pth")
    torch.save(sd, pth)
    npz = str(tmp_path / "ckpt.npz")
    np.savez(npz, **raw)
    rng = np.random.default_rng(6)
    img0, img1 = (rng.random((32, 48, 3)).astype(np.float32)
                  for _ in range(2))
    want = t_ifr.interpolate(net, img0, img1)
    for path in (pth, npz):
        np.testing.assert_array_equal(
            t_ifr.interpolate(t_ifr.build(path, device="cpu"), img0, img1),
            want)
    # the module's own state_dict loads the public key names directly
    fresh = t_ifr.IFRNet()
    fresh.load_state_dict({k[len("module."):]: v.float() for k, v in sd.items()
                           if k != "module.optimizer_junk"})
    np.testing.assert_array_equal(t_ifr.interpolate(fresh, img0, img1), want)

    prov = t_vfi.make_vfi_provider("ifrnet", checkpoint=pth, device="cpu")
    np.testing.assert_array_equal(prov(img0, img1, "0_to_1"), want)
    with pytest.raises(ValueError, match="checkpoint"):
        t_vfi.make_vfi_provider("ifrnet", checkpoint=None, device="cpu")
    bad = dict(raw)
    bad.pop("decoder1.convblock.2.weight")
    with pytest.raises(ValueError, match="missing"):
        t_ifr.validate_params(bad)
