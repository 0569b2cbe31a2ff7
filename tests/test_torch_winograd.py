"""PyTorch port: the Winograd F(2^3, 3^3) conv (``ops/winograd.py``) and the
conv seam's backend switch, against the JAX package on the CPU in f32. The
Pallas kernel runs in interpret mode, as ``tests/test_pallas_winograd.py``
runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.models.unet3d import UNetConfig as JaxUNetConfig
from brats2019_tpu.ops import pallas_winograd as ref_wino
from brats2019_tpu.train.checkpoint import export_params
from brats2019_tpu_torch.configs.presets import UNetConfig
from brats2019_tpu_torch.ops import conv, winograd
from brats2019_tpu_torch.utils.weights import build_unet

# the shapes of tests/test_pallas_winograd.py plus one with ragged tile
# counts (6 x 7 x 5 tiles, the coarse net's deepest level)
SHAPES = [((1, 8, 8, 8, 8), 16), ((2, 8, 16, 8, 4), 8), ((1, 12, 14, 10, 8), 16)]


def _inputs(shape, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, shape[-1], co))
         / np.sqrt(27 * shape[-1])).astype(np.float32)
    return x, w


@pytest.fixture
def winograd_backend():
    conv.set_backend("winograd")
    yield
    conv.set_backend("direct")


@pytest.mark.parametrize("shape,co", SHAPES)
def test_plain_matches_pallas_interpret(shape, co):
    x, w = _inputs(shape, co)
    got = winograd.conv3d_winograd_plain(torch.from_numpy(x), torch.from_numpy(w))
    want = ref_wino.conv3d_winograd(jnp.asarray(x), jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,co", SHAPES)
def test_plain_matches_direct_conv(shape, co):
    x, w = _inputs(shape, co, seed=1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = winograd.conv3d_winograd(xt, wt)
    np.testing.assert_allclose(got.numpy(), conv.conv3d_plain(xt, wt).numpy(),
                               rtol=1e-4, atol=1e-4)
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ci,co", [(1, 1), (4, 8), (5, 3)])
def test_transform_weights_matches_reference(ci, co):
    w = np.random.default_rng(2).standard_normal((3, 3, 3, ci, co)).astype(np.float32)
    got = winograd.transform_weights(torch.from_numpy(w))
    want = ref_wino.transform_weights(jnp.asarray(w))
    assert got.shape == (64, ci, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 7, 8, 8, 4), (1, 8, 5, 8, 4), (1, 8, 8, 3, 4)])
def test_odd_dims_raise(shape):
    x, w = torch.zeros(shape), torch.zeros((3, 3, 3, 4, 8))
    with pytest.raises(ValueError, match="even"):
        winograd.conv3d_winograd(x, w)
    conv.set_backend("winograd")
    try:
        with pytest.raises(ValueError, match="even"):   # no fallback to direct
            conv.conv3d(x, w)
    finally:
        conv.set_backend("direct")


def test_backend_switch_and_bad_name(winograd_backend):
    assert conv.get_backend() == "winograd"
    with pytest.raises(ValueError):
        conv.set_backend("fft")
    assert conv.get_backend() == "winograd"


def test_padded_u_is_cached_per_weight_version():
    w = torch.from_numpy(_inputs((1, 4, 4, 4, 5), 6)[1]).to(torch.bfloat16)
    u = winograd.padded_u(w)
    assert u.shape == (64, 32, 64) and u.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        u[:, :5, :6].float().numpy(),
        winograd.transform_weights(w).to(torch.bfloat16).float().numpy())
    assert float(u[:, 5:].abs().max()) == 0 and float(u[:, :, 6:].abs().max()) == 0
    assert winograd.padded_u(w) is u
    w.mul_(2)                                   # a new version: transformed anew
    u2 = winograd.padded_u(w)
    assert u2 is not u
    np.testing.assert_array_equal(u2.float().numpy(), 2 * u.float().numpy())


def test_unet_forward_with_winograd_backend_matches_jax(tmp_path, winograd_backend):
    kw = dict(levels=2, base_features=4, max_features=8, stem_downsample=2,
              compute_dtype="float32")
    model = JaxUNet3D(JaxUNetConfig(**kw))
    x = np.random.default_rng(3).standard_normal((1, 16, 16, 16, 4)).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    path = str(tmp_path / "params.npz")
    export_params(path, params)
    net = build_unet(UNetConfig(**kw), path, "cpu")
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,co", SHAPES)
def test_gradients_through_winograd_equal_direct(shape, co):
    x, w = _inputs(shape, co, seed=4)
    gy = torch.from_numpy(
        np.random.default_rng(5).standard_normal(shape[:4] + (co,)).astype(np.float32))
    grads = {}
    for backend in ("direct", "winograd"):
        conv.set_backend(backend)
        try:
            xt = torch.from_numpy(x).requires_grad_()
            wt = torch.from_numpy(w).requires_grad_()
            conv.conv3d(xt, wt).backward(gy)
        finally:
            conv.set_backend("direct")
        grads[backend] = (xt.grad.numpy(), wt.grad.numpy())
    for a, b in zip(grads["winograd"], grads["direct"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
