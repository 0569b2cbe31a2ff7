"""PyTorch port: each kernel seam's plain version against the JAX package's
default op (jnp / XLA, what the slice computes) and against its Pallas
kernel run in interpret mode, in f32 on the CPU. Tolerance 1e-5 abs +
1e-4 rel: the same math, summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental.pallas import tpu as pltpu

from brats2019_tpu.ops import pallas_resize
from brats2019_tpu.ops import resize as jax_resize
from brats2019_tpu.ops.norm import instance_norm_act_jnp
from brats2019_tpu.ops.pallas_conv import conv3d_pallas
from brats2019_tpu.ops.pallas_norm import instance_norm_act_pallas
from brats2019_tpu_torch.ops import conv, norm, resize

TOL = dict(atol=1e-5, rtol=1e-4)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


# ------------------------------------------------------------------- conv --

def _xla_conv(x, w):
    return lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
    )


@pytest.mark.parametrize("shape,co", [
    ((1, 8, 8, 8, 8), 16),
    ((2, 8, 16, 8, 4), 8),
    ((1, 6, 7, 5, 12), 8),     # ragged, coarse-like: XLA path only
    ((1, 3, 1, 2, 4), 4),
])
def test_conv_plain_matches_xla(shape, co):
    x, w = _rand(shape, 0), _rand((3, 3, 3, shape[-1], co), 1, 0.2)
    _close(conv.conv3d_plain(torch.from_numpy(x), torch.from_numpy(w)),
           _xla_conv(x, w))


@pytest.mark.parametrize("shape,co", [((1, 8, 8, 8, 8), 16), ((2, 8, 16, 8, 4), 8)])
def test_conv_plain_matches_pallas_interpret(shape, co):
    x, w = _rand(shape, 2), _rand((3, 3, 3, shape[-1], co), 3, 0.2)
    want = conv3d_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True)
    _close(conv.conv3d_plain(torch.from_numpy(x), torch.from_numpy(w)), want)


def test_conv_plain_bf16_is_f32_math_rounded():
    x = torch.from_numpy(_rand((1, 4, 5, 6, 8), 4)).bfloat16()
    w = torch.from_numpy(_rand((3, 3, 3, 8, 8), 5, 0.2)).bfloat16()
    got = conv.conv3d_plain(x, w)
    assert got.dtype == torch.bfloat16
    want = _xla_conv(x.float().numpy(), w.float().numpy())
    np.testing.assert_array_equal(
        got.float().numpy(),
        torch.from_numpy(np.array(want)).bfloat16().float().numpy(),
    )


# ------------------------------------------------------------------- norm --

NORM_SHAPE = (2, 16, 16, 8, 8)   # S = 2048 divides the Pallas block


def _norm_data(shape, seed=0):
    x = _rand(shape, seed, 3.0, 1.0)
    g = _rand(shape[-1:], seed + 1, 0.5, 1.0)
    b = _rand(shape[-1:], seed + 2, 0.2)
    return x, g, b


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape", [NORM_SHAPE, (1, 6, 7, 5, 8)])
def test_norm_plain_matches_jnp(activation, shape):
    x, g, b = _norm_data(shape)
    want = instance_norm_act_jnp(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                 activation=activation)
    got = norm.instance_norm_act_plain(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b),
        activation=activation,
    )
    _close(got, want)


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
def test_norm_plain_matches_pallas_interpret(activation):
    x, g, b = _norm_data(NORM_SHAPE, seed=4)
    with pltpu.force_tpu_interpret_mode():
        want = instance_norm_act_pallas(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), activation=activation
        )
    got = norm.instance_norm_act_plain(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b),
        activation=activation,
    )
    _close(got, want)


def test_norm_plain_without_affine():
    x, _, _ = _norm_data(NORM_SHAPE, seed=7)
    want = instance_norm_act_jnp(jnp.asarray(x), None, None, activation="relu")
    _close(norm.instance_norm_act_plain(torch.from_numpy(x), None, None), want)


# ----------------------------------------------------------------- resize --

@pytest.mark.parametrize("shape", [
    (1, 4, 4, 4, 8), (2, 8, 6, 4, 16), (1, 6, 14, 10, 8), (1, 7, 6, 5, 4),
])
def test_downsample_plain_matches_jnp(shape):
    x = _rand(shape, 8)
    _close(resize.downsample2x_plain(torch.from_numpy(x)),
           jax_resize.downsample2x_jnp(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(1, 4, 4, 4, 8), (2, 8, 6, 4, 16)])
def test_downsample_plain_matches_pallas_interpret(monkeypatch, shape):
    monkeypatch.setattr(pallas_resize, "_INTERPRET", True)
    x = _rand(shape, 9)
    _close(resize.downsample2x_plain(torch.from_numpy(x)),
           pallas_resize.downsample2x_pallas(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [
    (1, 4, 4, 4, 8), (2, 5, 6, 7, 16), (1, 1, 8, 8, 8), (1, 6, 7, 5, 8),
])
def test_upsample_plain_matches_jnp(shape):
    x = _rand(shape, 10)
    _close(resize.upsample2x_plain(torch.from_numpy(x)),
           jax_resize.upsample2x_jnp(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(1, 4, 4, 4, 8), (2, 5, 6, 7, 16), (1, 1, 2, 2, 8)])
def test_upsample_plain_matches_pallas_interpret(monkeypatch, shape):
    monkeypatch.setattr(pallas_resize, "_INTERPRET", True)
    x = _rand(shape, 11)
    _close(resize.upsample2x_plain(torch.from_numpy(x)),
           pallas_resize.upsample2x_pallas(jnp.asarray(x)))


@pytest.mark.parametrize("src,dst", [
    ((24, 28, 20), (12, 14, 10)),   # the canvas -> coarse 2x shrink (antialiased)
    ((20, 18, 16), (12, 14, 10)),   # non-integer factors
    ((12, 14, 10), (24, 28, 20)),   # growing: plain linear
    ((8, 9, 10), (8, 5, 10)),       # identity axes are skipped
])
def test_resize_trilinear_matches_jax_image_resize(src, dst):
    x = _rand(src + (4,), 12)
    want = jax_resize.resize_trilinear(jnp.asarray(x), dst)
    _close(resize.resize_trilinear(torch.from_numpy(x), dst), want)


def test_resize_trilinear_shrink_is_antialiased():
    """jax.image.resize's 2x shrink is the (1,3,3,1)/8 filter with (3,3,1)/7
    edges, not the 2-tap average of F.interpolate."""
    wmat = resize.linear_weight_matrix(8, 4)
    np.testing.assert_allclose(wmat[:3, 0], [3 / 7, 3 / 7, 1 / 7], rtol=1e-6)
    np.testing.assert_allclose(wmat[1:5, 1], [1 / 8, 3 / 8, 3 / 8, 1 / 8], rtol=1e-6)
    from jax._src.image.scale import compute_weight_mat

    for n_in, n_out in ((192, 96), (224, 112), (160, 80), (10, 20), (7, 3)):
        want = compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                  lambda t: jnp.maximum(0, 1 - jnp.abs(t)), True)
        np.testing.assert_allclose(resize.linear_weight_matrix(n_in, n_out),
                                   np.asarray(want), atol=1e-7)
    x = torch.from_numpy(_rand((1, 8, 8, 8, 2), 13))
    naive = torch.nn.functional.interpolate(
        x.permute(0, 4, 1, 2, 3), size=(4, 4, 4), mode="trilinear",
        align_corners=False,
    ).permute(0, 2, 3, 4, 1)
    assert (resize.resize_trilinear(x, (4, 4, 4)) - naive).abs().max() > 0.05


def test_bf16_plain_ops_keep_dtype():
    x = torch.from_numpy(_rand((1, 4, 4, 4, 8), 14)).bfloat16()
    for fn in (resize.downsample2x_plain, resize.upsample2x_plain,
               lambda t: norm.instance_norm_act_plain(t, None, None)):
        assert fn(x).dtype == torch.bfloat16
