"""PyTorch port: the hand-written kernels against their plain torch versions
on a CUDA card, at edge shapes (ragged spatial dims, channel counts that
miss the 8-wide vector path, size-1 axes). Marked ``gpu``; without a card
each test skips. The card's host has no jax, so run these there without the
suite's conftest (which imports jax):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from brats2019_tpu_torch import ops
from brats2019_tpu_torch.ops import conv, norm, resize

pytestmark = pytest.mark.gpu


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _ulps(got, ref, floor=2.0 ** -10):
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(floor))) - 7)
    return ((got.float() - ref).abs() / ulp).max().item()


@pytest.mark.parametrize("shape,co", [
    ((1, 5, 6, 7, 8), 16),        # vector path, ragged spatial
    ((2, 8, 8, 8, 32), 48),       # Co tail inside a 64-wide tile
    ((1, 12, 14, 10, 96), 192),   # the coarse net's deepest level
    ((1, 3, 4, 5, 4), 6),         # scalar path: Ci, Co not multiples of 8
    ((1, 1, 1, 3, 40), 8),        # size-1 axes, Ci tail inside a chunk
    ((2, 9, 3, 130, 16), 24),     # M not a multiple of the 128-row tile
])
def test_conv_kernel_matches_plain(dev, shape, co):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    w = (torch.randn((3, 3, 3, shape[-1], co), generator=g, device=dev)
         / (27 * shape[-1]) ** 0.5).bfloat16()
    before = ops.conv3d.launches
    got = ops.conv3d(x, w)
    ref = conv.conv3d_plain(x, w)
    torch.cuda.synchronize()
    assert ops.conv3d.launches == before + 1
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= 1e-2


def test_conv_kernel_is_deterministic(dev):
    x = torch.randn((2, 8, 8, 8, 64), device=dev).bfloat16()
    w = torch.randn((3, 3, 3, 64, 64), device=dev).bfloat16() * 0.02
    assert torch.equal(ops.conv3d(x, w), ops.conv3d(x, w))


def test_kernels_reject_f32(dev):
    x = torch.randn((1, 4, 4, 4, 8), device=dev)
    for fn, args in ((ops.conv3d, (x, torch.randn((3, 3, 3, 8, 8), device=dev))),
                     (ops.instance_norm_act, (x,)),
                     (ops.downsample2x, (x,)), (ops.upsample2x, (x,))):
        with pytest.raises(TypeError):
            fn(*args)


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape", [
    (1, 6, 7, 5, 8), (2, 16, 16, 8, 64), (1, 3, 5, 7, 48), (1, 40, 40, 40, 3),
])
def test_norm_kernel_matches_plain(dev, activation, shape):
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).bfloat16()
    gam = torch.rand(shape[-1], generator=g, device=dev) + 0.5
    bet = torch.randn(shape[-1], generator=g, device=dev) * 0.2
    got = ops.instance_norm_act(x, gam, bet, activation=activation)
    ref = norm.instance_norm_act_plain(x, gam, bet, activation=activation)
    assert got.dtype == torch.bfloat16
    assert _ulps(got, ref) <= 2


def test_norm_kernel_is_deterministic(dev):
    x = torch.randn((8, 32, 32, 32, 64), device=dev).bfloat16()
    a = ops.instance_norm_act(x)
    assert torch.equal(a, ops.instance_norm_act(x))


@pytest.mark.parametrize("shape", [
    (1, 4, 4, 4, 8), (2, 6, 10, 14, 16), (1, 7, 6, 5, 3), (1, 2, 2, 2, 320),
])
def test_downsample_kernel_matches_plain(dev, shape):
    x = torch.randn(shape, device=dev).bfloat16()
    got, ref = ops.downsample2x(x), resize.downsample2x_plain(x)
    assert got.shape == ref.shape
    assert _ulps(got, ref) <= 1


@pytest.mark.parametrize("shape", [
    (1, 4, 4, 4, 8), (2, 5, 6, 7, 16), (1, 1, 1, 1, 8), (1, 1, 3, 2, 3),
    (1, 3, 4, 2, 320),
])
def test_upsample_kernel_matches_plain(dev, shape):
    x = torch.randn(shape, device=dev).bfloat16()
    got, ref = ops.upsample2x(x), resize.upsample2x_plain(x)
    assert got.shape == ref.shape
    assert _ulps(got, ref) <= 1
