"""PyTorch port: the hand-written kernels, forward and backward, against
their plain torch versions on a CUDA card, at edge shapes (ragged spatial
dims, channel counts that miss the 8-wide vector path, size-1 axes). Marked ``gpu``; without a card
each test skips. The card's host has no jax, so run these there without the
suite's conftest (which imports jax):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from brats2019_tpu_torch import ops
from brats2019_tpu_torch.ops import conv, norm, resize, winograd

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
    v = torch.ones(8, device=dev)
    for fn, args in ((ops.conv3d, (x, torch.randn((3, 3, 3, 8, 8), device=dev))),
                     (ops.instance_norm_act, (x,)),
                     (ops.downsample2x, (x,)), (ops.upsample2x, (x,)),
                     (ops.instance_norm_act_bwd, (x, x, v, v, v, v)),
                     (ops.downsample2x_bwd, (x, (1, 8, 8, 8, 8))),
                     (ops.upsample2x_bwd, (x,))):
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


# ----------------------------------------------------------------- backward --

def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def test_norm_kernel_returns_stats(dev):
    x = (torch.randn((2, 5, 6, 7, 24), device=dev) * 2 + 1).bfloat16()
    y, mean, rstd = norm.instance_norm_act_kernel(x, None, None)
    _, mean_p, rstd_p = norm._plain_stats(x, None, None, 1e-5, "relu")
    assert mean.shape == rstd.shape == (2, 24) and mean.dtype == torch.float32
    torch.testing.assert_close(mean, mean_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_p, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape", [
    (1, 6, 7, 5, 8), (2, 16, 16, 8, 64), (1, 3, 5, 7, 48), (1, 40, 40, 40, 3),
    (1, 8, 8, 8, 320), (1, 1, 1, 1, 16),
])
def test_norm_bwd_kernel_matches_plain(dev, activation, shape):
    gen = torch.Generator(device=dev).manual_seed(2)
    x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1).bfloat16()
    g = torch.randn(shape, generator=gen, device=dev).bfloat16()
    gam = torch.rand(shape[-1], generator=gen, device=dev) + 0.5
    bet = torch.randn(shape[-1], generator=gen, device=dev) * 0.2
    _, mean, rstd = norm._plain_stats(x, gam, bet, 1e-5, activation)
    before = ops.instance_norm_act_bwd.launches
    dx, dgam, dbet = ops.instance_norm_act_bwd(x, g, gam, bet, mean, rstd,
                                               activation)
    rdx, rdgam, rdbet = norm.instance_norm_act_bwd_plain(
        x, g, gam, bet, mean, rstd, activation)
    torch.cuda.synchronize()
    assert ops.instance_norm_act_bwd.launches == before + 1
    assert dx.dtype == torch.bfloat16 and dgam.dtype == torch.float32
    if shape[1:4] != (1, 1, 1):        # one voxel: dx is exactly 0
        assert _rel(dx, rdx) <= 1e-2
    torch.testing.assert_close(dgam, rdgam, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(dbet, rdbet, rtol=1e-3, atol=1e-3)


def test_norm_bwd_kernel_is_deterministic(dev):
    x = torch.randn((1, 32, 32, 32, 64), device=dev).bfloat16()
    g = torch.randn_like(x)
    gam, bet = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    _, mean, rstd = norm._plain_stats(x, gam, bet, 1e-5, "relu")
    a = ops.instance_norm_act_bwd(x, g, gam, bet, mean, rstd)
    b = ops.instance_norm_act_bwd(x, g, gam, bet, mean, rstd)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("x_shape", [
    (1, 4, 4, 4, 8), (2, 6, 10, 14, 16), (1, 7, 6, 5, 3), (1, 2, 2, 2, 320),
    (1, 64, 64, 64, 64),
])
def test_down_bwd_kernel_matches_plain(dev, x_shape):
    g = torch.randn((x_shape[0],) + tuple(s // 2 for s in x_shape[1:4])
                    + x_shape[4:], device=dev).bfloat16()
    got = ops.downsample2x_bwd(g, x_shape)
    ref = resize.downsample2x_bwd_plain(g, x_shape)
    assert got.shape == ref.shape == x_shape
    assert _ulps(got, ref) <= 1


@pytest.mark.parametrize("x_shape", [
    (1, 4, 4, 4, 8), (2, 5, 6, 7, 16), (1, 1, 1, 1, 8), (1, 1, 3, 2, 3),
    (1, 3, 4, 2, 320), (1, 2, 1, 2, 5), (1, 32, 32, 32, 128),
])
def test_up_bwd_kernel_matches_plain(dev, x_shape):
    g = torch.randn((x_shape[0],) + tuple(2 * s for s in x_shape[1:4])
                    + x_shape[4:], device=dev).bfloat16()
    got = ops.upsample2x_bwd(g)
    ref = resize.upsample2x_bwd_plain(g)
    assert got.shape == ref.shape == x_shape
    assert _ulps(got, ref) <= 1


def test_conv_autograd_dgrad_uses_the_kernel(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((1, 6, 7, 5, 40), generator=gen, device=dev).bfloat16()
    w = (torch.randn((3, 3, 3, 40, 24), generator=gen, device=dev)
         / (27 * 40) ** 0.5).bfloat16()
    gy = torch.randn((1, 6, 7, 5, 24), generator=gen, device=dev).bfloat16()
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = ops.conv3d.launches
    ops.conv3d(xr, wr).backward(gy)
    assert ops.conv3d.launches == before + 2       # forward + dgrad
    ref = conv.conv3d_plain(gy, conv.dgrad_weight(w))
    assert _rel(xr.grad, ref) <= 1e-2
    xf, wf = x.float().requires_grad_(True), w.float().requires_grad_(True)
    conv.conv3d_plain(xf, wf).backward(gy.float())
    assert wr.grad.dtype == torch.bfloat16
    assert _rel(wr.grad, wf.grad) <= 1e-2


def test_train_step_runs_on_the_card(dev):
    """One step of a small stem-2 net through every forward and backward
    kernel: finite loss, nonzero grad norm, all seven counters moved."""
    from brats2019_tpu_torch.configs.presets import TrainConfig, UNetConfig
    from brats2019_tpu_torch.train.loop import init_stage
    from brats2019_tpu_torch.train.step import make_microbatch_loss, train_update

    ucfg = UNetConfig(levels=3, base_features=16, max_features=32,
                      stem_downsample=2)
    tcfg = TrainConfig(patch=(32, 32, 32), steps=4, warmup_steps=1)
    model, opt = init_stage(ucfg, tcfg, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    imgs = torch.randn((1, 32, 32, 32, 4), generator=gen, device=dev)
    segs = torch.randint(0, 4, (1, 32, 32, 32), generator=gen, device=dev)
    ops.reset_launch_counts()
    aux = train_update(model, opt, make_microbatch_loss(tcfg, 2, lowres=True),
                       [(imgs, segs)])
    torch.cuda.synchronize()
    assert torch.isfinite(aux["loss"]) and aux["grad_norm"].item() > 0
    counts = ops.launch_counts()
    assert counts["instance_norm_act_bwd"] == 10
    assert counts["downsample2x_bwd"] == counts["upsample2x_bwd"] == 2
    assert counts["conv3d"] == 10 + 9             # forwards + dgrads


# ------------------------------------------------------ the Winograd conv --

@pytest.fixture()
def winograd_backend():
    conv.set_backend("winograd")
    yield
    conv.set_backend("direct")


@pytest.mark.parametrize("shape,co", [
    ((2, 8, 8, 8, 32), 64),        # N > 1, whole bricks
    ((1, 12, 14, 10, 96), 192),    # ragged tile counts: 6 x 7 x 5 tiles
    ((3, 2, 2, 2, 16), 16),        # one tile per sample, a brick mostly masked
    ((1, 6, 10, 4, 24), 48),       # Ci not a multiple of 16, Co = 48
    ((1, 4, 4, 6, 20), 12),        # scalar path: Ci, Co not multiples of 8
    ((1, 8, 8, 8, 576), 48),       # the widest Ci (18 chunks), a Co tail
    ((1, 4, 4, 4, 40), 200),       # Ci tail inside a chunk, 4 Co blocks
])
def test_winograd_kernel_matches_plain_and_direct(dev, shape, co):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    w = (torch.randn((3, 3, 3, shape[-1], co), generator=g, device=dev)
         / (27 * shape[-1]) ** 0.5).bfloat16()
    before = ops.conv3d_winograd.launches
    got = ops.conv3d_winograd(x, w)
    torch.cuda.synchronize()
    assert ops.conv3d_winograd.launches == before + 1
    assert got.shape == shape[:4] + (co,) and got.dtype == torch.bfloat16
    assert torch.equal(got, ops.conv3d_winograd(x, w))       # fixed order
    scale = conv.conv3d_plain(x, w).float().abs().max()
    for ref in (winograd.conv3d_winograd_plain(x, w), conv.conv3d_plain(x, w)):
        err = (got.float() - ref.float()).abs().max() / scale
        assert err.item() <= 2e-2


def test_winograd_kernel_rejects_odd_dims_and_f32(dev):
    w = torch.zeros((3, 3, 3, 8, 8), device=dev).bfloat16()
    with pytest.raises(ValueError, match="even"):
        ops.conv3d_winograd(torch.zeros((1, 4, 5, 4, 8), device=dev).bfloat16(), w)
    with pytest.raises(TypeError):
        ops.conv3d_winograd(torch.zeros((1, 4, 4, 4, 8), device=dev), w.float())


def test_winograd_backend_under_autograd(dev, winograd_backend):
    """The seam's shared backward: dgrad through the Winograd kernel, wgrad
    cuDNN; the grads match the direct backend's within bf16 noise."""
    g = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randn((1, 8, 8, 8, 32), generator=g, device=dev).bfloat16()
    w0 = (torch.randn((3, 3, 3, 32, 48), generator=g, device=dev) / 30).bfloat16()
    gy = torch.randn((1, 8, 8, 8, 48), generator=g, device=dev).bfloat16()
    grads = {}
    for backend in ("winograd", "direct"):
        conv.set_backend(backend)
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        before = (ops.conv3d_winograd.launches, ops.conv3d.launches)
        ops.conv3d(x, w).backward(gy)
        after = (ops.conv3d_winograd.launches, ops.conv3d.launches)
        used = 0 if backend == "winograd" else 1
        assert after[used] == before[used] + 2 and after[1 - used] == before[1 - used]
        grads[backend] = (x.grad.float(), w.grad.float())
    for a, b in zip(grads["winograd"], grads["direct"]):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 2e-2


def test_winograd_weight_cache_follows_updates(dev):
    w = (torch.randn((3, 3, 3, 16, 16), device=dev) / 20).bfloat16()
    x = torch.randn((1, 4, 4, 4, 16), device=dev).bfloat16()
    a = ops.conv3d_winograd(x, w)
    assert winograd.padded_u(w) is winograd.padded_u(w)
    w.mul_(2)
    b = ops.conv3d_winograd(x, w)
    assert ((b.float() - 2 * a.float()).abs().max() / b.float().abs().max()
            ).item() <= 2e-2


def test_device_connected_components_on_the_card_equal_cpu(dev):
    from brats2019_tpu_torch.ops import connected_components as cc

    g = torch.Generator().manual_seed(2)
    labels = (torch.rand((40, 48, 36), generator=g) < 0.12).to(torch.uint8) * 2
    labels[5:20, 5:20, 5:20] = 3
    want = cc.postprocess_device(labels, 16, 32)
    got = cc.postprocess_device(labels.to(dev), 16, 32)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(cc.label_components(labels.to(dev) > 0).cpu(),
                       cc.label_components(labels > 0))
