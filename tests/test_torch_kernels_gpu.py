"""PyTorch port: the hand-written kernels, forward and backward, against
their plain torch versions on a CUDA card, at edge shapes (ragged spatial
dims, channel counts that miss the 8-wide vector path, size-1 axes). Marked ``gpu``; without a card
each test skips. The card's host has no jax, so run these there without the
suite's conftest (which imports jax):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from brats2019_tpu_torch import ops
from brats2019_tpu_torch.ops import connected_components as cc
from brats2019_tpu_torch.ops import conv, norm, resize, winograd
from cc_masks import MASKS, snake

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


def _conv_inputs(dev, shape, co, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    w = (torch.randn((3, 3, 3, shape[-1], co), generator=g, device=dev)
         / (27 * shape[-1]) ** 0.5).bfloat16()
    return x, w


@pytest.mark.parametrize("shape,co,instance", [
    ((1, 5, 6, 7, 8), 16, "mma_sync"),        # Ci % 16 != 0: vector path, ragged
    ((2, 8, 8, 8, 32), 48, "wgmma"),          # Co = 48 tail inside a 64-wide tile
    ((1, 12, 14, 10, 96), 192, "wgmma"),      # the coarse net's deepest level
    ((1, 3, 4, 5, 4), 6, "mma_sync"),         # scalar path: Ci, Co not multiples of 8
    ((1, 1, 1, 3, 40), 8, "mma_sync"),        # size-1 axes, Ci tail inside a chunk
    ((2, 9, 3, 130, 16), 24, "wgmma"),        # ragged on every axis, 17 boxes along w
    ((1, 5, 6, 7, 16), 16, "wgmma"),          # one ragged box, one k-step
    ((1, 8, 16, 8, 64), 96, "wgmma"),         # Co = 96: a 128-wide tile with a tail
    ((1, 12, 14, 10, 192), 192, "wgmma"),     # three whole chunks
    ((2, 4, 8, 8, 16), 8, "wgmma"),           # N = 2: boxes must not read across samples
    ((1, 4, 8, 8, 576), 256, "wgmma"),        # nine chunks: both rings wrap
    ((1, 16, 16, 16, 144), 40, "wgmma"),      # 64 + 64 + 16 channels, Co = 40
    ((1, 8, 8, 8, 16), 20, "mma_sync"),       # Co % 8 != 0
])
def test_conv_kernel_matches_plain(dev, shape, co, instance):
    x, w = _conv_inputs(dev, shape, co)
    assert conv.plan_conv(*shape, co).instance == instance
    before = (ops.conv3d.launches, ops.conv3d.launches_wgmma)
    got = ops.conv3d(x, w)
    ref = conv.conv3d_plain(x, w)
    torch.cuda.synchronize()
    assert ops.conv3d.launches == before[0] + 1
    assert ops.conv3d.launches_wgmma == before[1] + (instance == "wgmma")
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= 1e-2


@pytest.mark.parametrize("bd,bn", conv.WGMMA_INSTANCES)
@pytest.mark.parametrize("shape,co", [
    ((1, 5, 6, 7, 16), 16),        # one box, ragged on every axis
    ((2, 3, 9, 10, 32), 48),       # N = 2, D smaller than any box
    ((1, 12, 14, 10, 96), 192),
    ((1, 8, 8, 16, 80), 136),      # Ci tail in a chunk; Co tail in the third 64-wide box
])
def test_every_wgmma_instance_matches_plain(dev, shape, co, bd, bn):
    x, w = _conv_inputs(dev, shape, co, seed=1)
    plan = conv.wgmma_plan(*shape, co, bd, bn)
    assert conv._lib_wgmma().conv3d_wgmma_smem_bytes(bd, bn) == plan.smem_bytes
    got = conv.conv3d_kernel_wgmma(x, w, plan)
    ref = conv.conv3d_plain(x, w)
    err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= 1e-2
    assert torch.equal(got, conv.conv3d_kernel_wgmma(x, w, plan))


@pytest.mark.parametrize("sms", [1, 3, 7])
def test_wgmma_blocks_walk_many_tiles(dev, sms):
    """Planned for a device of a few SMs, each persistent block walks many
    tiles and its rings wrap across them: bitwise the one-block-per-tile run."""
    shape, co = (2, 9, 16, 24, 80), 136
    x, w = _conv_inputs(dev, shape, co, seed=4)
    for bd, bn in conv.WGMMA_INSTANCES:
        few = conv.wgmma_plan(*shape, co, bd, bn, sms)
        many = conv.wgmma_plan(*shape, co, bd, bn, 10 ** 6)
        assert few.blocks == sms and many.blocks == many.grid > sms
        assert torch.equal(conv.conv3d_kernel_wgmma(x, w, few),
                           conv.conv3d_kernel_wgmma(x, w, many))


def test_wgmma_halo_is_zero_at_every_face(dev):
    """An all-ones volume and an all-ones kernel: each output is Ci x the
    number of taps inside the volume (27 inside, 18 on a face, 12 on an edge,
    8 at a corner). A loader that read across a face, into the next sample or
    past the end would change a count."""
    n, d, h, wd, ci = 2, 9, 10, 17, 16
    x = torch.ones((n, d, h, wd, ci), device=dev).bfloat16()
    w = torch.ones((3, 3, 3, ci, 8), device=dev).bfloat16()
    got = ops.conv3d(x, w).float()
    cnt = lambda size: torch.tensor([3 - (i == 0) - (i == size - 1)
                                     for i in range(size)], device=dev).float()
    want = (cnt(d)[:, None, None] * cnt(h)[None, :, None] * cnt(wd)[None, None, :]
            * ci)
    assert torch.equal(got, want[None, ..., None].expand_as(got))   # exact in bf16


def test_wgmma_boxes_do_not_read_across_samples(dev):
    x, w = _conv_inputs(dev, (2, 4, 8, 8, 32), 64, seed=2)
    both = ops.conv3d(x, w)
    for s in range(2):
        assert torch.equal(both[s:s + 1], ops.conv3d(x[s:s + 1].contiguous(), w))


@pytest.mark.parametrize("shape,co", [
    ((1, 12, 14, 10, 192), 192), ((2, 8, 8, 8, 32), 48), ((1, 4, 8, 8, 576), 256),
])
def test_wgmma_kernel_against_mma_sync_kernel(dev, shape, co):
    """Both kernels on the same input: each within 1e-2 of the plain f32
    version, and within 2 bf16 ulp of each other on >= 99% of elements (the
    same products, f32 sums in another order, one rounding)."""
    x, w = _conv_inputs(dev, shape, co, seed=3)
    new = conv.conv3d_kernel_wgmma(x, w).float()
    old = conv.conv3d_kernel_mma_sync(x, w).float()
    ref = conv.conv3d_plain(x, w).float()
    for got in (new, old):
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-2
    ulp = torch.exp2(torch.floor(torch.log2(old.abs().clamp_min(2.0 ** -10))) - 7)
    assert ((new - old).abs() <= 2 * ulp).float().mean().item() >= 0.99


def test_conv_kernel_is_deterministic(dev):
    x = torch.randn((2, 8, 8, 8, 64), device=dev).bfloat16()
    w = torch.randn((3, 3, 3, 64, 64), device=dev).bfloat16() * 0.02
    before = ops.conv3d.launches_wgmma
    assert torch.equal(ops.conv3d(x, w), ops.conv3d(x, w))
    assert ops.conv3d.launches_wgmma == before + 2


def test_wgmma_wrapper_rejects_other_channel_counts(dev):
    x = torch.zeros((1, 4, 4, 4, 8), device=dev).bfloat16()
    w = torch.zeros((3, 3, 3, 8, 8), device=dev).bfloat16()
    with pytest.raises(ValueError, match="wgmma"):
        conv.conv3d_kernel_wgmma(x, w)


def test_kernels_reject_f32(dev):
    """float16 has no kernel (bf16 and f32 do: the f32 routes are held
    below)."""
    x = torch.randn((1, 4, 4, 4, 8), device=dev).half()
    v = torch.ones(8, device=dev)
    for fn, args in ((ops.conv3d, (x, torch.randn((3, 3, 3, 8, 8), device=dev).half())),
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
    before = (ops.conv3d.launches, ops.conv3d.launches_wgmma)
    ops.conv3d(xr, wr).backward(gy)
    assert ops.conv3d.launches == before[0] + 2       # forward + dgrad
    assert ops.conv3d.launches_wgmma == before[1]     # Ci = 40, 24: mma.sync both
    ref = conv.conv3d_plain(gy, conv.dgrad_weight(w))
    assert _rel(xr.grad, ref) <= 1e-2
    xf, wf = x.float().requires_grad_(True), w.float().requires_grad_(True)
    conv.conv3d_plain(xf, wf).backward(gy.float())
    assert wr.grad.dtype == torch.bfloat16
    assert _rel(wr.grad, wf.grad) <= 1e-2


def test_conv_autograd_dgrad_through_the_wgmma_kernel(dev):
    """Forward (32 -> 144) and dgrad (144 -> 32, the flipped, transposed
    weight) both on the wgmma instance; wgrad is cuDNN."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((1, 6, 10, 12, 32), generator=gen, device=dev).bfloat16()
    w = (torch.randn((3, 3, 3, 32, 144), generator=gen, device=dev)
         / (27 * 32) ** 0.5).bfloat16()
    gy = torch.randn((1, 6, 10, 12, 144), generator=gen, device=dev).bfloat16()
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = (ops.conv3d.launches, ops.conv3d.launches_wgmma)
    ops.conv3d(xr, wr).backward(gy)
    assert ops.conv3d.launches == before[0] + 2
    assert ops.conv3d.launches_wgmma == before[1] + 2
    assert _rel(xr.grad, conv.conv3d_plain(gy, conv.dgrad_weight(w))) <= 1e-2
    xf, wf = x.float().requires_grad_(True), w.float().requires_grad_(True)
    conv.conv3d_plain(xf, wf).backward(gy.float())
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
    assert ops.conv3d.launches_wgmma == 19        # every width a multiple of 16


# ---------------------------------- the conv's statistics epilogue (STATS) --

def _norm_affine(dev, c, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand(c, generator=g, device=dev) + 0.5,
            torch.randn(c, generator=g, device=dev) * 0.2)


@pytest.mark.parametrize("bd,bn", conv.WGMMA_INSTANCES)
@pytest.mark.parametrize("shape,co", [
    ((1, 5, 6, 7, 16), 16),        # one box, ragged on every face
    ((2, 9, 7, 13, 32), 24),       # N = 2, Co tail inside the tile
    ((1, 8, 8, 16, 80), 136),      # Ci tail in a chunk; Co tail in the third box
    ((1, 4, 8, 8, 64), 64),        # whole boxes only
])
def test_stats_conv_y_bitwise_and_partials_match_plain(dev, shape, co, bd, bn):
    x, w = _conv_inputs(dev, shape, co, seed=6)
    plan = conv.wgmma_plan(*shape, co, bd, bn)
    assert (conv._lib_wgmma().conv3d_wgmma_stats_smem_bytes(bd, bn)
            == conv.wgmma_smem_bytes(bd, bn, stats=True) <= conv.SMEM_LIMIT)
    before = ops.conv3d.launches_stats
    y0 = conv.conv3d_kernel_wgmma(x, w, plan)
    y, part = conv.conv3d_kernel_wgmma(x, w, plan, stats=True)
    torch.cuda.synchronize()
    assert ops.conv3d.launches_stats == before + 1
    assert torch.equal(y, y0)
    ref = conv.conv_stats_plain(y, plan)
    assert part.shape == ref.shape
    assert torch.equal(part[0], ref[0])            # counts are exact
    for i in (1, 2):
        assert _rel(part[i], ref[i]) <= 1e-5
    mean, rstd = norm.merge_partials_plain(part)
    _, rmean, rrstd = norm._plain_stats(y, None, None, 1e-5, "none")
    assert _rel(mean, rmean) <= 1e-5 and _rel(rstd, rrstd) <= 1e-5


def test_stats_partials_are_deterministic(dev):
    x, w = _conv_inputs(dev, (8, 16, 16, 16, 64), 64, seed=7)
    y, part = ops.conv3d(x, w, stats=True)
    for _ in range(2):
        y2, part2 = ops.conv3d(x, w, stats=True)
        assert torch.equal(y, y2) and torch.equal(part, part2)


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape,co", [((2, 9, 7, 13, 32), 24),
                                      ((1, 12, 14, 10, 96), 192)])
def test_norm_from_partials_matches_plain(dev, activation, shape, co):
    x, w = _conv_inputs(dev, shape, co, seed=8)
    y, part = ops.conv3d(x, w, stats=True)
    gam, bet = _norm_affine(dev, co)
    before = (ops.instance_norm_act.launches,
              ops.instance_norm_act.launches_partials)
    got = ops.instance_norm_act(y, gam, bet, activation=activation, partials=part)
    again = ops.instance_norm_act(y, gam, bet, activation=activation,
                                  partials=part)
    ref = norm.instance_norm_act_plain(y, gam, bet, activation=activation)
    torch.cuda.synchronize()
    assert (ops.instance_norm_act.launches - before[0],
            ops.instance_norm_act.launches_partials - before[1]) == (2, 2)
    assert _ulps(got, ref) <= 2 and torch.equal(got, again)


def test_conv_norm_block_takes_the_partials_route(dev):
    """ConvNormAct on the card: the wgmma conv with its epilogue, then IN+act
    from its partials; an odd-channel conv (csrc/conv3d.cu) gives none."""
    from brats2019_tpu_torch.models.blocks import ConvNormAct

    for ci, wgmma in ((32, True), (8, False)):
        block = ConvNormAct(ci, 16).to(dev)
        with torch.no_grad():
            block.Conv_0.kernel.normal_(0, 0.1)
        x = torch.randn((1, 6, 7, 9, ci), device=dev)
        ops.reset_launch_counts()
        with torch.inference_mode():
            got = block(x)
        xc = x.bfloat16()
        ref = norm.instance_norm_act_plain(
            ops.conv3d(xc, block.Conv_0.kernel.detach().bfloat16()),
            block.in_scale, block.in_bias)
        torch.cuda.synchronize()
        assert ops.conv3d.launches_stats == int(wgmma)
        assert ops.instance_norm_act.launches_partials == int(wgmma)
        assert _ulps(got, ref) <= 2


# ------------------------------------------------ the 2x up (resize2x.cu) --

@pytest.mark.parametrize("shape", [
    (1, 1, 1, 1, 8),          # extent 1: every tap lands on the one voxel
    (1, 1, 3, 1, 16),
    (2, 5, 7, 9, 24),         # odd extents, ragged tiles on every axis
    (1, 9, 5, 17, 72),        # C = 64 + 8: a one-piece chunk
    (1, 3, 4, 2, 320),        # five chunks
    (3, 4, 4, 8, 40),         # C < 64, N = 3
])
def test_upsample_cuda_kernel_matches_plain(dev, shape):
    x = torch.randn(shape, device=dev).bfloat16()
    before = ops.upsample2x.launches_cuda
    got = resize.upsample2x_kernel(x)
    again = resize.upsample2x_kernel(x)
    ref = resize.upsample2x_plain(x)
    torch.cuda.synchronize()
    assert ops.upsample2x.launches_cuda == before + 2
    assert got.shape == ref.shape and _ulps(got, ref) <= 1
    assert torch.equal(got, again)
    assert _ulps(got, resize.upsample2x_kernel_triton(x)) <= 1


@pytest.mark.parametrize("shape,cs", [((2, 5, 6, 7, 16), 24), ((1, 4, 4, 4, 128), 64),
                                      ((1, 3, 4, 5, 3), 5), ((1, 2, 3, 2, 8), 3)])
def test_upsample_concat_slice(dev, shape, cs):
    """up(x) written into the concat buffer's first C channels, skip copied
    into the rest: equal to cat of the separate ops; gradients split back."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    n, d, h, w, c = shape
    skip = torch.randn((n, 2 * d, 2 * h, 2 * w, cs), generator=g,
                       device=dev).bfloat16()
    before = ops.upsample2x.launches_concat
    got = ops.upsample2x_concat(x, skip)
    torch.cuda.synchronize()
    into = c % 8 == 0 and (c + cs) % 8 == 0
    assert ops.upsample2x.launches_concat == before + into
    assert torch.equal(got[..., c:], skip)
    assert _ulps(got[..., :c], resize.upsample2x_plain(x)) <= 1
    xr, sr = x.clone().requires_grad_(), skip.clone().requires_grad_()
    gy = torch.randn(got.shape, generator=g, device=dev).bfloat16()
    ops.upsample2x_concat(xr, sr).backward(gy)
    assert torch.equal(sr.grad, gy[..., c:])
    assert torch.equal(xr.grad, resize.upsample2x_bwd_kernel(gy[..., :c].contiguous()))


# ------------------------------------------------ the crop handoff (F1) --

def test_stage_roi_never_waits_for_the_card(dev):
    """stage_roi under torch.cuda.set_sync_debug_mode("error") (after one
    call that builds its device constants): no device-to-host read; the same
    start and tiles as a call outside that mode."""
    from brats2019_tpu_torch.configs.presets import InferenceConfig, UNetConfig
    from brats2019_tpu_torch.models.cascade import SplitCascade
    from brats2019_tpu_torch.utils.weights import build_unet, init_params

    cfg_u = UNetConfig(levels=2, base_features=16, stem_downsample=2)
    fine = build_unet(cfg_u, init_params(cfg_u, seed=1), dev)
    coarse = build_unet(cfg_u, init_params(cfg_u, seed=2), dev)
    canvas = (64, 64, 48)
    icfg = InferenceConfig(canvas=canvas, tile=(32, 32, 32),
                           roi_shape=(32, 32, 32), coarse_shape=(32, 32, 24),
                           cascade=True, tta_flips=True)
    prog = SplitCascade(fine, coarse, icfg, canvas)
    image = torch.randn(canvas + (4,), generator=torch.Generator(device=dev)
                        .manual_seed(10), device=dev)
    with torch.inference_mode():
        tiles0, start0 = prog.stage_roi(image)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tiles, start = prog.stage_roi(image)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(start, start0) and torch.equal(tiles, tiles0)
    assert tiles.shape == (8, 32, 32, 32, 4)
    from brats2019_tpu_torch.data.preprocess import zscore

    sx, sy, sz = start.tolist()
    want = zscore(image.float())[sx:sx + 32, sy:sy + 32, sz:sz + 32]
    assert torch.equal(tiles[0], want.to(tiles.dtype))   # the identity flip


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


@pytest.mark.parametrize("shape,co,instance", [
    ((1, 8, 8, 8, 16), 8, "wgmma"),           # one brick, half a chunk, 8 channels
    ((1, 8, 8, 8, 64), 32, "wgmma"),          # one consumer half of N masked
    ((1, 12, 14, 10, 96), 192, "wgmma"),      # ragged bricks: 6 x 7 x 5 tiles
    ((2, 6, 4, 18, 48), 40, "wgmma"),         # 3 x 2 x 9 tiles, Ci and Co tails
    ((2, 24, 28, 20, 32), 48, "wgmma"),       # 72 bricks, ragged on every axis
    ((1, 4, 8, 8, 576), 256, "wgmma"),        # 18 chunks: the rings wrap
    ((1, 32, 64, 64, 16), 16, "wgmma"),       # 256 bricks: blocks walk several
    ((1, 6, 10, 4, 24), 48, "mma_sync"),      # Ci % 16 != 0
    ((1, 8, 8, 8, 16), 20, "mma_sync"),       # Co % 8 != 0
])
def test_winograd_instances_match_plain(dev, shape, co, instance):
    """Both instances behind the planner, against the plain version; the
    launch counters show which one ran; a repeat run is bitwise equal."""
    x, w = _conv_inputs(dev, shape, co)
    assert winograd.plan_winograd(*shape, co).instance == instance
    wino = ops.conv3d_winograd
    before = (wino.launches, wino.launches_wgmma)
    got = winograd.conv3d_winograd_kernel(x, w)
    torch.cuda.synchronize()
    assert (wino.launches - before[0], wino.launches_wgmma - before[1]) == (
        1, int(instance == "wgmma"))
    assert torch.equal(got, winograd.conv3d_winograd_kernel(x, w))
    ref = winograd.conv3d_winograd_plain(x, w).float()
    assert ((got.float() - ref).abs().max() / ref.abs().max()).item() <= 2e-2
    old = winograd.conv3d_winograd_kernel_mma_sync(x, w)     # the general instance
    assert ((old.float() - ref).abs().max() / ref.abs().max()).item() <= 2e-2


def test_winograd_kernel_rejects_odd_dims_and_f32(dev):
    """Odd D/H/W raise in both dtypes; f32 (F3b: once refused) now runs on
    the f32 instance; float16 and mixed dtypes still raise TypeError."""
    w = torch.zeros((3, 3, 3, 8, 8), device=dev).bfloat16()
    with pytest.raises(ValueError, match="even"):
        ops.conv3d_winograd(torch.zeros((1, 4, 5, 4, 8), device=dev).bfloat16(), w)
    with pytest.raises(ValueError, match="even"):
        ops.conv3d_winograd(torch.zeros((1, 4, 5, 4, 8), device=dev), w.float())
    before = ops.conv3d_winograd.launches_f32
    y = ops.conv3d_winograd(torch.ones((1, 4, 4, 4, 8), device=dev), w.float())
    assert y.dtype == torch.float32 and not y.any()
    assert ops.conv3d_winograd.launches_f32 == before + 1
    with pytest.raises(TypeError):
        ops.conv3d_winograd(torch.zeros((1, 4, 4, 4, 8), device=dev).half(),
                            w.half())
    with pytest.raises(TypeError):
        ops.conv3d_winograd(torch.zeros((1, 4, 4, 4, 8), device=dev), w)


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



# ---------------------------------------- the device connected components --

CANVAS = (192, 224, 160)   # the flagship's whole canvas


@pytest.mark.parametrize("name", sorted(MASKS))
def test_label_components_kernel_equals_cpu(dev, name):
    """``csrc/connected_components.cu`` gives the CPU form's ids bitwise on
    the masks of ``tests/test_torch_cc.py`` (odd extents, one- and
    two-voxel-thick axes, a snake that needs phase 2 at its cap, empty,
    full); the kernel counts one call on the card and none on the CPU."""
    fg, kw = MASKS[name]
    fg = torch.from_numpy(fg)
    before = cc.label_components.launches
    want = cc.label_components(fg, **kw)
    assert cc.label_components.launches == before
    got = cc.label_components(fg.to(dev), **kw)
    torch.cuda.synchronize()
    assert cc.label_components.launches == before + 1
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), want)


def _max_index_labels(fg: np.ndarray) -> np.ndarray:
    """The converged labelling computed apart from both forms: scipy's
    26-connected labels, each component's largest linear index + 1."""
    from scipy import ndimage

    comp, n = ndimage.label(fg, structure=np.ones((3, 3, 3), bool))
    top = np.zeros(n + 1, np.int64)
    np.maximum.at(top, comp.ravel(), np.arange(1, fg.size + 1))
    top[0] = 0
    return top[comp].astype(np.int32)


@pytest.mark.parametrize("mask", ["random_0.05", "random_0.5", "serpentine"])
def test_label_components_kernel_on_the_canvas(dev, monkeypatch, mask):
    """On the whole canvas the kernel's ids are bitwise the plain form's at
    its default caps, which converges there (phase 2 runs on the serpentine
    and on the random mask at 0.5). The plain form runs on the card: its
    arithmetic is the CPU's (an f32 max-pool of integer ids below 2^24 is
    exact), and on the CPU it takes minutes a mask. scipy's labelling
    confirms both; two runs of the kernel are bitwise equal, whatever order
    its atomics take."""
    if mask == "serpentine":
        fg_np = snake(CANVAS, 0)
    else:
        rng = np.random.default_rng(5)
        fg_np = rng.random(CANVAS, dtype=np.float32) < float(mask.split("_")[1])
    fg = torch.from_numpy(fg_np).to(dev)
    rounds = []
    real = cc._jump_round
    monkeypatch.setattr(cc, "_jump_round", lambda *a: rounds.append(1) or real(*a))
    want = cc._label_plain(fg, 192, 64, 8)
    got = cc.label_components(fg)
    again = cc.label_components(fg)
    torch.cuda.synchronize()
    assert len(rounds) < 64, "the plain form stopped at its cap"
    if mask != "random_0.05":
        assert rounds, "phase 2 did not run"
    assert torch.equal(got, want)
    assert torch.equal(again, got)
    assert np.array_equal(got.cpu().numpy(), _max_index_labels(fg_np))


def test_label_components_kernel_ignores_the_plain_caps(dev, monkeypatch):
    """Where the caller's caps stop the plain form's phase 2 short, the
    routes differ as the module docstring says: the CPU returns the capped
    labelling (one component still split over several ids), the card the
    converged one, which is the CPU form's at its default caps."""
    fg_np, _ = MASKS["snake_needs_jump"]
    fg = torch.from_numpy(fg_np)
    caps = dict(max_pool_iters=8, max_jump_rounds=2, check_every=8)
    rounds = []
    real = cc._jump_round
    monkeypatch.setattr(cc, "_jump_round", lambda *a: rounds.append(1) or real(*a))
    capped = cc.label_components(fg, **caps)
    assert len(rounds) == caps["max_jump_rounds"], "phase 2 did not hit its cap"
    converged = cc.label_components(fg)
    assert torch.unique(converged).numel() == 2       # background and one id
    assert torch.unique(capped).numel() > 2
    got = cc.label_components(fg.to(dev), **caps)
    assert torch.equal(got.cpu(), converged)
    assert np.array_equal(got.cpu().numpy(), _max_index_labels(fg_np))


def test_label_components_kernel_replays_in_a_cuda_graph(dev):
    """Three launches and no host read: the kernel captures in a CUDA graph,
    and a replay on a new mask in the captured buffer labels that mask."""
    rng = np.random.default_rng(6)
    masks = [torch.from_numpy(rng.random((40, 47, 33)) < p).to(dev)
             for p in (0.1, 0.4)]
    fg = masks[0].clone()
    cc.label_components(fg)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cc.label_components(fg)
    for m in masks:
        fg.copy_(m)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, cc.label_components(m))


# --------------------------- the IN+act backward and the up backward in CUDA --

def _norm_bwd_inputs(dev, shape, activation, seed=11):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1).bfloat16()
    g = torch.randn(shape, generator=gen, device=dev).bfloat16()
    gam = torch.rand(shape[-1], generator=gen, device=dev) + 0.5
    bet = torch.randn(shape[-1], generator=gen, device=dev) * 0.2
    _, mean, rstd = norm._plain_stats(x, gam, bet, 1e-5, activation)
    return x, g, gam, bet, mean, rstd


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape", [
    (1, 6, 7, 5, 8),          # C = 8: one vector a voxel (column form)
    (1, 3, 5, 7, 48),         # C = 48 (column form)
    (1, 8, 8, 8, 320),        # C = 320: the fine step's deepest level (column form)
    (1, 1, 4, 1, 64),         # extents of 1 (column form)
    (1, 9, 7, 11, 16),        # odd extents (column form)
    (2, 16, 16, 8, 64),       # N = 2: 66 blocks a sample (grid form)
    (1, 12, 11, 17, 48),      # C = 48: 510 threads, odd extents (grid form)
    (1, 64, 64, 64, 64),      # the fine step's top level: 42% held in shared memory
    (1, 64, 64, 64, 48),      # part held, C/8 = 6 does not divide the thread count
])
def test_norm_bwd_cuda_kernel_matches_blocked_plain(dev, activation, shape):
    args = _norm_bwd_inputs(dev, shape, activation)
    before = (ops.instance_norm_act_bwd.launches,
              ops.instance_norm_act_bwd.launches_cuda)
    got = ops.instance_norm_act_bwd(*args, activation)
    again = ops.instance_norm_act_bwd(*args, activation)
    blocked = norm.instance_norm_act_bwd_blocked_plain(
        *args, activation, sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    ref = norm.instance_norm_act_bwd_plain(*args, activation)
    torch.cuda.synchronize()
    assert (ops.instance_norm_act_bwd.launches - before[0],
            ops.instance_norm_act_bwd.launches_cuda - before[1]) == (2, 2)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    assert got[0].dtype == torch.bfloat16 and got[0].shape == shape
    for want in (blocked, ref):
        assert _rel(got[0], want[0]) <= 1e-2
        torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("shape", [(1, 6, 7, 5, 3), (2, 4, 4, 4, 12)])
def test_norm_bwd_other_channels_go_to_triton_by_plan(dev, shape):
    args = _norm_bwd_inputs(dev, shape, "relu")
    before = (ops.instance_norm_act_bwd.launches,
              ops.instance_norm_act_bwd.launches_cuda)
    dx, dgam, dbet = ops.instance_norm_act_bwd(*args)
    rdx, rdgam, rdbet = norm.instance_norm_act_bwd_plain(*args)
    torch.cuda.synchronize()
    assert (ops.instance_norm_act_bwd.launches - before[0],
            ops.instance_norm_act_bwd.launches_cuda - before[1]) == (1, 0)
    assert _rel(dx, rdx) <= 1e-2
    torch.testing.assert_close(dgam, rdgam, rtol=1e-3, atol=1e-3)


def test_norm_bwd_cuda_kernel_replays_from_a_cuda_graph(dev):
    """The cooperative launch and its grid barrier under graph capture:
    replays equal the eager call (chip_smoke.py times kernels this way)."""
    args = _norm_bwd_inputs(dev, (1, 32, 32, 32, 128), "relu")
    want = ops.instance_norm_act_bwd(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.instance_norm_act_bwd(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ops.instance_norm_act_bwd(*args) for _ in range(3)]
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    for got in outs:
        assert all(torch.equal(u, v) for u, v in zip(got, want))


@pytest.mark.parametrize("x_shape", [
    (1, 4, 4, 4, 8),          # C = 8
    (1, 5, 3, 9, 48),         # C = 48, odd extents
    (1, 3, 4, 2, 320),        # C = 320: five channel chunks
    (1, 1, 1, 1, 16),         # extents of 1: every tap on one voxel
    (1, 1, 7, 1, 64),
    (2, 6, 10, 14, 16),       # N = 2, ragged tiles
    (1, 32, 32, 32, 128),     # the fine step's top up
])
def test_up_bwd_cuda_kernel_matches_plain(dev, x_shape):
    g = torch.randn((x_shape[0],) + tuple(2 * s for s in x_shape[1:4])
                    + x_shape[4:], device=dev).bfloat16()
    before = (ops.upsample2x_bwd.launches, ops.upsample2x_bwd.launches_cuda)
    got = ops.upsample2x_bwd(g)
    again = ops.upsample2x_bwd(g)
    ref = resize.upsample2x_bwd_plain(g)
    torch.cuda.synchronize()
    assert (ops.upsample2x_bwd.launches - before[0],
            ops.upsample2x_bwd.launches_cuda - before[1]) == (2, 2)
    assert got.shape == ref.shape == x_shape and torch.equal(got, again)
    assert _ulps(got, ref) <= 1


@pytest.mark.parametrize("x_shape,cs", [((1, 16, 16, 16, 128), 128),
                                        ((2, 5, 6, 7, 16), 24),
                                        ((1, 4, 4, 4, 320), 64)])
def test_up_bwd_reads_the_strided_concat_gradient(dev, x_shape, cs):
    n, d, h, w, cu = x_shape
    cat = torch.randn((n, 2 * d, 2 * h, 2 * w, cu + cs), device=dev).bfloat16()
    view = cat[..., :cu]
    before = ops.upsample2x_bwd.launches_cuda
    got = ops.upsample2x_bwd(view)
    want = ops.upsample2x_bwd(view.contiguous())
    torch.cuda.synchronize()
    assert ops.upsample2x_bwd.launches_cuda - before == 2
    assert torch.equal(got, want)
    assert _ulps(got, resize.upsample2x_bwd_plain(view)) <= 1
    # through the decoder's concat op: the same gradient as up + torch.cat
    x = torch.randn(x_shape, device=dev).bfloat16().requires_grad_()
    skip = torch.randn((n, 2 * d, 2 * h, 2 * w, cs), device=dev).bfloat16()
    skip.requires_grad_()
    ops.upsample2x_concat(x, skip).backward(cat)
    assert torch.equal(x.grad, got) and torch.equal(skip.grad, cat[..., cu:])


@pytest.mark.parametrize("layout", ["transposed", "misaligned"])
def test_up_bwd_other_layouts_are_copied_for_the_cuda_kernel(dev, layout):
    """C % 8 == 0 always runs on resize2x.cu: a gradient with non-standard
    strides, or one whose data is not 16-byte aligned, is copied first."""
    x_shape = (1, 3, 4, 5, 16)
    n, d, h, w, c = x_shape
    if layout == "transposed":
        g = torch.randn((n, 2 * h, 2 * d, 2 * w, c), device=dev).bfloat16()
        g = g.transpose(1, 2)
    else:
        buf = torch.randn((n, 2 * d, 2 * h, 2 * w, c + 8), device=dev).bfloat16()
        g = buf[..., 1:1 + c]
        assert g.data_ptr() % 16 and resize.channel_pitch(g) == c + 8
    before = (ops.upsample2x_bwd.launches, ops.upsample2x_bwd.launches_cuda)
    got = ops.upsample2x_bwd(g)
    torch.cuda.synchronize()
    assert (ops.upsample2x_bwd.launches - before[0],
            ops.upsample2x_bwd.launches_cuda - before[1]) == (1, 1)
    assert got.shape == x_shape
    assert torch.equal(got, ops.upsample2x_bwd(g.contiguous()))
    assert _ulps(got, resize.upsample2x_bwd_plain(g)) <= 1


@pytest.mark.parametrize("x_shape,pitch", [((1, 4, 4, 4, 3), 3),
                                           ((1, 4, 4, 4, 16), 20)])
def test_up_bwd_other_channels_or_pitch_go_to_triton_by_plan(dev, x_shape, pitch):
    n, d, h, w, c = x_shape
    buf = torch.randn((n, 2 * d, 2 * h, 2 * w, pitch), device=dev).bfloat16()
    g = buf[..., :c]
    before = (ops.upsample2x_bwd.launches, ops.upsample2x_bwd.launches_cuda)
    got = ops.upsample2x_bwd(g)
    torch.cuda.synchronize()
    assert (ops.upsample2x_bwd.launches - before[0],
            ops.upsample2x_bwd.launches_cuda - before[1]) == (1, 0)
    assert _ulps(got, resize.upsample2x_bwd_plain(g)) <= 1


# ------------------------------------------------------------ the f32 routes --
# A configuration whose compute dtype is float32 (the presets unit and smoke,
# the accuracy benchmark's config) runs every kernel seam in f32: the conv on
# the FFMA instance of csrc/conv3d.cu (with its STATS epilogue where an IN
# follows), IN+act on the Triton kernels (merge and apply from the partials,
# or the three-launch form), the 2x up (into the decoder's concat buffer),
# the 2x down and their backwards on resize2x.cu where C % 4 == 0, the Triton
# kernels for other C. Each is held to its plain version (f32 math, TF32 off).

def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("shape,co", [
    ((1, 16, 16, 16, 4), 8),      # the accuracy config's first conv
    ((1, 32, 32, 32, 8), 16),
    ((2, 9, 7, 13, 12), 20),      # ragged tile, Ci and Co off the 16/64 grid
    ((1, 16, 16, 16, 32), 32),
    ((1, 1, 3, 1, 3), 5),         # size-1 axes, scalar everything
    ((1, 8, 8, 8, 80), 136),      # several chunks and Co tiles, both ragged
    ((8, 32, 32, 32, 24), 8),     # the accuracy tile batch's widest conv: 3 slabs
    ((8, 16, 16, 16, 16), 16),    # its 16^3 level: box depth 2
    ((1, 5, 6, 7, 4), 4),         # the 4-wide Co tile (4 channels a thread)
    ((1, 12, 14, 10, 24), 64),    # the 64-wide Co tile
    ((1, 16, 16, 16, 4), 12),     # dgrad Co' 12 (unit's 12 -> 4): a 12-wide tile
    ((1, 32, 32, 32, 8), 24),     # dgrad Co' 24 (the accuracy config's 24 -> 8)
    ((1, 32, 32, 32, 16), 48),    # dgrad Co' 48 (smoke's 48 -> 16)
])
def test_f32_conv_instance_matches_plain(dev, shape, co):
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(shape, generator=g, device=dev)
    w = torch.randn((3, 3, 3, shape[-1], co), generator=g,
                    device=dev) / (27 * shape[-1]) ** 0.5
    assert conv.plan_conv(*shape, co, dtype=torch.float32).instance == "ffma_f32"
    before = (ops.conv3d.launches, ops.conv3d.launches_f32,
              ops.conv3d.launches_wgmma)
    got = ops.conv3d(x, w)
    again = ops.conv3d(x, w)
    ref = conv.conv3d_plain(x, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5
    assert torch.equal(got, again)
    assert (ops.conv3d.launches - before[0], ops.conv3d.launches_f32 - before[1],
            ops.conv3d.launches_wgmma - before[2]) == (2, 2, 0)


def test_f32_conv_halo_counts(dev):
    """All-ones volume and kernel: each output is Ci x the taps inside."""
    n, d, h, wd, ci = 2, 5, 6, 7, 3
    x = torch.ones((n, d, h, wd, ci), device=dev)
    got = ops.conv3d(x, torch.ones((3, 3, 3, ci, 4), device=dev))
    cnt = lambda size: torch.tensor([3 - (i == 0) - (i == size - 1)
                                     for i in range(size)], device=dev).float()
    want = (cnt(d)[:, None, None] * cnt(h)[None, :, None] * cnt(wd)[None, None, :]
            * ci)
    assert torch.equal(got, want[None, ..., None].expand_as(got))


def test_f32_conv_autograd_dgrad_on_the_ffma_instance(dev):
    """dgrad through the FFMA instance, wgrad by the library with TF32 off:
    both within 1e-5 of the CPU's f32 autograd."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, 6, 7, 5, 8), generator=g)
    w = torch.randn((3, 3, 3, 8, 12), generator=g) / 14.7
    gy = torch.randn((1, 6, 7, 5, 12), generator=g)
    grads = {}
    for where in ("cpu", dev):
        xd = x.to(where).detach().requires_grad_()
        wdev = w.to(where).detach().requires_grad_()
        ops.conv3d(xd, wdev).backward(gy.to(where))
        grads[str(where)] = (xd.grad.cpu(), wdev.grad.cpu())
    before = ops.conv3d.launches_f32
    xd = x.to(dev).requires_grad_()
    ops.conv3d(xd, w.to(dev)).backward(gy.to(dev))
    assert ops.conv3d.launches_f32 - before == 2      # forward and dgrad
    for got, ref in zip(grads[str(dev)], grads["cpu"]):
        assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape", [(1, 16, 16, 16, 8), (2, 9, 7, 13, 12),
                                   (1, 32, 32, 32, 16), (1, 5, 6, 7, 3)])
def test_f32_norm_forward_and_backward_match_plain(dev, activation, shape):
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(shape, generator=g, device=dev) * 3 + 1
    gy = torch.randn(shape, generator=g, device=dev)
    gam = torch.rand(shape[-1], generator=g, device=dev) + 0.5
    bet = torch.randn(shape[-1], generator=g, device=dev) * 0.2
    f0 = (ops.instance_norm_act.launches_f32, ops.instance_norm_act_bwd.launches_f32,
          ops.instance_norm_act_bwd.launches_cuda)
    y, mean, rstd = norm.instance_norm_act_kernel(x, gam, bet, activation=activation)
    y2 = norm.instance_norm_act_kernel(x, gam, bet, activation=activation)[0]
    ref = norm.instance_norm_act_plain(x, gam, bet, activation=activation)
    assert y.dtype == torch.float32 and _rel(y, ref) <= 1e-5
    assert torch.equal(y, y2)
    _, rmean, rrstd = norm._plain_stats(x, gam, bet, 1e-5, activation)
    got = norm.instance_norm_act_bwd_kernel(x, gy, gam, bet, rmean, rrstd, activation)
    again = norm.instance_norm_act_bwd_kernel(x, gy, gam, bet, rmean, rrstd,
                                              activation)
    want = norm.instance_norm_act_bwd_plain(x, gy, gam, bet, rmean, rrstd,
                                            activation)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.float32
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the backward on in_act_bwd.cu where its f32 plan says so (C % 4 == 0
    # and not a shape the plan keeps on Triton)
    n, c = shape[0], shape[-1]
    cuda = c % 4 == 0 and norm.plan_in_bwd(
        n, x.numel() // (n * c), c, torch.cuda.get_device_properties(dev).multi_processor_count,
        torch.float32).route == "in_act_bwd.cu"
    assert (ops.instance_norm_act.launches_f32 - f0[0],
            ops.instance_norm_act_bwd.launches_f32 - f0[1],
            ops.instance_norm_act_bwd.launches_cuda - f0[2]) == (2, 2, 2 * cuda)


@pytest.mark.parametrize("op", ["downsample2x", "upsample2x", "downsample2x_bwd",
                                "upsample2x_bwd"])
@pytest.mark.parametrize("shape", [(1, 16, 16, 16, 8), (2, 6, 10, 4, 12),
                                   (1, 8, 8, 8, 3)])
def test_f32_resizes_match_plain(dev, op, shape):
    """shape: the forward's input. Within 1e-6 of the plain version (f32
    sums of a few taps in another order), repeat runs bitwise equal, on the
    route of the plan (every resize on resize2x.cu where C % 4 == 0, Triton
    for the rest), counted as f32 launches."""
    g = torch.Generator(device=dev).manual_seed(9)
    n, d, h, w, c = shape
    if op == "downsample2x_bwd":
        t = torch.randn((n, d // 2, h // 2, w // 2, c), generator=g, device=dev)
        kern = lambda: resize.downsample2x_bwd_kernel(t, shape)
        plain = lambda: resize.downsample2x_bwd_plain(t, shape)
    elif op == "upsample2x_bwd":
        t = torch.randn((n, 2 * d, 2 * h, 2 * w, c), generator=g, device=dev)
        kern = lambda: resize.upsample2x_bwd_kernel(t)
        plain = lambda: resize.upsample2x_bwd_plain(t)
    else:
        t = torch.randn(shape, generator=g, device=dev)
        kern = lambda: getattr(resize, f"{op}_kernel")(t)
        plain = lambda: getattr(resize, f"{op}_plain")(t)
    cuda = c % 4 == 0
    assert resize.plan_resize(op, c, torch.float32) == ("resize2x.cu" if cuda
                                                         else "triton")
    wrapper = getattr(ops, op)
    before = (wrapper.launches, wrapper.launches_f32,
              getattr(wrapper, "launches_cuda", 0))
    got, again, ref = kern(), kern(), plain()
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) <= 1e-6 and torch.equal(got, again)
    assert (wrapper.launches - before[0], wrapper.launches_f32 - before[1],
            getattr(wrapper, "launches_cuda", 0) - before[2]) == (2, 2, 2 * cuda)


def test_f32_up_concat_copies_the_triton_up_into_the_buffer(dev):
    """C % 4 != 0: no whole 16-byte pieces, so the Triton up is made apart
    and copied into the buffer."""
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((1, 4, 5, 6, 6), generator=g, device=dev)
    skip = torch.randn((1, 8, 10, 12, 8), generator=g, device=dev)
    before = (ops.upsample2x.launches_f32, ops.upsample2x.launches_concat)
    got = ops.upsample2x_concat(x, skip)
    assert _rel(got[..., :6], resize.upsample2x_plain(x)) <= 1e-6
    assert torch.equal(got[..., 6:], skip)
    assert (ops.upsample2x.launches_f32 - before[0],
            ops.upsample2x.launches_concat - before[1]) == (1, 0)


# the f32 up on resize2x.cu (upsample2x_ndhwc_f32): 4 channels a piece

@pytest.mark.parametrize("shape,pitch,offset", [
    ((1, 1, 1, 1, 4), 4, 0),       # extent 1, one piece
    ((2, 5, 7, 9, 12), 20, 8),     # odd extents, a partial chunk, at an offset
    ((1, 3, 4, 2, 40), 48, 4),     # two chunks (32 + 8 channels)
    ((8, 16, 16, 16, 16), 24, 0),  # the accuracy tile batch's up, into its concat
    ((1, 8, 8, 8, 8), 12, 0),      # unit's up, pitch 12
    ((1, 8, 8, 8, 32), 48, 16),    # smoke's deepest up, shifted
])
def test_f32_up_into_a_buffer_at_pitch_and_offset(dev, shape, pitch, offset):
    """Within 1e-6 of the plain up, written only into channels [offset,
    offset + C) of the (N, 2D, 2H, 2W, pitch) buffer, repeat bitwise."""
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(shape, generator=g, device=dev)
    n, d, h, w, c = shape
    buf = torch.full((n, 2 * d, 2 * h, 2 * w, pitch), 7.0, device=dev)
    resize._launch_up_cuda(x, buf, offset)
    again = buf.clone()
    resize._launch_up_cuda(x, again, offset)
    ref = resize.upsample2x_plain(x)
    torch.cuda.synchronize()
    assert _rel(buf[..., offset:offset + c], ref) <= 1e-6
    assert torch.equal(buf, again)
    rest = torch.cat([buf[..., :offset], buf[..., offset + c:]], -1)
    assert bool((rest == 7.0).all())


@pytest.mark.parametrize("shape,cs", [((8, 16, 16, 16, 16), 8), ((1, 8, 8, 8, 8), 4),
                                      ((2, 3, 5, 1, 4), 4)])
def test_f32_up_concat_writes_into_the_buffer(dev, shape, cs):
    """The f32 configurations' ups: one resize2x.cu launch into the concat
    buffer, the up half within 1e-6 of the plain up, the skip half bitwise;
    gradients split back."""
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(shape, generator=g, device=dev)
    n, d, h, w, c = shape
    skip = torch.randn((n, 2 * d, 2 * h, 2 * w, cs), generator=g, device=dev)
    before = (ops.upsample2x.launches_f32, ops.upsample2x.launches_cuda,
              ops.upsample2x.launches_concat)
    got = ops.upsample2x_concat(x, skip)
    torch.cuda.synchronize()
    assert (ops.upsample2x.launches_f32 - before[0], ops.upsample2x.launches_cuda
            - before[1], ops.upsample2x.launches_concat - before[2]) == (1, 1, 1)
    assert _rel(got[..., :c], resize.upsample2x_plain(x)) <= 1e-6
    assert torch.equal(got[..., c:], skip)
    xr, sr = x.clone().requires_grad_(), skip.clone().requires_grad_()
    gy = torch.randn(got.shape, generator=g, device=dev)
    ops.upsample2x_concat(xr, sr).backward(gy)
    assert torch.equal(sr.grad, gy[..., c:])
    assert _rel(xr.grad, resize.upsample2x_bwd_plain(gy[..., :c])) <= 1e-6


# the f32 2x down on resize2x.cu (downsample2x_ndhwc_f32): 4 channels a piece

@pytest.mark.parametrize("shape", [
    (8, 32, 32, 32, 8),       # the accuracy tile batch's down
    (1, 64, 64, 64, 8),       # smoke's first down
    (1, 32, 32, 32, 16),      # smoke's second down
    (1, 16, 16, 16, 4),       # unit's down, one piece a voxel
    (2, 9, 7, 13, 12),        # N = 2, odd extents (last planes dropped), 3 pieces
    (1, 2, 2, 2, 4),          # one output voxel
])
def test_f32_down_on_resize2x_matches_plain(dev, shape):
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn(shape, generator=g, device=dev)
    before = (ops.downsample2x.launches_cuda, ops.downsample2x.launches_f32)
    got = resize.downsample2x_kernel(x)
    again = resize.downsample2x_kernel(x)
    ref = resize.downsample2x_plain(x)
    triton = resize.downsample2x_kernel_triton(x)
    torch.cuda.synchronize()
    assert (ops.downsample2x.launches_cuda - before[0],
            ops.downsample2x.launches_f32 - before[1]) == (2, 3)
    assert got.shape == ref.shape and torch.equal(got, again)
    assert _rel(got, ref) <= 1e-6 and _rel(triton, ref) <= 1e-6


@pytest.mark.parametrize("layout", ["transposed", "misaligned"])
def test_f32_down_copies_other_layouts_for_resize2x(dev, layout):
    shape = (1, 6, 8, 10, 8)
    g = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn(shape, generator=g, device=dev)
    if layout == "transposed":
        v = x.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        buf = torch.empty(x.numel() + 1, device=dev)
        v = buf[1:].view(shape)
        v.copy_(x)
        assert v.data_ptr() % 16
    before = ops.downsample2x.launches_cuda
    got = resize.downsample2x_kernel(v)
    torch.cuda.synchronize()
    assert ops.downsample2x.launches_cuda - before == 1
    assert torch.equal(got, resize.downsample2x_kernel(x))


# the f32 2x up backward on resize2x.cu (upsample2x_bwd_ndhwc_f32): 4 channels
# a piece, the instance (8 or 4 pieces a chunk) by plan_up_bwd, read in
# place from the concat gradient at its channel pitch

def _f32_cat(dev, x_shape, pitch, seed):
    n, d, h, w, _ = x_shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, 2 * d, 2 * h, 2 * w, pitch), generator=g, device=dev)


@pytest.mark.parametrize("pieces", resize.UP_BWD_PIECES)
@pytest.mark.parametrize("x_shape,pitch", [
    ((1, 32, 32, 32, 16), 24),    # smoke's top up, at the concat's pitch
    ((1, 16, 16, 16, 32), 48),    # smoke's second up
    ((1, 8, 8, 8, 8), 12),        # unit's up
    ((1, 5, 3, 9, 12), 20),       # odd extents, 3 pieces
    ((1, 1, 7, 1, 4), 4),         # size-1 axes, one piece
    ((2, 3, 6, 40, 40), 44),      # N = 2, two chunks at 8 pieces, ragged w tiles
])
def test_f32_up_bwd_every_instance_matches_plain(dev, x_shape, pitch, pieces):
    """Each instance within 1e-6 of the plain version, repeat bitwise, in
    place bitwise equal to a contiguous copy of the up half."""
    n, d, h, w, c = x_shape
    g = _f32_cat(dev, x_shape, pitch, 17)[..., :c]
    plan = resize.plan_up_bwd(n, d, h, w, c, torch.float32, pieces=pieces)
    lib = resize._lib()
    assert lib.upsample2x_bwd_smem_bytes(pieces) == plan.smem

    def run(t, p):
        dx = torch.empty(x_shape, device=dev)
        resize._launch_up_bwd_cuda(t, dx, p, plan)
        return dx

    got, again, contig = run(g, pitch), run(g, pitch), run(g.contiguous(), c)
    ref = resize.upsample2x_bwd_plain(g)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= 1e-6
    assert torch.equal(got, again) and torch.equal(got, contig)


@pytest.mark.parametrize("x_shape,pitch", [((1, 32, 32, 32, 16), 24),
                                           ((1, 16, 16, 16, 32), 48),
                                           ((1, 8, 8, 8, 8), 12)])
def test_f32_up_bwd_planned_in_place(dev, x_shape, pitch):
    """smoke's and unit's up backwards through the wrapper: in place at the
    concat's pitch, on resize2x.cu in the planned instance, counted as f32
    and CUDA launches; through the decoder's concat op the same gradient."""
    n, d, h, w, c = x_shape
    cat = _f32_cat(dev, x_shape, pitch, 18)
    view = cat[..., :c]
    before = (ops.upsample2x_bwd.launches_f32, ops.upsample2x_bwd.launches_cuda)
    got = ops.upsample2x_bwd(view)
    want = ops.upsample2x_bwd(view.contiguous())
    torch.cuda.synchronize()
    assert (ops.upsample2x_bwd.launches_f32 - before[0],
            ops.upsample2x_bwd.launches_cuda - before[1]) == (2, 2)
    assert torch.equal(got, want)
    assert _rel(got, resize.upsample2x_bwd_plain(view)) <= 1e-6
    x = torch.randn(x_shape, device=dev).requires_grad_()
    skip = torch.randn((n, 2 * d, 2 * h, 2 * w, pitch - c), device=dev)
    skip.requires_grad_()
    ops.upsample2x_concat(x, skip).backward(cat)
    assert torch.equal(x.grad, got) and torch.equal(skip.grad, cat[..., c:])


def test_f32_up_bwd_misaligned_g_is_copied(dev):
    x_shape = (1, 3, 4, 5, 16)
    buf = _f32_cat(dev, x_shape, 24, 19)
    g = buf[..., 1:17]
    assert g.data_ptr() % 16 and resize.channel_pitch(g) == 24
    before = ops.upsample2x_bwd.launches_cuda
    got = ops.upsample2x_bwd(g)
    torch.cuda.synchronize()
    assert ops.upsample2x_bwd.launches_cuda - before == 1
    assert torch.equal(got, ops.upsample2x_bwd(g.contiguous()))
    assert _rel(got, resize.upsample2x_bwd_plain(g)) <= 1e-6


@pytest.mark.parametrize("c,pitch", [(6, 6), (12, 14), (3, 8)])
def test_f32_up_bwd_off_the_pieces_goes_to_triton(dev, c, pitch):
    """C or the pitch not a multiple of 4: the Triton kernel by plan (C 12
    fills three whole f32 pieces; at pitch 14 it does not)."""
    x_shape = (1, 4, 4, 4, c)
    g = _f32_cat(dev, x_shape, pitch, 20)[..., :c]
    assert resize.plan_resize("upsample2x_bwd", c, torch.float32,
                              resize.channel_pitch(g)) == "triton"
    before = (ops.upsample2x_bwd.launches_f32, ops.upsample2x_bwd.launches_cuda)
    got = ops.upsample2x_bwd(g)
    torch.cuda.synchronize()
    assert (ops.upsample2x_bwd.launches_f32 - before[0],
            ops.upsample2x_bwd.launches_cuda - before[1]) == (1, 0)
    assert _rel(got, resize.upsample2x_bwd_plain(g)) <= 1e-6


@pytest.mark.parametrize("op", ["upsample2x_bwd", "downsample2x_bwd"])
def test_resize_backwards_refuse_other_dtypes_on_the_card(dev, op):
    g = torch.randn((1, 4, 4, 4, 8), device=dev).half()
    with pytest.raises(TypeError):
        if op == "upsample2x_bwd":
            ops.upsample2x_bwd(g)
        else:
            ops.downsample2x_bwd(g, (1, 8, 8, 8, 8))


# the f32 2x down backward on resize2x.cu (downsample2x_bwd_ndhwc_f32)

@pytest.mark.parametrize("x_shape", [
    (1, 64, 64, 64, 8),       # smoke's first down
    (1, 32, 32, 32, 16),      # smoke's second down
    (1, 16, 16, 16, 4),       # unit's down
    (8, 32, 32, 32, 8),       # the accuracy tile batch's
    (2, 9, 7, 13, 12),        # odd extents: the last planes get 0
    (1, 2, 3, 2, 4),          # a size-1 g axis, an odd one
])
def test_f32_down_bwd_bitwise_the_plain_version(dev, x_shape):
    n, d, h, w, c = x_shape
    gen = torch.Generator(device=dev).manual_seed(21)
    g = torch.randn((n, d // 2, h // 2, w // 2, c), generator=gen, device=dev)
    before = (ops.downsample2x_bwd.launches_f32, ops.downsample2x_bwd.launches_cuda)
    got = resize.downsample2x_bwd_kernel(g, x_shape)
    again = resize.downsample2x_bwd_kernel(g, x_shape)
    triton = resize.downsample2x_bwd_kernel_triton(g, x_shape)
    torch.cuda.synchronize()
    assert (ops.downsample2x_bwd.launches_f32 - before[0],
            ops.downsample2x_bwd.launches_cuda - before[1]) == (3, 2)
    ref = resize.downsample2x_bwd_plain(g, x_shape)
    assert torch.equal(got, ref) and torch.equal(got, again)
    assert torch.equal(triton, ref)


@pytest.mark.parametrize("layout", ["transposed", "misaligned"])
def test_f32_down_bwd_copies_other_layouts(dev, layout):
    x_shape = (1, 6, 8, 10, 8)
    g = torch.randn((1, 3, 4, 5, 8), device=dev)
    if layout == "transposed":
        v = g.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        buf = torch.empty(g.numel() + 1, device=dev)
        v = buf[1:].view(g.shape)
        v.copy_(g)
        assert v.data_ptr() % 16
    before = ops.downsample2x_bwd.launches_cuda
    got = resize.downsample2x_bwd_kernel(v, x_shape)
    torch.cuda.synchronize()
    assert ops.downsample2x_bwd.launches_cuda - before == 1
    assert torch.equal(got, resize.downsample2x_bwd_plain(g, x_shape))


def test_f32_down_bwd_other_channels_go_to_triton(dev):
    g = torch.randn((1, 2, 2, 2, 6), device=dev)
    before = (ops.downsample2x_bwd.launches_f32, ops.downsample2x_bwd.launches_cuda)
    got = ops.downsample2x_bwd(g, (1, 4, 5, 4, 6))
    torch.cuda.synchronize()
    assert (ops.downsample2x_bwd.launches_f32 - before[0],
            ops.downsample2x_bwd.launches_cuda - before[1]) == (1, 0)
    assert torch.equal(got, resize.downsample2x_bwd_plain(g, (1, 4, 5, 4, 6)))


# the f32 IN+act backward on in_act_bwd.cu (grid, column and cluster forms)

def _f32_bwd_args(dev, shape, activation="relu", seed=16):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * 3 + 1
    gy = torch.randn(shape, generator=g, device=dev)
    gam = torch.rand(shape[-1], generator=g, device=dev) + 0.5
    bet = torch.randn(shape[-1], generator=g, device=dev) * 0.2
    _, mean, rstd = norm._plain_stats(x, gam, bet, 1e-5, activation)
    return x, gy, gam, bet, mean, rstd


def _f32_forms(n, s, c, sms):
    forms = {"grid": norm.grid_plan(n, s, c, sms, torch.float32)}
    if n * s <= 4096:
        forms["column"] = norm.column_plan(n, s, c, torch.float32)
    if n == 1:
        for k, width in ((2, 1), (8, 1), (16, 1), (8, 2), (4, 4)):
            p = norm.cluster_plan(s, c, k, width)
            if (c // 4) % width == 0 and k <= s and p.smem <= norm.SMEM_LIMIT:
                forms[f"cluster {k}x{width}"] = p
    return forms


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape", [
    (1, 64, 64, 64, 8),       # smoke's top level: the grid form, all held
    (1, 32, 32, 32, 16),      # smoke: Triton by plan (every form checked below)
    (1, 16, 16, 16, 32),      # smoke's deepest level: the cluster form
    (1, 16, 16, 16, 4),       # unit: C = 4, one vector a voxel
    (1, 8, 8, 8, 8),          # unit's deepest level: the column form
    (2, 9, 7, 13, 12),        # N = 2, odd extents, C = 12 (column form)
    (2, 16, 16, 16, 12),      # N = 2 above the column form (Triton by plan)
    (1, 9, 7, 11, 12),        # odd extents, three vectors a voxel
    (8, 32, 32, 32, 8),       # N = 8: the grid form, 16 blocks a sample
])
def test_f32_norm_bwd_every_form_matches_plain(dev, activation, shape):
    """The planned route within 1e-5 of the plain and the blocked plain
    version (dx, dgamma, dbeta), repeat bitwise, counted; every form the f32
    kernel takes at the shape (grid, column, clusters of 2-16 blocks over
    groups of 1-4 vectors) within 1e-5 of the plain version and bitwise
    repeatable."""
    args = _f32_bwd_args(dev, shape, activation)
    n, c = shape[0], shape[-1]
    s = args[0].numel() // (n * c)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = norm.plan_in_bwd(n, s, c, sms, torch.float32)
    before = (ops.instance_norm_act_bwd.launches_cuda, ops.instance_norm_act_bwd.launches_f32)
    got = ops.instance_norm_act_bwd(*args, activation)
    again = ops.instance_norm_act_bwd(*args, activation)
    ref = norm.instance_norm_act_bwd_plain(*args, activation)
    blocked = norm.instance_norm_act_bwd_blocked_plain(*args, activation, sms=sms)
    torch.cuda.synchronize()
    cuda = plan.route == "in_act_bwd.cu"
    assert (ops.instance_norm_act_bwd.launches_cuda - before[0],
            ops.instance_norm_act_bwd.launches_f32 - before[1]) == (2 * cuda, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for want in (ref, blocked):
        for a, b in zip(got, want):
            assert _rel(a, b) <= 1e-5
    x3, g3 = args[0].view(n, s, c), args[1].view(n, s, c)
    for label, p in _f32_forms(n, s, c, sms).items():
        one = norm.launch_in_act_bwd(p, x3, g3, *args[4:], *args[2:4], activation)
        two = norm.launch_in_act_bwd(p, x3, g3, *args[4:], *args[2:4], activation)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(one, two)), label
        for a, b in zip(one, ref):
            assert _rel(a.view(b.shape), b) <= 1e-5, label


def test_f32_norm_bwd_cluster_and_grid_forms_replay_from_a_cuda_graph(dev):
    """The cluster launch and the grid form's cooperative launch (counters
    zeroed by a memset node) under graph capture: replays equal the eager
    call."""
    for shape in ((1, 16, 16, 16, 32), (1, 64, 64, 64, 8)):
        args = _f32_bwd_args(dev, shape)
        want = ops.instance_norm_act_bwd(*args)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ops.instance_norm_act_bwd(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [ops.instance_norm_act_bwd(*args) for _ in range(3)]
        for _ in range(2):
            graph.replay()
        torch.cuda.synchronize()
        for got in outs:
            assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_f32_norm_bwd_other_channels_go_to_triton(dev):
    """C % 4 != 0 fills no 16-byte vector: the Triton kernels, by plan."""
    args = _f32_bwd_args(dev, (1, 6, 7, 5, 6))
    before = (ops.instance_norm_act_bwd.launches, ops.instance_norm_act_bwd.launches_cuda)
    got = ops.instance_norm_act_bwd(*args)
    ref = norm.instance_norm_act_bwd_plain(*args)
    torch.cuda.synchronize()
    assert (ops.instance_norm_act_bwd.launches - before[0],
            ops.instance_norm_act_bwd.launches_cuda - before[1]) == (1, 0)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= 1e-5


# the f32 conv's STATS epilogue (conv3d_stats_ndhwc_f32)

@pytest.mark.parametrize("bd", conv.F32_BOX_DEPTHS)
@pytest.mark.parametrize("shape,co", [
    ((2, 9, 7, 13, 12), 16),       # ragged boxes on every face, N = 2
    ((1, 5, 17, 3, 4), 8),         # extents below one box and above two
    ((3, 6, 9, 10, 3), 4),         # scalar loads (Ci % 4), 4 channels a thread
    ((1, 17, 8, 16, 16), 24),      # a 24-wide tile, d ragged at every depth
    ((1, 8, 8, 8, 8), 6),          # Co % 4 != 0: a masked Co tail
])
def test_f32_stats_conv_y_bitwise_and_partials_match_plain(dev, shape, co, bd):
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn(shape, generator=g, device=dev)
    w = torch.randn((3, 3, 3, shape[-1], co), generator=g,
                    device=dev) / (27 * shape[-1]) ** 0.5
    plan = conv.f32_plan(*shape, co, bd=bd)
    before = (ops.conv3d.launches_stats, ops.conv3d.launches_f32)
    y0 = conv.conv3d_kernel_f32(x, w, plan)
    y, part = conv.conv3d_kernel_f32(x, w, plan, stats=True)
    _, part2 = conv.conv3d_kernel_f32(x, w, plan, stats=True)
    torch.cuda.synchronize()
    assert (ops.conv3d.launches_stats - before[0],
            ops.conv3d.launches_f32 - before[1]) == (2, 3)
    assert torch.equal(y, y0) and torch.equal(part, part2)
    ref = conv.conv_stats_plain(y, plan)
    assert part.shape == ref.shape and torch.equal(part[0], ref[0])
    for i in (1, 2):
        assert _rel(part[i], ref[i]) <= 1e-5
    mean, rstd = norm.merge_partials_plain(part)
    _, rmean, rrstd = norm._plain_stats(y, None, None, 1e-5, "none")
    assert _rel(mean, rmean) <= 1e-5 and _rel(rstd, rrstd) <= 1e-5


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape,co", [((8, 32, 32, 32, 4), 8), ((2, 9, 7, 13, 12), 20)])
def test_f32_norm_from_partials_matches_plain(dev, activation, shape, co):
    """ConvNormAct's f32 route on the card: the STATS conv (the plan's), then
    IN+act from its partials (merge and apply) within 1e-5 of the plain
    IN+act, repeat bitwise."""
    g = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn(shape, generator=g, device=dev)
    w = torch.randn((3, 3, 3, shape[-1], co), generator=g,
                    device=dev) / (27 * shape[-1]) ** 0.5
    y, part = ops.conv3d(x, w, stats=True)
    assert part is not None
    gam, bet = _norm_affine(dev, co)
    before = (ops.instance_norm_act.launches_partials,
              ops.instance_norm_act.launches_f32)
    got = ops.instance_norm_act(y, gam, bet, activation=activation, partials=part)
    again = ops.instance_norm_act(y, gam, bet, activation=activation, partials=part)
    ref = norm.instance_norm_act_plain(y, gam, bet, activation=activation)
    torch.cuda.synchronize()
    assert (ops.instance_norm_act.launches_partials - before[0],
            ops.instance_norm_act.launches_f32 - before[1]) == (2, 2)
    assert _rel(got, ref) <= 1e-5 and torch.equal(got, again)


@pytest.mark.parametrize("shape,co", [((8, 32, 32, 32, 8), 8), ((1, 64, 64, 64, 8), 8),
                                      ((2, 9, 7, 13, 12), 20), ((1, 16, 16, 16, 32), 32)])
def test_f32_merge_apply_equals_merge_then_apply(dev, shape, co):
    """The f32 route's one launch (the merge folded into the apply; at
    (1, 64^3) 512 boxes, so each program applies several blocks) against
    the merge and the apply as two launches: y, mean and rstd within 1e-6."""
    from brats2019_tpu_torch.ops import triton_norm

    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(shape, generator=g, device=dev)
    w = torch.randn((3, 3, 3, shape[-1], co), generator=g,
                    device=dev) / (27 * shape[-1]) ** 0.5
    y, part = ops.conv3d(x, w, stats=True)
    gam, bet = _norm_affine(dev, co)
    y3 = y.view(shape[0], -1, co)
    one, two = torch.empty_like(y3), torch.empty_like(y3)
    m1, r1 = triton_norm.merge_apply(y3, one, part, gam, bet, 1e-5, "relu")
    m2, r2 = triton_norm.merge(part, 1e-5)
    triton_norm.apply(y3, two, m2, r2, gam, bet, "relu")
    torch.cuda.synchronize()
    assert _rel(m1, m2) <= 1e-6 and _rel(r1, r2) <= 1e-6
    assert _rel(one, two) <= 1e-6


def test_f32_unit_forward_runs_on_the_f32_routes(dev):
    """F3: a float32 configuration's U-Net on the card (before, the first
    conv raised TypeError): every launch on an f32 route, logits within 1e-4
    of the CPU plain path."""
    from brats2019_tpu_torch.configs.presets import get_preset
    from brats2019_tpu_torch.utils.weights import build_unet, init_params

    cfg = get_preset("smoke").unet
    params = init_params(cfg, 0)
    x = torch.randn((1, 32, 32, 32, 4), generator=torch.Generator().manual_seed(2))
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = build_unet(cfg, params, dev)(x.to(dev)).cpu()
        counts = ops.launch_counts()
        ref = build_unet(cfg, params, "cpu")(x)
    assert counts["conv3d"] == ops.conv3d.launches_f32 > 0
    assert counts["instance_norm_act"] == ops.instance_norm_act.launches_f32 > 0
    assert ops.conv3d.launches_wgmma == 0
    # every IN from its conv's partials, every up into its concat
    assert (counts["instance_norm_act"] == ops.instance_norm_act.launches_partials
            == ops.conv3d.launches_stats)
    assert counts["upsample2x"] == ops.upsample2x.launches_concat > 0
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-4


# ------------------------------------------------- the f32 Winograd instance --
# F3b: a float32 configuration with ``set_backend("winograd")`` runs the FFMA
# instance of csrc/winograd3d.cu (f32 U and V, f32 products), held to the
# plain Winograd (f32 math, TF32 off) within 1e-5 of max|ref| and bitwise
# repeatable.

@pytest.mark.parametrize("shape,co", [
    ((8, 32, 32, 32, 4), 8),      # the accuracy config's first conv (TTA batch)
    ((1, 32, 32, 32, 16), 32),    # smoke's second level
    ((2, 12, 14, 10, 24), 40),    # Ci % 16 != 0, ragged bricks, Co tail
    ((1, 16, 16, 16, 48), 24),    # three chunks
    ((3, 2, 2, 2, 5), 3),         # one tile per sample, scalar channels
    ((1, 8, 8, 8, 80), 136),      # the raw patch a chunk at a time, 5 Co tiles
    ((8, 32, 32, 32, 24), 8),     # the accuracy tile batch's widest conv: 2 chunks
    ((8, 16, 16, 16, 16), 16),    # its 16^3 level
    ((1, 16, 16, 16, 4), 4),      # the 4-wide Co tile (one task a thread)
    ((1, 16, 16, 16, 4), 12),     # dgrad Co' 12 (unit's 12 -> 4)
    ((1, 32, 32, 32, 8), 24),     # dgrad Co' 24 (the accuracy config's 24 -> 8)
    ((1, 32, 32, 32, 16), 48),    # dgrad Co' 48 (smoke's 48 -> 16): 2 tiles of 24
])
def test_winograd_f32_instance_matches_plain(dev, shape, co):
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(shape, generator=g, device=dev)
    w = torch.randn((3, 3, 3, shape[-1], co), generator=g,
                    device=dev) / (27 * shape[-1]) ** 0.5
    assert winograd.plan_winograd(*shape, co, dtype=torch.float32).instance == "ffma_f32"
    wino = ops.conv3d_winograd
    before = (wino.launches, wino.launches_f32, wino.launches_wgmma)
    got = ops.conv3d_winograd(x, w)
    again = ops.conv3d_winograd(x, w)
    ref = winograd.conv3d_winograd_plain(x, w)
    torch.cuda.synchronize()
    assert (wino.launches - before[0], wino.launches_f32 - before[1],
            wino.launches_wgmma - before[2]) == (2, 2, 0)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.equal(got, again)
    assert _rel(got, ref) <= 1e-5
    assert _rel(got, conv.conv3d_plain(x, w)) <= 1e-5


def test_winograd_f32_backend_runs_a_unit_forward(dev, winograd_backend):
    """``set_backend("winograd")`` with an f32 configuration (the F3b input):
    every conv of the forward on the f32 Winograd instance, none on the
    direct conv, logits within 1e-4 of the CPU plain path."""
    from brats2019_tpu_torch.configs.presets import get_preset
    from brats2019_tpu_torch.utils.weights import build_unet, init_params

    cfg = get_preset("unit").unet
    params = init_params(cfg, 0)
    x = torch.randn((1, 16, 16, 16, 4), generator=torch.Generator().manual_seed(4))
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = build_unet(cfg, params, dev)(x.to(dev)).cpu()
        counts = ops.launch_counts()
        f32 = ops.conv3d_winograd.launches_f32
        ref = build_unet(cfg, params, "cpu")(x)
    assert counts["conv3d"] == 0
    assert counts["conv3d_winograd"] == f32 == 4 * cfg.levels - 2
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-4


# ------------------------------------------------ the training left-outs --
# The KD step and a step under remat on the card against the plain path.

def _unit_pair(kw, seed):
    from brats2019_tpu_torch.configs.presets import UNetConfig
    from brats2019_tpu_torch.utils.weights import init_params

    cfg = UNetConfig(**kw)
    return cfg, init_params(cfg, seed)


def test_kd_step_on_the_card_matches_the_plain_path(dev):
    """One KD update (two teachers, f32 routes) on the card against the CPU
    plain path on the same weights and batch: loss and kd_loss within 1e-4
    relative, the updated params within 1e-5 + 1e-4 relative; the teachers
    bitwise unchanged."""
    from brats2019_tpu_torch.configs.presets import TrainConfig
    from brats2019_tpu_torch.train import distill, step as port_step
    from brats2019_tpu_torch.utils.weights import build_unet

    kw = dict(levels=2, base_features=8, max_features=16, compute_dtype="float32")
    cfg, sp = _unit_pair(kw, 0)
    tparams = [_unit_pair(kw, s)[1] for s in (1, 2)]
    tcfg = TrainConfig(patch=(16, 16, 16), steps=4, warmup_steps=0)
    g = torch.Generator().manual_seed(3)
    batch = [(torch.randn((1, 16, 16, 16, 4), generator=g),
              torch.randint(0, 4, (1, 16, 16, 16), generator=g))]
    out = {}
    for where in ("cpu", dev):
        model = build_unet(cfg, sp, where).train().requires_grad_(True)
        teachers = distill.build_teachers(cfg, tparams, where)
        before = [{k: v.clone() for k, v in t.state_dict().items()} for t in teachers]
        opt = port_step.Optimizer(dict(model.named_parameters()), tcfg)
        loss_fn = distill.make_kd_microbatch_loss(
            distill.teacher_replicas(teachers, [where]), tcfg, distill.KDConfig())
        ops.reset_launch_counts()
        aux = port_step.train_update(model, opt, loss_fn,
                                     [(x.to(where), y.to(where)) for x, y in batch])
        out[str(where)] = ({k: float(v) for k, v in aux.items()},
                           {k: p.detach().cpu() for k, p in model.named_parameters()},
                           ops.launch_counts())
        for t, b in zip(teachers, before):
            assert all(torch.equal(v, b[k]) for k, v in t.state_dict().items())
    (a_cpu, p_cpu, _), (a_dev, p_dev, counts) = out["cpu"], out[str(dev)]
    assert counts["conv3d"] == ops.conv3d.launches_f32 > 0
    for k in ("loss", "kd_loss"):
        assert abs(a_dev[k] - a_cpu[k]) <= 1e-4 * abs(a_cpu[k])
    for k in p_cpu:
        torch.testing.assert_close(p_dev[k], p_cpu[k], atol=1e-5, rtol=1e-4)


def test_remat_step_on_the_card_recomputes_its_levels(dev):
    """A bf16 sub-pixel net with deep supervision: one loss + backward at
    remat_levels 0 and 2 on the same weights and batch gives the same loss
    bitwise and gradients within bf16 rounding, and the recomputed levels'
    forward kernels launch twice (the conv with its statistics epilogue, the
    IN+act from its partials)."""
    from brats2019_tpu_torch.configs.presets import TrainConfig, UNetConfig
    from brats2019_tpu_torch.models.unet3d import UNet3D
    from brats2019_tpu_torch.train import step as port_step
    from brats2019_tpu_torch.utils.weights import init_params, state_dict_from_flat

    kw = dict(levels=3, base_features=16, max_features=32, stem_downsample=2,
              deep_supervision=True)
    params = init_params(UNetConfig(**kw), 0)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, 32, 32, 32, 4), generator=g).to(dev)
    y = torch.randint(0, 4, (1, 32, 32, 32), generator=g).to(dev)
    runs = {}
    for remat in (0, 2):
        model = UNet3D(UNetConfig(**kw, remat_levels=remat))
        model.load_state_dict(state_dict_from_flat(params))
        model = model.to(dev).train()
        loss_fn = port_step.make_microbatch_loss(TrainConfig(), 2, lowres=True,
                                                 deep_supervision=True)
        ops.reset_launch_counts()
        loss, _ = loss_fn(model, x, y)
        loss.backward()
        torch.cuda.synchronize()
        runs[remat] = (loss.detach().clone(), ops.launch_counts(),
                       ops.conv3d.launches_stats,
                       {k: p.grad.float().clone() for k, p in model.named_parameters()})
    (l0, c0, s0, g0), (l2, c2, s2, g2) = runs[0], runs[2]
    assert torch.equal(l0, l2)
    # levels 0 and 1: four blocks of two convs and two INs each run again
    assert c2["conv3d"] - c0["conv3d"] == 8 and s2 - s0 == 8
    assert c2["instance_norm_act"] - c0["instance_norm_act"] == 8
    assert c2["instance_norm_act_bwd"] == c0["instance_norm_act_bwd"]
    for k in g0:
        err = ((g2[k] - g0[k]).abs().max() / g0[k].abs().max().clamp_min(1e-30)).item()
        assert err <= 2e-2, k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,parts", [((1, 24, 20, 12, 64), 2),
                                         ((1, 17, 9, 10, 12), 3)])
def test_shard_statistics_merge_to_the_volume_statistics(dev, dtype, shape, parts):
    """``ops.instance_norm_partials`` (the Triton statistics pass alone) of
    the D-slices of a volume, concatenated, merge into the whole volume's
    statistics: IN+act of each slice from them equals the slice of the
    whole volume's plain IN+act (2 bf16 ulp; f32 1e-5), counted on
    ``launches_shard_stats``."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    gam = torch.rand(shape[-1], generator=g, device=dev) + 0.5
    bet = torch.randn(shape[-1], generator=g, device=dev) * 0.1
    slices = x.tensor_split(parts, dim=1)
    before = ops.instance_norm_act.launches_shard_stats
    every = torch.cat([ops.instance_norm_partials(s.contiguous()) for s in slices], 2)
    assert ops.instance_norm_act.launches_shard_stats - before == parts
    ref = norm.instance_norm_act_plain(x, gam, bet, activation="relu")
    got = torch.cat([ops.instance_norm_act(s.contiguous(), gam, bet,
                                           activation="relu", partials=every)
                     for s in slices], 1)
    if dtype == torch.bfloat16:
        assert _ulps(got, ref) <= 2
    else:
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("dims,heads,n,shift", [
    ((16, 16, 16), 3, 2, 3),     # padded to 21^3, shifted: the three regions
    ((16, 16, 16), 3, 2, 0),     # padded, no mask
    ((9, 10, 11), 2, 1, 3),      # ragged: each axis pads differently
    ((4, 4, 4), 4, 2, 3),        # clamped to the axis: a 64-token window, no shift
    ((8, 3, 14), 1, 1, 3),       # one axis clamped, the others shifted
    ((2, 2, 2), 2, 3, 3),        # an 8-token window: one query tile, 24 keys past T
])
def test_window_attention_kernel_matches_plain(dev, dims, heads, n, shift):
    """The kernel (``csrc/window_attention.cu``) against the plain form (f32
    math on the same bf16 qkv), with the table at unit scale so that B moves
    the scores as much as q k^T does: the output within 2% of its largest
    magnitude and its mean error within 0.4% of its mean magnitude (p rounded
    to bf16 for the p v product, the output rounded to bf16), a repeat
    bitwise, one call and one kernel launch a call."""
    from brats2019_tpu_torch.ops.window_attention import (padded, window_and_shift,
                                                          window_attention_plain)

    ws, ss = window_and_shift(dims, 7, shift)
    nw = n * int(np.prod([p // w for p, w in zip(padded(dims, ws), ws)]))
    g = torch.Generator(device=dev).manual_seed(sum(dims))
    qkv = torch.randn(nw, int(np.prod(ws)), 3 * heads * 16, generator=g,
                      device=dev).bfloat16()
    table = torch.randn(13 ** 3, heads, generator=g, device=dev)
    before = (ops.window_attention.launches, ops.window_attention.launches_cuda)
    got = ops.window_attention(qkv, table, dims, ws, ss, 0.25)
    again = ops.window_attention(qkv, table, dims, ws, ss, 0.25)
    assert (ops.window_attention.launches - before[0],
            ops.window_attention.launches_cuda - before[1]) == (2, 2)
    want = window_attention_plain(qkv.float(), table, dims, ws, ss, 0.25)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    err = (got.float() - want).abs()
    assert err.max().item() <= 2e-2 * want.abs().max().item()
    assert err.mean().item() <= 4e-3 * want.abs().mean().item()


def test_window_attention_kernel_refuses_what_it_does_not_take(dev):
    qkv = torch.randn(8, 343, 3 * 2 * 8, device=dev)
    table = torch.randn(13 ** 3, 2, device=dev)
    with pytest.raises(TypeError, match="bf16 only"):
        ops.window_attention(qkv, table, (14, 14, 7), (7, 7, 7), (3, 3, 3), 0.25)
    with pytest.raises(ValueError, match="head dim 8"):
        ops.window_attention(qkv.bfloat16(), table, (14, 14, 7), (7, 7, 7), (3, 3, 3),
                             0.25)
    wide = torch.randn(8, 343, 3 * 2 * 16, device=dev).bfloat16()
    with pytest.raises(ValueError, match="window of 8"):
        ops.window_attention(wide, torch.randn(15 ** 3, 2, device=dev), (14, 14, 7),
                             (7, 7, 7), (3, 3, 3), 0.25)
