"""PyTorch port: the f32 routes of the kernel seams (fault F3).

A configuration whose compute dtype is float32 (the presets ``unit`` and
``smoke``, the accuracy benchmark's config) once raised TypeError at its
first conv on the card: every kernel wrapper took bf16 alone. The planners
are device-independent functions of dtype and shape, so the CPU can hold
them: given f32 each names its f32 instance or route (the Winograd backend
its FFMA instance, F3b; the 2x up resize2x.cu where C and the concat's pitch
are multiples of 4, the 2x down resize2x.cu and the IN+act backward
in_act_bwd.cu where C is a multiple of 4), given float16 each raises. The kernels themselves are held on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py`` phase 2)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from brats2019_tpu_torch.configs.presets import PRESETS, UNetConfig
from brats2019_tpu_torch.ops import conv, norm, resize, winograd

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


def _f32_presets():
    return sorted(k for k, v in PRESETS.items() if v.unet.compute_dtype == "float32")


def _unet_calls(cfg, spatial):
    """(op, shape) of every kernel call of one forward of ``cfg``: conv
    (N, D, H, W, Ci, Co), the others (N, D, H, W, C)."""
    r = cfg.stem_downsample
    s = tuple(v // r for v in spatial)
    c = cfg.in_channels * r ** 3
    calls = []
    for lvl in range(cfg.levels):
        f = cfg.feats(lvl)
        calls += [("conv", (1, *s, c, f)), ("norm", (1, *s, f)),
                  ("conv", (1, *s, f, f)), ("norm", (1, *s, f))]
        c = f
        if lvl < cfg.levels - 1:
            calls.append(("downsample2x", (1, *s, c)))
            s = tuple(v // 2 for v in s)
    for lvl in reversed(range(cfg.levels - 1)):
        calls.append(("upsample2x", (1, *s, c)))
        s = tuple(v * 2 for v in s)
        f = cfg.feats(lvl)
        calls += [("conv", (1, *s, c + f, f)), ("norm", (1, *s, f)),
                  ("conv", (1, *s, f, f)), ("norm", (1, *s, f))]
        c = f
    return calls


def test_f32_presets_exist():
    assert {"unit", "smoke"} <= set(_f32_presets())


@pytest.mark.parametrize("preset", _f32_presets())
def test_every_kernel_call_of_an_f32_preset_has_an_f32_route(preset):
    """The F3 input (``--preset unit --device cuda``): every call of the
    preset's forward and backward plans in f32, on no bf16 instance."""
    exp = PRESETS[preset]
    dt = exp.unet.dtype
    assert dt == F32
    calls = _unet_calls(exp.unet, exp.train.patch)
    for i, (op, shape) in enumerate(calls):
        n, d, h, w = shape[:4]
        if op == "conv":
            ci, co = shape[4:]
            assert conv.plan_conv(n, d, h, w, ci, co, dtype=dt).instance == "ffma_f32"
            # the dgrad: the same conv with Ci and Co swapped
            assert conv.plan_conv(n, d, h, w, co, ci, dtype=dt).instance == "ffma_f32"
        elif op == "norm":
            # every IN of an f32 preset has whole 16-byte vectors (C % 4 ==
            # 0): in_act_bwd.cu, but at smoke's (1, 32^3, 16), which the
            # plan keeps on the Triton kernels (no form beat them there)
            assert shape[4] % 4 == 0
            want = "triton" if shape == (1, 32, 32, 32, 16) else "in_act_bwd.cu"
            assert norm.plan_in_bwd(n, d * h * w, shape[4], dtype=dt).route == want
        elif op == "upsample2x":
            # written into the concat buffer whose channels the next conv
            # reads; its backward reads the concat gradient's up half there
            pitch = calls[i + 1][1][4]
            assert resize.plan_resize(op, shape[4], dt, pitch) == "resize2x.cu"
            assert resize.plan_resize(op + "_bwd", shape[4], dt, pitch) == "resize2x.cu"
        else:
            assert resize.plan_resize(op, shape[4], dt) == "resize2x.cu"
            assert resize.plan_resize(op + "_bwd", shape[4], dt) == "resize2x.cu"


@pytest.mark.parametrize("shape", [(1, 16, 16, 16, 4, 8), (1, 64, 64, 64, 64, 64),
                                   (8, 64, 64, 64, 128, 64), (2, 9, 7, 13, 12, 20)])
def test_plan_conv_by_dtype(shape):
    """f32 plans the FFMA instance: a box of BD x 8 x 8 voxels, a Co tile
    that covers Co with the least padding (a tail under 4 channels), Ci in
    slabs of a multiple of 4, one block per (box, Co tile), shared memory
    and threads within the instance's limits."""
    f32 = conv.plan_conv(*shape, dtype=F32)
    n, d, h, w, ci, co = shape
    bd = f32.box[0]
    assert f32.instance == "ffma_f32" and f32.box == (bd, 8, 8)
    assert bd in conv.F32_BOX_DEPTHS
    assert f32.bn % 4 == 0 and f32.bn <= conv.F32_MAX_CO_TILE
    assert f32.n_tiles == -(-co // f32.bn) and 0 <= f32.n_tiles * f32.bn - co < 4
    assert f32.chunk % 4 == 0 and f32.chunk <= -(-ci // 4) * 4
    assert f32.boxes == (-(-d // bd), -(-h // 8), -(-w // 8))
    assert f32.grid == f32.blocks == n * -(-d // bd) * -(-h // 8) * -(-w // 8) * f32.n_tiles
    assert f32.smem_bytes == conv.f32_smem_bytes(bd, f32.bn, f32.chunk) <= conv.SMEM_LIMIT
    assert conv.f32_threads(bd, f32.bn) <= conv.F32_MAX_THREADS
    assert conv.plan_conv(*shape).instance == conv.plan_conv(
        *shape, dtype=BF16).instance in ("wgmma", "mma_sync")
    with pytest.raises(TypeError):
        conv.plan_conv(*shape, dtype=F16)


@pytest.mark.parametrize("n,s,c", [(1, 16 ** 3, 8), (2, 315, 12), (1, 64 ** 3, 64),
                                   (1, 1, 320)])
def test_plan_in_bwd_by_dtype(n, s, c):
    """in_act_bwd.cu in both dtypes where C fills whole 16-byte vectors (f32
    C % 4, bf16 C % 8) at these shapes; the Triton kernels take the rest
    before the plan is asked."""
    assert norm.plan_in_bwd(n, s, c, dtype=F32).route == "in_act_bwd.cu"
    if c % 8 == 0:
        assert norm.plan_in_bwd(n, s, c, dtype=BF16).route == "in_act_bwd.cu"
    else:
        with pytest.raises(ValueError):     # bf16 C % 8: Triton before the plan
            norm.plan_in_bwd(n, s, c, dtype=BF16)
    with pytest.raises(TypeError):
        norm.plan_in_bwd(n, s, c, dtype=F16)


@pytest.mark.parametrize("op", resize.RESIZE_OPS)
@pytest.mark.parametrize("c", [3, 8, 64])
def test_plan_resize_by_dtype(op, c):
    """resize2x.cu takes every f32 resize, forward and backward, at C % 4 ==
    0, and the up and its backward in bf16 at C % 8 == 0 (16-byte pieces);
    the rest is Triton (the bf16 down and its backward at any C)."""
    f32 = c % 4 == 0
    assert resize.plan_resize(op, c, F32) == ("resize2x.cu" if f32 else "triton")
    if f32:      # into a concat buffer: the pitch must be a multiple of 4 too
        assert resize.plan_resize(op, c, F32, c + 4) == "resize2x.cu"
        assert resize.plan_resize(op, c, F32, c + 2) == "triton"
    cuda = op.startswith("up") and c % 8 == 0
    assert resize.plan_resize(op, c, BF16) == ("resize2x.cu" if cuda else "triton")
    with pytest.raises(TypeError):
        resize.plan_resize(op, c, F16)


def test_plan_resize_pitch_and_unknown_op():
    assert resize.plan_resize("upsample2x_bwd", 64, BF16, pitch=72) == "resize2x.cu"
    assert resize.plan_resize("upsample2x_bwd", 64, BF16, pitch=68) == "triton"
    with pytest.raises(ValueError):
        resize.plan_resize("upsample3x", 8, BF16)


@pytest.mark.parametrize("preset", _f32_presets())
def test_every_conv_of_an_f32_preset_plans_the_f32_winograd(preset):
    """The F3b input (``--preset unit``, ``set_backend("winograd")``): every
    conv of the preset's forward and dgrad (even extents at its tile) plans
    the f32 Winograd instance."""
    exp = PRESETS[preset]
    for tile in (exp.train.patch, exp.infer.tile):
        for op, shape in _unet_calls(exp.unet, tile):
            if op == "conv":
                n, d, h, w, ci, co = shape
                for a, b in ((ci, co), (co, ci)):
                    plan = winograd.plan_winograd(n, d, h, w, a, b, dtype=F32)
                    assert plan.instance == "ffma_f32"


@pytest.mark.parametrize("shape", [(1, 16, 16, 16, 16, 16), (1, 12, 14, 10, 4, 32)])
def test_plan_winograd_by_dtype(shape):
    """F3b: f32 plans the f32 FFMA instance: the bf16 general instance's
    2 x 4 x 4 brick, a Co tile equal to Co (both Co here are at most 32 and
    multiples of 4), Ci padded to 4 only and taken in chunks of a multiple of
    4, the raw patch all of Ci or a chunk, shared memory within the limit;
    float16 raises TypeError."""
    assert winograd.plan_winograd(*shape).instance in ("wgmma", "mma_sync")
    plan = winograd.plan_winograd(*shape, dtype=F32)
    general = winograd.instance_plan("mma_sync", *shape)
    n, d, h, w, ci, co = shape
    cip = -(-ci // 4) * 4
    assert plan.instance == "ffma_f32"
    assert (plan.brick, plan.bricks) == (general.brick, general.bricks)
    assert plan.bn == co and plan.n_tiles == 1
    assert plan.grid == plan.blocks == n * math.prod(plan.bricks)
    assert plan.chunk % 4 == 0 and plan.chunk <= cip
    assert plan.raw_channels in (cip, plan.chunk)
    assert plan.smem_bytes == winograd.f32_smem_bytes(
        plan.raw_channels, plan.bn, plan.chunk) <= winograd.SMEM_LIMIT
    with pytest.raises(TypeError):
        winograd.plan_winograd(*shape, dtype=F16)


def test_f32_launch_counters_start_at_zero():
    from brats2019_tpu_torch import ops

    ops.reset_launch_counts()
    for fn in (ops.conv3d, ops.instance_norm_act, ops.instance_norm_act_bwd,
               ops.downsample2x, ops.downsample2x_bwd, ops.upsample2x,
               ops.upsample2x_bwd, ops.conv3d_winograd):
        assert fn.launches_f32 == 0


# ------------------------------------------------ the f32 instances' plans --
# The accuracy benchmark's configuration (tests/test_accuracy_benchmark.py:43-56):
# a 2-level, base-8 f32 net at its TTA tile batch (8, 32^3).
_ACC_UNET = UNetConfig(levels=2, base_features=8, compute_dtype="float32")


def _f32_conv_shapes():
    """Every forward and dgrad conv (N, D, H, W, Ci, Co) of ``unit`` and
    ``smoke`` (train patch and predict tile) and of the accuracy config's
    tile batch, once each."""
    runs = [(PRESETS[p].unet, 1, t) for p in ("unit", "smoke")
            for t in (PRESETS[p].train.patch, PRESETS[p].infer.tile)]
    runs.append((_ACC_UNET, 8, (32, 32, 32)))
    shapes = []
    for cfg, batch, tile in runs:
        for op, sh in _unet_calls(cfg, tile):
            if op == "conv":
                shapes += [(batch, *sh[1:]), (batch, *sh[1:4], sh[5], sh[4])]
    return list(dict.fromkeys(shapes))


@pytest.mark.parametrize("shape", _f32_conv_shapes(), ids=str)
def test_f32_instances_pad_co_by_a_tail_and_ci_to_4(shape):
    """At every f32 conv shape (forward and dgrad) neither f32 instance pads
    Co beyond its last tile's tail (< 4 channels; none at Co % 4 == 0) or Ci
    beyond a multiple of 4, and the Winograd's U is padded to just that."""
    n, d, h, w, ci, co = shape
    cip = -(-ci // 4) * 4
    direct = conv.plan_conv(*shape, dtype=F32)
    wino = winograd.plan_winograd(*shape, dtype=F32)
    for plan in (direct, wino):
        pad = plan.n_tiles * plan.bn - co
        assert 0 <= pad < 4 and (pad == 0 or co % 4)
        assert plan.chunk % 4 == 0 and plan.chunk <= cip
    assert direct.smem_bytes <= conv.SMEM_LIMIT
    assert wino.smem_bytes <= winograd.SMEM_LIMIT
    assert wino.raw_channels in (cip, wino.chunk)
    u = winograd.padded_u(torch.zeros((3, 3, 3, ci, co)))
    assert u.shape == (64, cip, wino.n_tiles * wino.bn)


# ------------------------------------- the f32 instances' summation orders --
# Each kernel is modelled on the CPU in its own order of f32 operations: a
# fused multiply-add as the exact product plus the sum in f64, rounded to f32
# once (an FFMA's single rounding, but for rare double roundings), an add as
# an f32 add. The models are held to the plain versions and to the JAX
# package's f32 conv at the accuracy config's first conv, (8, 32^3) 4 -> 8,
# within the card's tolerance (1e-5 of max|ref|).

ACC_FIRST = (8, 32, 32, 32, 4, 8)
AT = ((1, 1, 1, 0), (0, 1, -1, -1))   # A^T of F(2, 3)


def _fma(acc, a, b):
    return (acc.double() + a.double() * b.double()).float()


def direct_order_model(x, w, plan):
    """csrc/conv3d.cu's f32 instance: every output summed over (slab of
    plan.chunk channels, kd, kh, channel, kw) by FMAs."""
    n, d, h, wd, ci = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((n, d, h, wd, w.shape[4]))
    for c0 in range(0, ci, plan.chunk):
        for kd in range(3):
            for kh in range(3):
                for c in range(c0, min(c0 + plan.chunk, ci)):
                    for kw in range(3):
                        acc = _fma(acc, xp[:, kd:kd + d, kh:kh + h, kw:kw + wd, c, None],
                                   w[kd, kh, kw, c])
    return acc


def winograd_order_model(x, w):
    """csrc/winograd3d.cu's f32 instance: V as the plain version makes it, per
    point the sum over Ci channel by channel by FMAs, then per (d-point,
    h-point) A^T along w, ((m0 + m1) + m2, (m1 - m2) - m3), and the sign-adds
    into the 8 output phases, d-points outer."""
    _, d, h, wd, ci = x.shape
    co = w.shape[4]
    td, th, tw = d // 2, h // 2, wd // 2
    u = winograd.transform_weights(w)
    out = []
    for xs in x.split(1):
        xp = F.pad(xs[0], (0, 0, 1, 1, 1, 1, 1, 1))
        v = xp.unfold(0, 4, 2).unfold(1, 4, 2).unfold(2, 4, 2)
        v = winograd._bt_axis(winograd._bt_axis(winograd._bt_axis(v, 4), 5), 6)
        v = v.permute(4, 5, 6, 0, 1, 2, 3).reshape(64, td * th * tw, ci)
        m = torch.zeros((64, td * th * tw, co))
        for c in range(ci):
            m = _fma(m, v[:, :, c, None], u[:, None, c, :])
        m = m.reshape(4, 4, 4, -1, co)
        fold = torch.stack(((m[:, :, 0] + m[:, :, 1]) + m[:, :, 2],
                            (m[:, :, 1] - m[:, :, 2]) - m[:, :, 3]), 2)
        acc = torch.zeros((2, 2, 2, td * th * tw, co))
        for p in range(4):
            for q in range(4):
                for sd in range(2):
                    for sh in range(2):
                        coef = AT[sd][p] * AT[sh][q]
                        if coef > 0:
                            acc[sd, sh] = acc[sd, sh] + fold[p, q]
                        elif coef < 0:
                            acc[sd, sh] = acc[sd, sh] - fold[p, q]
        y = acc.reshape(2, 2, 2, td, th, tw, co).permute(3, 0, 4, 1, 5, 2, 6)
        out.append(y.reshape(d, h, wd, co))
    return torch.stack(out)


@pytest.fixture(scope="module")
def acc_first_conv():
    """The accuracy config's first conv on seeded inputs: x, w (numpy f32),
    the plain version's and the JAX package's f32 conv of them."""
    rng = np.random.default_rng(10)
    n, d, h, wd, ci, co = ACC_FIRST
    x = rng.standard_normal((n, d, h, wd, ci), dtype=np.float32)
    w = (rng.standard_normal((3, 3, 3, ci, co), dtype=np.float32)
         / np.float32((27 * ci) ** 0.5))
    jax_y = np.array(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=lax.Precision.HIGHEST))
    plain = conv.conv3d_plain(torch.from_numpy(x), torch.from_numpy(w))
    return torch.from_numpy(x), torch.from_numpy(w), plain, torch.from_numpy(jax_y)


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("kernel", ["direct", "winograd"])
def test_f32_summation_order_model_within_tolerance(acc_first_conv, kernel):
    x, w, plain, jax_y = acc_first_conv
    if kernel == "direct":
        got = direct_order_model(x, w, conv.plan_conv(*ACC_FIRST, dtype=F32))
    else:
        got = winograd_order_model(x, w)
        assert _rel(got, winograd.conv3d_winograd_plain(x, w)) <= 1e-5
    assert got.dtype == F32 and got.shape == plain.shape
    assert _rel(got, plain) <= 1e-5
    assert _rel(got, jax_y) <= 1e-5
