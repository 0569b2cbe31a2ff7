"""PyTorch port: the f32 routes of the kernel seams (fault F3).

A configuration whose compute dtype is float32 (the presets ``unit`` and
``smoke``, the accuracy benchmark's config) once raised TypeError at its
first conv on the card: every kernel wrapper took bf16 alone. The planners
are device-independent functions of dtype and shape, so the CPU can hold
them: given f32 each names its f32 instance or route (the Winograd backend
its FFMA instance, F3b), given float16 each raises. The kernels themselves are held on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py`` phase 2)."""

import pytest
import torch

from brats2019_tpu_torch.configs.presets import PRESETS
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
    for op, shape in _unet_calls(exp.unet, exp.train.patch):
        n, d, h, w = shape[:4]
        if op == "conv":
            ci, co = shape[4:]
            assert conv.plan_conv(n, d, h, w, ci, co, dtype=dt).instance == "ffma_f32"
            # the dgrad: the same conv with Ci and Co swapped
            assert conv.plan_conv(n, d, h, w, co, ci, dtype=dt).instance == "ffma_f32"
        elif op == "norm":
            assert norm.plan_in_bwd(n, d * h * w, shape[4], dtype=dt).route == "triton"
        else:
            for name in (op, op + "_bwd"):
                assert resize.plan_resize(name, shape[4], dt) == "triton"


@pytest.mark.parametrize("shape", [(1, 16, 16, 16, 4, 8), (1, 64, 64, 64, 64, 64),
                                   (8, 64, 64, 64, 128, 64), (2, 9, 7, 13, 12, 20)])
def test_plan_conv_by_dtype(shape):
    f32 = conv.plan_conv(*shape, dtype=F32)
    assert f32.instance == "ffma_f32" and f32.box == (64,) and f32.bn == 64
    n, d, h, w, ci, co = shape
    assert f32.grid == -(-(n * d * h * w) // 64) * -(-co // 64)
    assert conv.plan_conv(*shape).instance == conv.plan_conv(
        *shape, dtype=BF16).instance in ("wgmma", "mma_sync")
    with pytest.raises(TypeError):
        conv.plan_conv(*shape, dtype=F16)


@pytest.mark.parametrize("n,s,c", [(1, 16 ** 3, 8), (2, 315, 12), (1, 64 ** 3, 64),
                                   (1, 1, 320)])
def test_plan_in_bwd_by_dtype(n, s, c):
    assert norm.plan_in_bwd(n, s, c, dtype=F32).route == "triton"
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
    assert resize.plan_resize(op, c, F32) == "triton"
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
    """F3b: f32 plans the f32 FFMA instance (16-channel chunks, the bf16
    general instance's 2 x 4 x 4 brick); float16 raises TypeError."""
    assert winograd.plan_winograd(*shape).instance in ("wgmma", "mma_sync")
    plan = winograd.plan_winograd(*shape, dtype=F32)
    general = winograd.instance_plan("mma_sync", *shape)
    assert plan.instance == "ffma_f32" and plan.chunk == 16
    assert (plan.brick, plan.bricks, plan.grid) == (general.brick, general.bricks,
                                                    general.grid)
    assert plan.smem_bytes == (600 * 17 + 16 * 32 * 16) * 4
    with pytest.raises(TypeError):
        winograd.plan_winograd(*shape, dtype=F16)


def test_f32_launch_counters_start_at_zero():
    from brats2019_tpu_torch import ops

    ops.reset_launch_counts()
    for fn in (ops.conv3d, ops.instance_norm_act, ops.instance_norm_act_bwd,
               ops.downsample2x, ops.downsample2x_bwd, ops.upsample2x,
               ops.upsample2x_bwd, ops.conv3d_winograd):
        assert fn.launches_f32 == 0
