"""PyTorch port: the Winograd conv's host side, on the CPU.

* ``conv3d_winograd_bricked_plain`` (plain torch organised as
  ``csrc/winograd3d_wgmma.cu``: bricks of 4^3 tiles, zero-filled raw patches,
  32-channel chunks against the zero-padded U, groups of four w-points folded
  in place, masked ragged tiles) against ``conv3d_winograd_plain``, the JAX
  package's ``conv3d_winograd(..., interpret=True)`` and ``F.conv3d`` on the
  same numpy-seeded inputs, f32, rtol/atol 1e-4 (the same products summed in
  another order);
* the planner (``ops.winograd.plan_winograd``) at every conv shape of the
  flagship predict path: instance, brick, shared memory, that the bricks and
  Co tiles cover the output, and the general instance for odd channel counts;
* the kernel wrappers refuse CPU tensors and f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from brats2019_tpu.ops import pallas_winograd as ref_wino
from brats2019_tpu_torch import ops
from brats2019_tpu_torch.configs.presets import get_preset
from brats2019_tpu_torch.ops import winograd

# ((N, D, H, W, Ci), Co): ragged tile counts (6 x 7 x 5 and 3 x 2 x 9 tiles),
# Ci not a multiple of the 32-channel chunk, Co with a tail in its 64-wide tile
BRICKED = [
    ((1, 12, 14, 10, 48), 40),
    ((2, 6, 4, 18, 16), 72),
    ((1, 8, 8, 8, 32), 64),
    ((1, 2, 2, 2, 80), 8),
]


def _inputs(shape, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, shape[-1], co))
         / np.sqrt(27 * shape[-1])).astype(np.float32)
    return x, w


def _conv_shapes(cfg, batch, spatial):
    """(n, d, h, w, ci, co) of every conv one forward of ``cfg`` makes."""
    r = cfg.stem_downsample
    s = tuple(v // r for v in spatial)
    c = cfg.in_channels * r ** 3
    out = []
    for lvl in range(cfg.levels):
        f = cfg.feats(lvl)
        out += [(batch, *s, c, f), (batch, *s, f, f)]
        c = f
        if lvl < cfg.levels - 1:
            s = tuple(v // 2 for v in s)
    for lvl in reversed(range(cfg.levels - 1)):
        s = tuple(v * 2 for v in s)
        f = cfg.feats(lvl)
        out += [(batch, *s, c + f, f), (batch, *s, f, f)]
        c = f
    return out


def _flagship_shapes():
    exp = get_preset("cascade")
    return list(dict.fromkeys(
        _conv_shapes(exp.coarse_unet, 1, exp.infer.coarse_shape)
        + _conv_shapes(exp.unet, 8, exp.infer.roi_shape)))


@pytest.mark.parametrize("shape,co", BRICKED)
def test_bricked_plain_matches_plain(shape, co):
    x, w = _inputs(shape, co)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plan = winograd.plan_winograd(*shape, co)
    assert plan.instance == "wgmma"
    got = winograd.conv3d_winograd_bricked_plain(xt, wt, plan)
    want = winograd.conv3d_winograd_plain(xt, wt)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,co", BRICKED)
def test_bricked_plain_matches_pallas_interpret(shape, co):
    x, w = _inputs(shape, co, seed=1)
    plan = winograd.plan_winograd(*shape, co)
    got = winograd.conv3d_winograd_bricked_plain(
        torch.from_numpy(x), torch.from_numpy(w), plan)
    want = ref_wino.conv3d_winograd(jnp.asarray(x), jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,co", BRICKED)
def test_bricked_plain_matches_direct_conv(shape, co):
    x, w = _inputs(shape, co, seed=2)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plan = winograd.plan_winograd(*shape, co)
    got = winograd.conv3d_winograd_bricked_plain(xt, wt, plan)
    want = F.conv3d(xt.permute(0, 4, 1, 2, 3), wt.permute(4, 3, 0, 1, 2),
                    padding=1).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_bricked_plain_follows_the_wgmma_plan_only():
    x, w = _inputs((1, 4, 4, 4, 4), 8)
    plan = winograd.plan_winograd(1, 4, 4, 4, 4, 8)
    assert plan.instance == "mma_sync"
    with pytest.raises(ValueError, match="wgmma"):
        winograd.conv3d_winograd_bricked_plain(
            torch.from_numpy(x), torch.from_numpy(w), plan)


@pytest.mark.parametrize("shape", _flagship_shapes())
def test_planner_at_flagship_shapes(shape):
    n, d, h, w, ci, co = shape
    plan = winograd.plan_winograd(*shape)
    assert plan.instance == "wgmma" and plan.brick == (4, 4, 4)
    assert plan.bn == 64 and plan.chunk == 32
    assert plan.smem_bytes == winograd.wgmma_smem_bytes() <= winograd.SMEM_LIMIT
    # the bricks cover every tile, the Co tiles every channel, with no brick
    # or tile to spare
    for t, b, nb in zip((d // 2, h // 2, w // 2), plan.brick, plan.bricks):
        assert (nb - 1) * b < t <= nb * b
    assert (plan.n_tiles - 1) * plan.bn < co <= plan.n_tiles * plan.bn
    assert plan.grid == n * np.prod(plan.bricks) * plan.n_tiles
    assert 1 <= plan.blocks == min(plan.grid, winograd.SM_COUNT)
    assert 0 < plan.fill <= 1
    # a device of fewer SMs gets fewer persistent blocks, the same tiling
    small = winograd.plan_winograd(*shape, sms=8)
    assert small.blocks == min(plan.grid, 8) and small.bricks == plan.bricks


def test_planner_fill_of_ragged_levels():
    # the coarse net's levels: (24, 28, 20), (12, 14, 10) and (6, 7, 5) tiles
    fills = [winograd.plan_winograd(1, 2 * a, 2 * b, 2 * c, 48, 48).fill
             for a, b, c in ((24, 28, 20), (12, 14, 10), (6, 7, 5))]
    assert fills[0] == 1.0
    assert fills[1] == pytest.approx(12 * 14 * 10 / (12 * 16 * 12))
    assert fills[2] == pytest.approx(6 * 7 * 5 / 512)


@pytest.mark.parametrize("ci,co", [(4, 32), (48, 4), (40, 20), (24, 48), (16, 20)])
def test_planner_sends_odd_channels_to_the_general_instance(ci, co):
    plan = winograd.plan_winograd(1, 12, 14, 10, ci, co)
    assert plan.instance == "mma_sync" and plan.brick == (2, 4, 4)
    assert plan.blocks == plan.grid == 3 * 2 * 2 * -(-co // 64)
    assert plan.smem_bytes <= winograd.SMEM_LIMIT
    with pytest.raises(ValueError, match="no wgmma instance"):
        winograd.instance_plan("wgmma", 1, 12, 14, 10, ci, co)


def test_unknown_instance_raises():
    with pytest.raises(ValueError, match="unknown"):
        winograd.instance_plan("fft", 1, 8, 8, 8, 16, 16)


def test_shared_memory_arithmetic():
    # U ring 3 x 16 KB, two raw patches of 4 pieces x 1001 x 16 B, V ring
    # 3 x 4 points x 4 pieces x 1088 B, 17 barriers, 1 KB of alignment slack
    assert winograd.wgmma_smem_bytes() == (
        1024 + 3 * 16384 + 2 * 64064 + 3 * 17408 + 8 * 17) == 230664


@pytest.mark.parametrize("fn", [winograd.conv3d_winograd_kernel,
                                winograd.conv3d_winograd_kernel_mma_sync])
def test_kernel_wrappers_refuse_cpu_tensors_and_f32(fn):
    """f32 has a kernel since F3b: the mma.sync instance still refuses f32,
    both wrappers refuse float16 and mixed dtypes, and a CPU tensor of
    either kernel dtype is refused for its device."""
    x = torch.zeros((1, 4, 4, 4, 16))
    w = torch.zeros((3, 3, 3, 16, 16))
    if fn is winograd.conv3d_winograd_kernel_mma_sync:
        with pytest.raises(TypeError, match="bfloat16"):
            fn(x, w)
    else:
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, w)
    with pytest.raises(TypeError, match="bf16 or f32"):
        fn(x.half(), w.half())
    with pytest.raises(TypeError, match="dtype"):
        fn(x, w.bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        fn(x.bfloat16(), w.bfloat16())
    with pytest.raises(ValueError, match="even"):
        fn(torch.zeros((1, 4, 5, 4, 16)).bfloat16(), w.bfloat16())


def test_cpu_call_takes_the_plain_version_and_counts_no_launch():
    x, w = _inputs((1, 4, 4, 4, 16), 16)
    ops.reset_launch_counts()
    ops.conv3d_winograd.launches_wgmma = 7
    ops.reset_launch_counts()
    got = ops.conv3d_winograd(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (1, 4, 4, 4, 16)
    assert ops.conv3d_winograd.launches == 0
    assert ops.conv3d_winograd.launches_wgmma == 0
