"""PyTorch port: the direct conv's host side, on the CPU.

* the planner (``ops.conv.plan_conv``) at every conv shape of the flagship
  predict path, both train stages (forward and dgrad) and the whole-canvas
  evals: which instance, its shared memory, that its boxes and Co tiles cover
  the output exactly once, and the flop per byte filled into shared memory;
* ``conv3d_boxed_plain`` (plain torch organised as ``csrc/conv3d_wgmma.cu``:
  boxes, zero-filled halo patches, channel chunks, tap-shifted views, masked
  tails) against ``conv3d_plain`` in f32, rtol/atol 1e-5 (the same products,
  summed in another order), and against the JAX package's conv (XLA's, and
  ``conv3d_pallas`` in interpret mode where D, H, W % 8 == 0) on the same
  numpy-seeded inputs, tolerance 1e-4;
* ``ops.conv3d`` on CPU tensors takes the plain version and counts no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from brats2019_tpu.ops.pallas_conv import conv3d_pallas
from brats2019_tpu_torch import ops
from brats2019_tpu_torch.configs.presets import get_preset
from brats2019_tpu_torch.ops import conv
from brats2019_tpu_torch.train.loop import stage_config


def _conv_shapes(cfg, batch, spatial, dgrad=False):
    """(n, d, h, w, ci, co) of every conv one forward of ``cfg`` makes (the
    U-Net of ``models/unet3d.py``: two convs per level down and up), and with
    ``dgrad`` also each one's input gradient: the same conv with Ci and Co
    swapped, none for the stem's first conv."""
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
    if dgrad:
        out += [sh[:4] + (sh[5], sh[4]) for sh in out[1:]]
    return out


def _flagship_shapes():
    exp = get_preset("cascade")
    coarse_canvas = stage_config(exp, "coarse")[1].pool_shape
    shapes = (
        _conv_shapes(exp.coarse_unet, 1, exp.infer.coarse_shape)
        + _conv_shapes(exp.unet, 8, exp.infer.roi_shape)
        + _conv_shapes(exp.coarse_unet, 1, exp.train.coarse_patch, dgrad=True)
        + _conv_shapes(exp.unet, 1, exp.train.patch, dgrad=True)
        + _conv_shapes(exp.coarse_unet, 1, coarse_canvas)
        + _conv_shapes(exp.unet, 1, exp.train.pool_shape)
    )
    return sorted(set(shapes))


FLAGSHIP = _flagship_shapes()
FINE_64 = [(8, 64, 64, 64, 32, 64), (8, 64, 64, 64, 64, 64),
           (8, 64, 64, 64, 192, 64)]
MMA_SYNC_FLOP_PER_BYTE = 42.7   # the mma.sync kernel: 12 KB filled per 0.52 MFLOP


def test_flagship_shapes_are_the_expected_set():
    assert len(FLAGSHIP) >= 50
    assert set(FINE_64) <= set(FLAGSHIP)
    assert (1, 12, 14, 10, 192, 192) in FLAGSHIP      # coarse net's deepest level
    assert (1, 64, 64, 64, 64, 192) in FLAGSHIP       # a dgrad: Ci and Co swapped
    assert (1, 80, 112, 80, 192, 64) in FLAGSHIP      # whole-canvas eval


@pytest.mark.parametrize("shape", FLAGSHIP, ids=lambda s: "x".join(map(str, s)))
def test_planner_at_flagship_shape(shape):
    n, d, h, w, ci, co = shape
    plan = conv.plan_conv(*shape)
    assert plan is conv.plan_conv(*shape)            # a pure, cached function
    assert plan.instance == "wgmma"                  # Ci % 16 == 0, Co % 8 == 0
    assert plan.smem_bytes <= conv.SMEM_LIMIT == 232_448
    assert plan.smem_bytes == conv.wgmma_smem_bytes(plan.box[0], plan.bn)
    bd, bh, bw = plan.box
    assert bd in (2, 4) and (bh, bw) == (8, 8) and plan.bn in (64, 128)
    assert plan.chunk == 64 and plan.stages >= 4
    # the boxes cover every voxel exactly once
    cover = np.zeros((d, h, w), np.int32)
    nbd, nbh, nbw = plan.boxes
    for i in range(nbd):
        for j in range(nbh):
            for k in range(nbw):
                cover[i * bd:(i + 1) * bd, j * bh:(j + 1) * bh,
                      k * bw:(k + 1) * bw] += 1
    assert (cover == 1).all()
    assert (nbd - 1) * bd < d and (nbh - 1) * bh < h and (nbw - 1) * bw < w
    # the Co tiles cover Co, the last one not empty
    assert (plan.n_tiles - 1) * plan.bn < co <= plan.n_tiles * plan.bn
    assert plan.grid == n * nbd * nbh * nbw * plan.n_tiles
    # persistent blocks: one per SM, or one per tile where there are fewer
    assert plan.blocks == min(plan.grid, conv.SM_COUNT)
    assert (plan.box[0], plan.bn) in conv.WGMMA_INSTANCES
    # what does not fit the wgmma kernel goes to the mma.sync one
    for bad in ((n, d, h, w, ci + 8, co), (n, d, h, w, ci, co + 4),
                (n, d, h, w, 4, co)):
        assert conv.plan_conv(*bad).instance == "mma_sync"
    assert plan.flop_per_filled_byte > 0


@pytest.mark.parametrize("shape", FINE_64, ids=lambda s: "x".join(map(str, s)))
def test_planner_cuts_the_fill_at_the_fine_64_cubed_levels(shape):
    """Four convs of the fine net run at 8 x 64^3 (64 -> 64 twice): 56% of
    the path's bound. The plan must fill at most half the bytes per flop the
    mma.sync kernel does."""
    plan = conv.plan_conv(*shape)
    assert plan.box == (4, 8, 8)
    assert plan.flop_per_filled_byte >= 2 * MMA_SYNC_FLOP_PER_BYTE
    old = conv.plan_conv(*shape[:4], shape[4] + 8, shape[5])
    assert old.instance == "mma_sync"
    assert old.flop_per_filled_byte < MMA_SYNC_FLOP_PER_BYTE * 1.01


def test_fill_arithmetic_of_the_two_boxes():
    """At Ci 192 -> Co 64: a 256-row box fills 77 KB of patch and 221 KB of
    weight per 56.6 MFLOP chunk (~190 flop/byte), a 128-row box ~104."""
    tall = conv.wgmma_plan(8, 64, 64, 64, 192, 64, 4, 64)
    short = conv.wgmma_plan(8, 64, 64, 64, 192, 64, 2, 64)
    assert tall.flop_per_filled_byte == pytest.approx(190.0, abs=0.5)
    assert short.flop_per_filled_byte == pytest.approx(104.0, abs=0.5)
    assert tall.smem_bytes == 187_744 and short.smem_bytes == 136_544


def test_wgmma_plan_rejects_what_the_kernel_does_not_take():
    for bad in ((1, 8, 8, 8, 24, 16, 4, 64), (1, 8, 8, 8, 16, 12, 4, 64),
                (1, 8, 8, 8, 16, 16, 3, 64), (1, 8, 8, 8, 16, 16, 4, 96),
                (1, 8, 8, 8, 16, 128, 2, 128), (1, 8, 8, 8, 16, 16, 4, 64, 0)):
        with pytest.raises(ValueError):
            conv.wgmma_plan(*bad)
    mma = conv.plan_conv(1, 3, 4, 5, 4, 6)
    assert mma.instance == "mma_sync" and mma.grid == 1
    x, w = torch.zeros((1, 3, 4, 5, 4)), torch.zeros((3, 3, 3, 4, 6))
    with pytest.raises(ValueError):
        conv.conv3d_boxed_plain(x, w, mma)


@pytest.mark.parametrize("sms", [1, 20, 132, 1000])
def test_planner_follows_the_devices_sm_count(sms):
    """The tile waves are counted against the SM count the caller gives: the
    blocks never exceed it nor the tiles, and whatever instance that picks,
    the plan still computes the conv."""
    shape, co = (1, 12, 14, 10, 32), 96
    plan = conv.plan_conv(*shape, co, sms)
    assert plan.blocks == min(plan.grid, sms)
    costs = {}
    for bd, bn, weight in conv._INSTANCE_COST:
        alt = conv.wgmma_plan(*shape, co, bd, bn, sms)
        costs[(bd, bn)] = -(-alt.grid // alt.blocks) * weight
    assert costs[(plan.box[0], plan.bn)] == min(costs.values())
    x = torch.from_numpy(_rand(shape, 10))
    w = torch.from_numpy(_rand((3, 3, 3, shape[-1], co), 11, 0.1))
    torch.testing.assert_close(conv.conv3d_boxed_plain(x, w, plan),
                               conv.conv3d_plain(x, w), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- boxed plain --

def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


RAGGED = [
    # shape, co, (box depth, Co tile) or None for the planner's own
    ((1, 5, 6, 7, 16), 16, None),
    ((2, 9, 3, 13, 32), 24, None),
    ((1, 12, 14, 10, 96), 192, None),     # the coarse net's deepest level
    ((1, 6, 7, 5, 48), 48, None),
    ((1, 3, 3, 3, 16), 8, (4, 64)),       # a box larger than the volume
    ((1, 4, 9, 8, 32), 40, (2, 64)),      # Co = 40: a tail inside the tile
    ((1, 5, 8, 8, 80), 200, (4, 128)),    # 128-wide tiles, Ci tail in a chunk
]


def _plan(shape, co, inst):
    return (conv.plan_conv(*shape, co) if inst is None
            else conv.wgmma_plan(*shape, co, *inst))


@pytest.mark.parametrize("shape,co,inst", RAGGED)
def test_boxed_plain_matches_plain(shape, co, inst):
    x = torch.from_numpy(_rand(shape, 0))
    w = torch.from_numpy(_rand((3, 3, 3, shape[-1], co), 1, 0.1))
    got = conv.conv3d_boxed_plain(x, w, _plan(shape, co, inst))
    want = conv.conv3d_plain(x, w)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _xla_conv(x, w):
    return lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
    )


@pytest.mark.parametrize("shape,co,inst", RAGGED)
def test_boxed_plain_matches_the_jax_conv(shape, co, inst):
    x, w = _rand(shape, 2), _rand((3, 3, 3, shape[-1], co), 3, 0.1)
    got = conv.conv3d_boxed_plain(torch.from_numpy(x), torch.from_numpy(w),
                                  _plan(shape, co, inst))
    np.testing.assert_allclose(got.numpy(), np.asarray(_xla_conv(x, w)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,co,inst", [
    ((1, 8, 8, 8, 16), 16, None), ((2, 8, 16, 8, 16), 24, (4, 64)),
])
def test_boxed_plain_matches_pallas_interpret(shape, co, inst):
    x, w = _rand(shape, 4), _rand((3, 3, 3, shape[-1], co), 5, 0.1)
    want = conv3d_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = conv.conv3d_boxed_plain(torch.from_numpy(x), torch.from_numpy(w),
                                  _plan(shape, co, inst))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_boxed_plain_keeps_bf16_in_bf16_out():
    x = torch.from_numpy(_rand((1, 4, 5, 6, 16), 6)).bfloat16()
    w = torch.from_numpy(_rand((3, 3, 3, 16, 8), 7, 0.1)).bfloat16()
    got = conv.conv3d_boxed_plain(x, w, conv.plan_conv(1, 4, 5, 6, 16, 8))
    want = conv.conv3d_plain(x, w)
    assert got.dtype == torch.bfloat16
    # f32 sums in another order, then one rounding: at most one bf16 step apart
    assert (got.float() - want.float()).abs().max() <= 2.0 ** -7 * want.float().abs().max()


# ------------------------------------------------------------- the CPU seam --

def test_conv3d_on_cpu_takes_the_plain_version_and_counts_nothing():
    x = torch.from_numpy(_rand((1, 5, 6, 7, 16), 8))
    w = torch.from_numpy(_rand((3, 3, 3, 16, 16), 9, 0.1))
    before = (ops.conv3d.launches, ops.conv3d.launches_wgmma)
    got = ops.conv3d(x, w)
    assert (ops.conv3d.launches, ops.conv3d.launches_wgmma) == before
    assert torch.equal(got, conv.conv3d_plain(x, w))


def test_launch_counters_reset_together():
    ops.conv3d.launches, ops.conv3d.launches_wgmma = 7, 5
    ops.reset_launch_counts()
    assert ops.conv3d.launches == 0 and ops.conv3d.launches_wgmma == 0
    assert ops.launch_counts()["conv3d"] == 0


def test_kernel_wrappers_refuse_cpu_tensors_and_f32():
    """The bf16 instances refuse f32 (the planner sends it to the FFMA
    instance), the FFMA instance refuses bf16, and no wrapper takes float16
    or a CPU tensor."""
    x = torch.zeros((1, 4, 4, 4, 16))
    w = torch.zeros((3, 3, 3, 16, 16))
    for fn in (conv.conv3d_kernel_wgmma, conv.conv3d_kernel_mma_sync):
        with pytest.raises(TypeError):
            fn(x, w)                          # f32: a bf16 instance
    with pytest.raises(TypeError):
        conv.conv3d_kernel_f32(x.bfloat16(), w.bfloat16())
    for fn in (conv.conv3d_kernel, conv.conv3d_kernel_wgmma,
               conv.conv3d_kernel_mma_sync, conv.conv3d_kernel_f32):
        with pytest.raises(TypeError):
            fn(x.half(), w.half())            # float16: no kernel takes it
    with pytest.raises(ValueError, match="CUDA"):
        conv.conv3d_kernel(x, w)              # f32, but on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        conv.conv3d_kernel_f32(x, w)
    for fn in (conv.conv3d_kernel, conv.conv3d_kernel_wgmma,
               conv.conv3d_kernel_mma_sync):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x.bfloat16(), w.bfloat16())            # bf16, but on the CPU
