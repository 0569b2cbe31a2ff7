"""PyTorch port: the fused f32 routes, on the CPU against the JAX package.

An f32 configuration (the presets ``unit`` and ``smoke``, the accuracy
benchmark's config) takes the InstanceNorm statistics from the f32 conv's
STATS epilogue (``csrc/conv3d.cu`` ``conv3d_stats_ndhwc_f32``) and writes
the decoder's 2x up straight into the concat buffer (``csrc/resize2x.cu``
``upsample2x_ndhwc_f32``). On the CPU the same routes run their plain
versions: the f32 plan's partials (``ops.conv.conv_stats_plain``), merged
(``ops.norm.merge_partials_plain``), and ``cat([up, skip])``.

* The f32 plan's partials merge to the plain statistics at ragged shapes and
  at every box depth; a plain-torch model of the epilogue's fixed reduction
  order (thread, warp butterfly, warps in turn; two passes) gives the same
  partials.
* ``ConvNormAct`` and ``UNet3D`` in f32 on that route match the JAX modules.
* The f32 up's plan at the f32 configurations' concat pitches, and
  ``upsample2x_concat`` in f32 against ``cat`` and the JAX package's Pallas
  up (interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from brats2019_tpu.models import blocks as jax_blocks
from brats2019_tpu.models import unet3d as jax_unet
from brats2019_tpu.ops import pallas_resize
from brats2019_tpu.train.checkpoint import export_params
from brats2019_tpu_torch import ops
from brats2019_tpu_torch.configs.presets import PRESETS, UNetConfig
from brats2019_tpu_torch.models import blocks as tblocks
from brats2019_tpu_torch.models import unet3d as tunet
from brats2019_tpu_torch.models.blocks import ConvNormAct
from brats2019_tpu_torch.ops import conv, norm, resize
from brats2019_tpu_torch.utils.weights import build_unet

F32 = torch.float32


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


# ------------------------------------------ statistics from the f32 epilogue --

# (N, D, H, W, Ci), Co: Co tiles every box depth takes (at most 512 threads)
RAGGED = [
    ((2, 9, 7, 13, 12), 16),     # boxes overhang d, h and w
    ((1, 5, 17, 3, 4), 8),       # extents below one box and above two
    ((3, 6, 9, 10, 8), 4),       # N = 3, d overhangs; 4 channels a thread
    ((1, 17, 8, 16, 16), 24),    # whole boxes in h and w, d ragged at every depth
]


@pytest.mark.parametrize("bd", conv.F32_BOX_DEPTHS)
@pytest.mark.parametrize("shape,co", RAGGED)
def test_f32_plan_partials_merge_to_plain_stats(shape, co, bd):
    y = torch.from_numpy(_rand(shape[:4] + (co,), 1, 3.0, 1.0))
    plan = conv.f32_plan(*shape, co, bd=bd)
    assert plan.instance == "ffma_f32" and plan.box == (bd, 8, 8)
    part = conv.conv_stats_plain(y, plan)
    nbd, nbh, nbw = plan.boxes
    assert part.shape == (3, shape[0], nbd * nbh * nbw, co)
    assert part[0].sum(1).eq(shape[1] * shape[2] * shape[3]).all()
    mean, rstd = norm.merge_partials_plain(part)
    _, rmean, rrstd = norm._plain_stats(y, None, None, 1e-5, "none")
    assert _rel(mean, rmean) <= 1e-6
    assert _rel(rstd, rrstd) <= 1e-6


def _fma(acc, a, b):
    """f32 fused multiply-add: the exact product plus acc in f64, rounded to
    f32 once."""
    return (acc.double() + a.double() * b.double()).float()


def epilogue_order_model(y, plan):
    """csrc/conv3d.cu's f32 STATS epilogue in plain torch, in its order of
    f32 operations: per box a thread (d, h, 4 w voxels) folds its 4 voxels in
    turn (those outside the volume as 0), the warp's 32 lanes (lane = h + 8
    * w-quad + 16 * (d % 2)) by an xor butterfly 16, 8, 4, 2, 1, then the
    BD / 2 warps (d // 2) in turn; the mean is the sum over the box's count;
    the second pass folds (v - mean)^2 by FMAs in the same order. Returns
    (3, N, boxes, C)."""
    n, d, h, w, c = y.shape
    bd = plan.box[0]
    nbd, nbh, nbw = plan.boxes
    pad = (0, 0, 0, nbw * 8 - w, 0, nbh * 8 - h, 0, nbd * bd - d)

    def boxed(t):  # (n, D, H, W, c) -> (n, boxes, bd, 8 h, 2 w-quads, 4, c)
        t = F.pad(t, pad)
        t = t.reshape(t.shape[0], nbd, bd, nbh, 8, nbw, 2, 4, t.shape[-1])
        t = t.permute(0, 1, 3, 5, 2, 4, 6, 7, 8)
        return t.reshape(t.shape[0], nbd * nbh * nbw, bd, 8, 2, 4, t.shape[-1])

    vals = boxed(y.float())
    inside = (boxed(torch.ones((1, d, h, w, 1))) > 0).expand_as(vals)
    cnt = inside[:1, :, :, :, :, :, :1].float().sum((2, 3, 4, 5))   # (1, boxes, 1)

    def tree(s):
        """(n, boxes, bd, 8 h, 2 w-quads, c) per-thread values -> the box's
        (n, boxes, c), as the lanes and warps reduce them."""
        s = s.reshape(s.shape[0], s.shape[1], bd // 2, 2, 8, 2, c)
        s = s[:, :, :, 0] + s[:, :, :, 1]                # xor 16: d % 2
        s = s[:, :, :, :, 0] + s[:, :, :, :, 1]          # xor 8: the w-quad
        for half in (4, 2, 1):                           # xor 4, 2, 1: h
            s = s[:, :, :, :half] + s[:, :, :, half:2 * half]
        s = s[:, :, :, 0]                                # (n, boxes, bd / 2, c)
        tot = s[:, :, 0]
        for k in range(1, bd // 2):                      # the warps in turn
            tot = tot + s[:, :, k]
        return tot

    zeros = torch.zeros(vals.shape[:5] + vals.shape[6:])
    t = zeros
    for v in range(4):                                   # pass 1: the sum
        t = t + torch.where(inside[..., v, :], vals[..., v, :], 0.0)
    mean = tree(t) / cnt
    dev = vals - mean[:, :, None, None, None, None]
    t = zeros
    for v in range(4):                                   # pass 2: fma(dv, dv, t)
        dv = dev[..., v, :]
        t = torch.where(inside[..., v, :], _fma(t, dv, dv), t)
    return torch.stack([cnt.expand_as(mean), mean, tree(t)])


@pytest.mark.parametrize("bd", conv.F32_BOX_DEPTHS)
@pytest.mark.parametrize("shape,co", RAGGED[:3])
def test_f32_epilogue_order_model_matches_conv_stats_plain(shape, co, bd):
    y = torch.from_numpy(_rand(shape[:4] + (co,), 2, 3.0, 1.0))
    plan = conv.f32_plan(*shape, co, bd=bd)
    got = epilogue_order_model(y, plan)
    want = conv.conv_stats_plain(y, plan)
    assert torch.equal(got[0], want[0])                  # counts are exact
    for i in (1, 2):
        assert _rel(got[i], want[i]) <= 1e-6
    mean, rstd = norm.merge_partials_plain(got)
    _, rmean, rrstd = norm._plain_stats(y, None, None, 1e-5, "none")
    assert _rel(mean, rmean) <= 1e-6 and _rel(rstd, rrstd) <= 1e-6


def test_f32_conv_gives_the_f32_plans_partials_on_the_cpu():
    """An f32 conv on the CPU plans in f32, as the card does: its partials
    are the f32 plan's boxes, whatever Ci (the f32 instance takes any)."""
    x = torch.from_numpy(_rand((2, 9, 7, 13, 12), 3))
    w = torch.from_numpy(_rand((3, 3, 3, 12, 20), 4, 0.1))
    y, part = ops.conv3d(x, w, stats=True)
    plan = conv.plan_conv(2, 9, 7, 13, 12, 20, dtype=F32)
    assert plan.instance == "ffma_f32"
    assert torch.equal(y, ops.conv3d(x, w))
    assert torch.equal(part, conv.conv_stats_plain(y, plan))


# ----------------------------------------------------- f32 ConvNormAct, UNet --

def _jax_block_params(ci, co, seed):
    jm = jax_blocks.ConvNormAct(co, compute_dtype=jnp.float32)
    p = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 4, 4, ci)))
    p = jax.tree_util.tree_map(np.asarray, p)
    p["params"]["in_scale"] = _rand((co,), seed + 1, 0.5, 1.0)
    p["params"]["in_bias"] = _rand((co,), seed + 2, 0.2)
    return jm, p


@pytest.mark.parametrize("shape,co", [
    ((8, 16, 16, 16, 4), 8),     # the accuracy config's first conv, at 16^3
    ((2, 9, 7, 13, 12), 20),     # ragged boxes, Co tile 20
    ((1, 6, 5, 7, 3), 4),        # Ci % 4 != 0
])
def test_f32_conv_norm_act_on_the_partials_route_matches_jax(shape, co):
    jm, p = _jax_block_params(shape[-1], co, 8)
    x = _rand(shape, 9)
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    block = ConvNormAct(shape[-1], co, compute_dtype=F32)
    with torch.no_grad():
        block.Conv_0.kernel.copy_(torch.from_numpy(np.array(
            p["params"]["Conv_0"]["kernel"])))
        block.in_scale.copy_(torch.from_numpy(p["params"]["in_scale"]))
        block.in_bias.copy_(torch.from_numpy(p["params"]["in_bias"]))
        _, part = block.Conv_0(torch.from_numpy(x), stats=True)
        got = block(torch.from_numpy(x)).numpy()
    assert part is not None and part.dtype == F32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kw,shape", [
    (dict(levels=2, base_features=8), (2, 16, 16, 16, 4)),   # the accuracy config
    (dict(levels=2, base_features=4), (1, 16, 24, 8, 4)),    # unit's widths
])
def test_f32_unet_forward_on_the_fused_routes_matches_jax(tmp_path, monkeypatch,
                                                          kw, shape):
    """Every IN+act of the f32 U-Net takes the conv's partials (on the CPU,
    the f32 plan's) and every up goes into its concat, and the logits match
    the JAX package's at the parity bar (tests/test_golden_parity.py:122)."""
    kw = dict(kw, compute_dtype="float32")
    jm = jax_unet.UNet3D(jax_unet.UNetConfig(**kw))
    params = jm.init(jax.random.PRNGKey(4), jnp.zeros(shape))
    path = str(tmp_path / "params.npz")
    export_params(path, params)
    tm = build_unet(UNetConfig(**kw), path)
    x = _rand(shape, 5)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    took = []
    real_norm, real_cat = tblocks.instance_norm_act, tunet.upsample2x_concat

    def norm_seen(y, *args, partials=None, **kwargs):
        took.append(partials is not None)
        return real_norm(y, *args, partials=partials, **kwargs)

    def cat_seen(x, skip):
        took.append("up")
        return real_cat(x, skip)

    monkeypatch.setattr(tblocks, "instance_norm_act", norm_seen)
    monkeypatch.setattr(tunet, "upsample2x_concat", cat_seen)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    levels = kw["levels"]
    assert took.count(True) == 2 * (2 * levels - 1) and False not in took
    assert took.count("up") == levels - 1
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


# ------------------------------------------------------------ the f32 up --

def _f32_up_concats():
    """(up input channels, concat pitch) of every decoder up of the f32
    configurations: the f32 presets and the accuracy config (2 levels, base
    8)."""
    cfgs = [PRESETS[k].unet for k in sorted(PRESETS)
            if PRESETS[k].unet.compute_dtype == "float32"]
    cfgs.append(UNetConfig(levels=2, base_features=8, compute_dtype="float32"))
    return sorted({(cfg.feats(lvl + 1), cfg.feats(lvl + 1) + cfg.feats(lvl))
                   for cfg in cfgs for lvl in range(cfg.levels - 1)})


def test_every_f32_up_of_the_configurations_plans_resize2x():
    """unit: C 8 into pitch 12; smoke: 32 into 48 and 16 into 24; the
    accuracy config: 16 into 24. Each writes its concat on resize2x.cu, and
    its backward reads the concat gradient there in place."""
    ups = _f32_up_concats()
    assert {(8, 12), (32, 48), (16, 24)} <= set(ups)
    for c, pitch in ups:
        assert resize.plan_resize("upsample2x", c, F32, pitch) == "resize2x.cu"
        assert resize.plan_resize("upsample2x_bwd", c, F32, pitch) == "resize2x.cu"


@pytest.mark.parametrize("c,pitch,route", [
    (8, 12, "resize2x.cu"), (16, 24, "resize2x.cu"), (4, 4, "resize2x.cu"),
    (6, 12, "triton"),          # C % 4 != 0
    (8, 10, "triton"),          # the pitch % 4 != 0
    (3, None, "triton"),
])
def test_plan_resize_f32_up_by_piece(c, pitch, route):
    """f32 pieces are 4 channels: C and the pitch multiples of 4 go to
    resize2x.cu; bf16 keeps its 8 (C 4 or 12 there go to Triton)."""
    assert resize.plan_resize("upsample2x", c, F32, pitch) == route
    bf16 = "resize2x.cu" if c % 8 == 0 and (pitch or c) % 8 == 0 else "triton"
    assert resize.plan_resize("upsample2x", c, torch.bfloat16, pitch) == bf16


@pytest.mark.parametrize("shape,cs", [
    ((1, 8, 8, 8, 8), 4),        # unit's up: 8 into pitch 12
    ((1, 8, 8, 8, 32), 16),      # smoke's deepest up: 32 into 48
    ((8, 16, 16, 16, 16), 8),    # the accuracy tile batch's up: 16 into 24
    ((2, 3, 5, 1, 4), 4),        # odd and size-1 extents
])
def test_f32_up_concat_on_the_cpu_is_cat_and_matches_jax(monkeypatch, shape, cs):
    x = _rand(shape, 15)
    n, d, h, w, _ = shape
    skip = _rand((n, 2 * d, 2 * h, 2 * w, cs), 16)
    got = ops.upsample2x_concat(torch.from_numpy(x), torch.from_numpy(skip))
    assert got.dtype == F32
    assert torch.equal(got, torch.cat([resize.upsample2x_plain(torch.from_numpy(x)),
                                       torch.from_numpy(skip)], -1))
    monkeypatch.setattr(pallas_resize, "_INTERPRET", True)
    want = jnp.concatenate([pallas_resize.upsample2x_pallas(jnp.asarray(x)),
                            jnp.asarray(skip)], axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
