"""PyTorch port: the fused routes of the decoder and the norm, in f32 on the
CPU against the JAX package and against the port's unfused ops.

* IN+act statistics from the conv's epilogue: the plain partials
  (``ops.conv.conv_stats_plain``, box by box with the wgmma or the f32 FFMA
  plan's geometry) merged (``ops.norm.merge_partials_plain``) equal ``_plain_stats``; IN+act
  from partials equals IN+act without them; ``ConvNormAct`` and ``UNet3D``
  on that route equal the JAX modules; gradients equal the unfused route's.
* ``upsample2x_concat``: the plain version is ``cat`` bitwise and equals the
  JAX ``concatenate([upsample2x(x), skip])`` (Pallas in interpret mode).
* The crop handoff (``coarse_locate``'s device gather) equals the slice at
  starts clamped to 0 and to the canvas edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.configs.presets import InferenceConfig as JaxInferenceConfig
from brats2019_tpu.models import blocks as jax_blocks
from brats2019_tpu.models import cascade as jcascade
from brats2019_tpu.models import unet3d as jax_unet
from brats2019_tpu.ops import pallas_resize
from brats2019_tpu.train.checkpoint import export_params
from brats2019_tpu_torch import ops
from brats2019_tpu_torch.configs.presets import InferenceConfig, UNetConfig
from brats2019_tpu_torch.models import cascade as tcascade
from brats2019_tpu_torch.models.blocks import ConvNormAct
from brats2019_tpu_torch.ops import conv, norm, resize
from brats2019_tpu_torch.utils.weights import build_unet

TOL = dict(atol=1e-5, rtol=1e-4)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


# ------------------------------------------- statistics from the epilogue --

@pytest.mark.parametrize("bd", [4, 2])
@pytest.mark.parametrize("shape,co", [
    ((2, 9, 7, 13, 16), 24),     # boxes overhang d, h and w
    ((1, 5, 17, 3, 32), 40),     # extents below one box and above two
    ((3, 6, 9, 10, 16), 8),      # N = 3, d overhangs by one plane
])
def test_plain_partials_merge_to_plain_stats(shape, co, bd):
    y = torch.from_numpy(_rand(shape[:4] + (co,), 1, 3.0, 1.0))
    plan = conv.wgmma_plan(*shape, co, bd, 64)
    part = conv.conv_stats_plain(y, plan)
    nbd, nbh, nbw = plan.boxes
    assert part.shape == (3, shape[0], nbd * nbh * nbw, co)
    assert part[0].sum(1).eq(shape[1] * shape[2] * shape[3]).all()
    mean, rstd = norm.merge_partials_plain(part)
    _, rmean, rrstd = norm._plain_stats(y, None, None, 1e-5, "none")
    assert _rel(mean, rmean) <= 1e-6
    assert _rel(rstd, rrstd) <= 1e-5


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
def test_norm_from_partials_equals_norm_without(activation):
    x = torch.from_numpy(_rand((2, 9, 7, 13, 16), 2)).bfloat16()
    w = torch.from_numpy(_rand((3, 3, 3, 16, 24), 3, 0.1)).bfloat16()
    y, part = ops.conv3d(x, w, stats=True)
    assert part is not None and y.dtype == torch.bfloat16
    gam = torch.from_numpy(_rand((24,), 4, 0.5, 1.0))
    bet = torch.from_numpy(_rand((24,), 5, 0.2))
    got = ops.instance_norm_act(y, gam, bet, activation=activation, partials=part)
    want = ops.instance_norm_act(y, gam, bet, activation=activation)
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2 ** -10))) - 7)
    assert ((got.float() - want.float()).abs() / ulp).max().item() <= 1


def test_conv_stats_route_by_backend_and_shape():
    """Partials where the planner gives the conv an instance with a STATS
    epilogue in its dtype (bf16: the wgmma instance; f32: the FFMA instance,
    any Ci), none on the bf16 mma.sync instance (Ci % 16) or the Winograd
    backend."""
    x16 = torch.from_numpy(_rand((1, 4, 6, 8, 16), 6))
    w = torch.from_numpy(_rand((3, 3, 3, 16, 8), 7, 0.1))
    for dt, instance in ((torch.bfloat16, "wgmma"), (torch.float32, "ffma_f32")):
        x, wt = x16.to(dt), w.to(dt)
        y, part = ops.conv3d(x, wt, stats=True)
        assert torch.equal(y, ops.conv3d(x, wt))
        plan = conv.plan_conv(1, 4, 6, 8, 16, 8, dtype=dt)
        assert plan.instance == instance
        assert part.shape == (3, 1, int(np.prod(plan.boxes)), 8)
        assert torch.equal(part, conv.conv_stats_plain(y, plan))
    _, part = ops.conv3d(x16[..., :12].bfloat16(), w[:, :, :, :12].bfloat16(),
                         stats=True)
    assert part is None                            # bf16 Ci % 16: mma.sync
    _, part = ops.conv3d(x16[..., :12], w[:, :, :, :12], stats=True)
    assert part is not None                        # f32: the FFMA instance
    conv.set_backend("winograd")
    try:
        _, part = ops.conv3d(x16, w, stats=True)
    finally:
        conv.set_backend("direct")
    assert part is None                            # Winograd: no epilogue


def _jax_block_params(ci, co, seed):
    jm = jax_blocks.ConvNormAct(co, compute_dtype=jnp.float32)
    p = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4, 4, 4, ci)))
    p = jax.tree_util.tree_map(np.asarray, p)
    p["params"]["in_scale"] = _rand((co,), seed + 1, 0.5, 1.0)
    p["params"]["in_bias"] = _rand((co,), seed + 2, 0.2)
    return jm, p


def _port_block(ci, co, p):
    block = ConvNormAct(ci, co, compute_dtype=torch.float32)
    with torch.no_grad():
        block.Conv_0.kernel.copy_(torch.from_numpy(np.array(
            p["params"]["Conv_0"]["kernel"])))
        block.in_scale.copy_(torch.from_numpy(p["params"]["in_scale"]))
        block.in_bias.copy_(torch.from_numpy(p["params"]["in_bias"]))
    return block


@pytest.mark.parametrize("shape,co,fused", [
    ((2, 9, 7, 13, 16), 24, True),     # the f32 plan's partials
    ((1, 6, 4, 8, 12), 16, False),     # the Winograd backend: the norm's own statistics
    ((1, 6, 5, 7, 12), 16, True),      # Ci % 16: the f32 plan takes any Ci
])
def test_conv_norm_act_matches_jax(shape, co, fused):
    jm, p = _jax_block_params(shape[-1], co, 8)
    x = _rand(shape, 9)
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    block = _port_block(shape[-1], co, p)
    conv.set_backend("direct" if fused else "winograd")
    try:
        with torch.no_grad():
            _, part = block.Conv_0(torch.from_numpy(x), stats=True)
            got = block(torch.from_numpy(x)).numpy()
    finally:
        conv.set_backend("direct")
    assert (part is not None) == fused
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def unet_pair(tmp_path_factory):
    """A 3-level stem-2 U-Net whose every conv takes the wgmma route (widths
    16-48), in JAX and in the port, f32, with the JAX logits of two inputs."""
    kw = dict(levels=3, base_features=16, max_features=32,
              compute_dtype="float32", stem_downsample=2)
    jm = jax_unet.UNet3D(jax_unet.UNetConfig(**kw))
    xs = [_rand((1, 16, 24, 16, 4), 10), _rand((2, 16, 16, 16, 4), 11)]
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(xs[0]))
    path = str(tmp_path_factory.mktemp("fused") / "params.npz")
    export_params(path, params)
    want = [np.asarray(jm.apply(params, jnp.asarray(x), subpixel=False))
            for x in xs]
    return build_unet(UNetConfig(**kw), path), xs, want


@pytest.mark.parametrize("i", [0, 1])
def test_unet_forward_on_the_fused_route_matches_jax(unet_pair, i):
    tm, xs, want = unet_pair
    with torch.no_grad():
        got = tm(torch.from_numpy(xs[i]), subpixel=False).numpy()
    np.testing.assert_allclose(got, want[i], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape,co", [((2, 9, 7, 13, 16), 24),
                                      ((1, 8, 8, 16, 32), 16)])
def test_fused_gradients_equal_the_unfused(shape, co):
    _, p = _jax_block_params(shape[-1], co, 12)
    block = _port_block(shape[-1], co, p).requires_grad_(True)
    x = torch.from_numpy(_rand(shape, 13)).requires_grad_()
    gy = torch.from_numpy(_rand(shape[:4] + (co,), 14))

    def grads(fused):
        for t in (x, *block.parameters()):
            t.grad = None
        if fused:
            out = block(x)
        else:
            out = norm.instance_norm_act(ops.conv3d(x, block.Conv_0.kernel),
                                         block.in_scale, block.in_bias)
        out.backward(gy)
        return [t.grad.clone() for t in (x, block.Conv_0.kernel,
                                         block.in_scale, block.in_bias)]

    for a, b in zip(grads(True), grads(False)):
        assert _rel(a, b) <= 1e-5


# ------------------------------------------------------ up + skip concat --

@pytest.mark.parametrize("shape,cs", [((1, 4, 4, 4, 8), 8), ((2, 5, 6, 7, 16), 24),
                                      ((1, 1, 2, 2, 8), 3)])
def test_upsample2x_concat_plain_is_cat_and_matches_jax(monkeypatch, shape, cs):
    x = _rand(shape, 15)
    n, d, h, w, _ = shape
    skip = _rand((n, 2 * d, 2 * h, 2 * w, cs), 16)
    got = ops.upsample2x_concat(torch.from_numpy(x), torch.from_numpy(skip))
    want_cat = torch.cat([resize.upsample2x_plain(torch.from_numpy(x)),
                          torch.from_numpy(skip)], -1)
    assert torch.equal(got, want_cat)
    monkeypatch.setattr(pallas_resize, "_INTERPRET", True)
    want = jnp.concatenate([pallas_resize.upsample2x_pallas(jnp.asarray(x)),
                            jnp.asarray(skip)], axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_upsample2x_concat_gradients_split_back():
    x = torch.from_numpy(_rand((1, 3, 4, 5, 8), 17)).requires_grad_()
    skip = torch.from_numpy(_rand((1, 6, 8, 10, 4), 18)).requires_grad_()
    gy = torch.from_numpy(_rand((1, 6, 8, 10, 12), 19))
    ops.upsample2x_concat(x, skip).backward(gy)
    assert torch.equal(skip.grad, gy[..., 8:])
    assert torch.equal(x.grad, resize.upsample2x_bwd_plain(gy[..., :8].contiguous()))


@pytest.mark.parametrize("shape", [(1, 1, 1, 1, 8), (2, 5, 6, 7, 16),
                                   (1, 9, 3, 17, 24)])
def test_upsample2x_tiled_plain_matches_plain(shape):
    """The index arithmetic of csrc/resize2x.cu (tiles, clamped halo, the d
    phases completed from two consecutive rows) in plain torch."""
    x = torch.from_numpy(_rand(shape, 20))
    np.testing.assert_allclose(resize.upsample2x_tiled_plain(x).numpy(),
                               resize.upsample2x_plain(x).numpy(),
                               atol=1e-6, rtol=1e-6)


# --------------------------------------------------- the crop handoff (F1) --

CANVAS, COARSE, ROI = (64, 64, 48), (32, 32, 24), (32, 32, 32)


def _cfg(cls):
    return cls(canvas=CANVAS, tile=ROI, roi_shape=ROI, coarse_shape=COARSE,
               cascade=True, tta_flips=True, tta_precision="float32")


@pytest.mark.parametrize("corner,want", [
    ((0, 0, 0), (0, 0, 0)),                                # clamped to 0
    ((31, 31, 23), tuple(c - r for c, r in zip(CANVAS, ROI))),   # to the edge
    ((14, 20, 9), None),                                   # inside
])
def test_coarse_locate_region_equals_the_slice(corner, want):
    """A stand-in coarse net marks a 3^3 tumour at ``corner`` of the coarse
    grid; the port's device gather equals the slice and JAX's dynamic_slice
    at the same start."""
    k = np.zeros(COARSE + (4,), np.float32)
    lo = [min(c, s - 3) for c, s in zip(corner, COARSE)]
    k[lo[0]:lo[0] + 3, lo[1]:lo[1] + 3, lo[2]:lo[2] + 3, 1] = 5.0
    image = _rand(CANVAS + (4,), 21)
    with torch.no_grad():
        region, start = tcascade.coarse_locate(
            lambda t: torch.from_numpy(k)[None], torch.from_numpy(image),
            _cfg(InferenceConfig), CANVAS, ROI)
    region_j, start_j = jcascade.coarse_locate(
        lambda p, t: jnp.asarray(k)[None], None, jnp.asarray(image),
        _cfg(JaxInferenceConfig), CANVAS, ROI)
    sx, sy, sz = (int(v) for v in start)
    np.testing.assert_array_equal(start.numpy(), np.asarray(start_j))
    if want is not None:
        assert (sx, sy, sz) == want
    assert torch.equal(region, torch.from_numpy(
        image[sx:sx + ROI[0], sy:sy + ROI[1], sz:sz + ROI[2]]))
    np.testing.assert_array_equal(region.numpy(), np.asarray(region_j))
