"""PyTorch port: the backward of each kernel seam, in f32 on the CPU.

Each VJP is held against the JAX package through ``jax.vjp``, in two ways:
the Pallas kernel run as the JAX tests run it (interpret mode) and JAX
autodiff of the default jnp/XLA path. Each ``autograd.Function`` is also
held against torch autograd of its own plain forward. Tolerance 1e-5 abs +
1e-4 rel, as tests/test_torch_ops.py: the same math summed in another order.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental.pallas import tpu as pltpu

from brats2019_tpu.ops import pallas_resize
from brats2019_tpu.ops import resize as jax_resize
from brats2019_tpu.ops.norm import instance_norm_act_jnp
from brats2019_tpu.ops.pallas_norm import instance_norm_act_pallas
from brats2019_tpu_torch import ops
from brats2019_tpu_torch.ops import conv, norm, resize

TOL = dict(atol=1e-5, rtol=1e-4)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _leaf(a):
    return torch.from_numpy(a).requires_grad_(True)


# ------------------------------------------------------------------- norm --

NORM_SHAPE = (2, 16, 16, 8, 8)   # S = 2048 tiles the Pallas block


def _norm_case(shape, seed):
    return (_rand(shape, seed, 3.0, 1.0), _rand(shape[-1:], seed + 1, 0.5, 1.0),
            _rand(shape[-1:], seed + 2, 0.2), _rand(shape, seed + 3))


def _port_norm_vjp(x, g, b, ct, activation):
    xt, gt, bt = _leaf(x), _leaf(g), _leaf(b)
    y = ops.instance_norm_act(xt, gt, bt, activation=activation)
    y.backward(torch.from_numpy(ct))
    return y, xt.grad, gt.grad, bt.grad


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
def test_norm_backward_matches_pallas_interpret(activation):
    x, g, b, ct = _norm_case(NORM_SHAPE, 0)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda *a: instance_norm_act_pallas(*a, activation=activation),
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
        want = vjp(jnp.asarray(ct))
    _, *got = _port_norm_vjp(x, g, b, ct, activation)
    for a, w in zip(got, want):
        _close(a, w)


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("shape", [NORM_SHAPE, (1, 6, 7, 5, 3), (1, 1, 1, 2, 4)])
def test_norm_backward_matches_jax_autodiff(activation, shape):
    x, g, b, ct = _norm_case(shape, 4)
    _, vjp = jax.vjp(
        lambda *a: instance_norm_act_jnp(*a, activation=activation),
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(ct))
    _, *got = _port_norm_vjp(x, g, b, ct, activation)
    for a, w in zip(got, want):
        _close(a, w)


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
def test_norm_function_matches_autograd_of_plain(activation):
    x, g, b, ct = _norm_case((2, 5, 6, 4, 12), 8)
    y, *got = _port_norm_vjp(x, g, b, ct, activation)
    xt, gt, bt = _leaf(x), _leaf(g), _leaf(b)
    ref = norm.instance_norm_act_plain(xt, gt, bt, activation=activation)
    ref.backward(torch.from_numpy(ct))
    _close(y, ref.detach())
    for a, w in zip(got, (xt.grad, gt.grad, bt.grad)):
        _close(a, w.numpy())


def test_norm_without_affine_backward_and_stats():
    """scale/bias None: only dx; the forward's saved stats are the f32
    per-(n, c) mean and rstd the backward reads."""
    x, _, _, ct = _norm_case((2, 4, 4, 4, 8), 12)
    xt = _leaf(x)
    ops.instance_norm_act(xt, None, None).backward(torch.from_numpy(ct))
    _, vjp = jax.vjp(lambda a: instance_norm_act_jnp(a, None, None),
                     jnp.asarray(x))
    _close(xt.grad, vjp(jnp.asarray(ct))[0])
    y, mean, rstd = norm._plain_stats(torch.from_numpy(x), None, None, 1e-5, "relu")
    assert mean.shape == rstd.shape == (2, 8) and mean.dtype == torch.float32
    _close(mean, x.mean(axis=(1, 2, 3)))
    _close(rstd, 1 / np.sqrt(x.var(axis=(1, 2, 3)) + 1e-5))


def test_norm_leaky_grad_at_zero_follows_the_pallas_rule():
    """act' is taken with y_pre > 0: leaky gives 0.01 where y_pre == 0."""
    x = torch.tensor([-1.0, 1.0]).reshape(1, 1, 1, 2, 1)
    g = torch.ones_like(x)
    gamma, beta = torch.ones(1), torch.zeros(1)
    mean, rstd = torch.zeros(1, 1), torch.ones(1, 1)
    x0 = torch.zeros_like(x)
    dx, dgamma, dbeta = norm.instance_norm_act_bwd_plain(
        x0, g, gamma, beta, mean, rstd, "leaky_relu")
    assert dbeta.item() == pytest.approx(0.02)
    _, _, dbeta_relu = norm.instance_norm_act_bwd_plain(
        x0, g, gamma, beta, mean, rstd, "relu")
    assert dbeta_relu.item() == 0.0


# ----------------------------------------------------------------- resize --

def _port_vjp(fn, x, ct):
    xt = _leaf(x)
    y = fn(xt)
    y.backward(torch.from_numpy(ct))
    return y, xt.grad


@pytest.mark.parametrize("shape", [(1, 4, 4, 4, 8), (2, 8, 6, 4, 16)])
def test_down_backward_matches_pallas_interpret(monkeypatch, shape):
    monkeypatch.setattr(pallas_resize, "_INTERPRET", True)
    x = _rand(shape, 20)
    ct = _rand((shape[0],) + tuple(s // 2 for s in shape[1:4]) + shape[4:], 21)
    _, vjp = jax.vjp(pallas_resize.downsample2x_pallas, jnp.asarray(x))
    _, got = _port_vjp(ops.downsample2x, x, ct)
    _close(got, vjp(jnp.asarray(ct))[0])


@pytest.mark.parametrize("shape", [
    (1, 4, 4, 4, 8), (2, 6, 14, 10, 8), (1, 7, 6, 5, 4), (1, 2, 3, 2, 3),
])
def test_down_backward_matches_jax_autodiff(shape):
    x = _rand(shape, 22)
    ct = _rand((shape[0],) + tuple(s // 2 for s in shape[1:4]) + shape[4:], 23)
    _, vjp = jax.vjp(jax_resize.downsample2x_jnp, jnp.asarray(x))
    y, got = _port_vjp(ops.downsample2x, x, ct)
    assert got.shape == x.shape
    _close(got, vjp(jnp.asarray(ct))[0])


UP_SHAPES = [
    (1, 4, 4, 4, 8), (2, 5, 6, 7, 16), (1, 1, 2, 2, 8), (1, 1, 1, 1, 4),
    (1, 2, 1, 3, 3), (1, 3, 5, 2, 5),
]


@pytest.mark.parametrize("shape", UP_SHAPES)
def test_up_backward_matches_pallas_interpret(monkeypatch, shape):
    monkeypatch.setattr(pallas_resize, "_INTERPRET", True)
    x = _rand(shape, 24)
    ct = _rand((shape[0],) + tuple(2 * s for s in shape[1:4]) + shape[4:], 25)
    _, vjp = jax.vjp(pallas_resize.upsample2x_pallas, jnp.asarray(x))
    _, got = _port_vjp(ops.upsample2x, x, ct)
    _close(got, vjp(jnp.asarray(ct))[0])


@pytest.mark.parametrize("shape", UP_SHAPES)
def test_up_backward_matches_jax_autodiff(shape):
    x = _rand(shape, 26)
    ct = _rand((shape[0],) + tuple(2 * s for s in shape[1:4]) + shape[4:], 27)
    _, vjp = jax.vjp(jax_resize.upsample2x_jnp, jnp.asarray(x))
    _, got = _port_vjp(ops.upsample2x, x, ct)
    _close(got, vjp(jnp.asarray(ct))[0])


@pytest.mark.parametrize("fn,plain,shape", [
    (ops.downsample2x, resize.downsample2x_plain, (2, 7, 6, 5, 3)),
    (ops.upsample2x, resize.upsample2x_plain, (1, 3, 1, 2, 5)),
])
def test_resize_functions_match_autograd_of_plain(fn, plain, shape):
    x = _rand(shape, 28)
    ct = _rand(tuple(plain(torch.from_numpy(x)).shape), 29)
    _, got = _port_vjp(fn, x, ct)
    xt = _leaf(x)
    plain(xt).backward(torch.from_numpy(ct))
    _close(got, xt.grad.numpy())


def test_resize_backward_keeps_dtype():
    g = torch.from_numpy(_rand((1, 4, 4, 4, 8), 30)).bfloat16()
    assert resize.upsample2x_bwd_plain(g).dtype == torch.bfloat16
    assert resize.downsample2x_bwd_plain(g, (1, 8, 8, 8, 8)).dtype == torch.bfloat16


# ------------------------------------------------------------------- conv --

def _xla_conv(x, w):
    return lax.conv_general_dilated(
        x, w, (1, 1, 1), "SAME", dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


@pytest.mark.parametrize("shape,co", [
    ((1, 6, 5, 4, 8), 12), ((2, 3, 1, 2, 5), 3), ((1, 8, 8, 8, 16), 8),
])
def test_conv_dgrad_is_the_flipped_weight_conv(shape, co):
    x = _rand(shape, 31)
    w = _rand((3, 3, 3, shape[-1], co), 32, 0.2)
    ct = _rand(shape[:4] + (co,), 33)
    xt, wt = _leaf(x), _leaf(w)
    conv.conv3d_plain(xt, wt).backward(torch.from_numpy(ct))
    dgrad = conv.conv3d_plain(torch.from_numpy(ct),
                              conv.dgrad_weight(torch.from_numpy(w)))
    _close(dgrad, xt.grad.numpy())
    xs, ws = _leaf(x), _leaf(w)
    ops.conv3d(xs, ws).backward(torch.from_numpy(ct))
    _close(xs.grad, xt.grad.numpy())
    _close(ws.grad, wt.grad.numpy())
    _, vjp = jax.vjp(_xla_conv, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(ct))
    _close(xs.grad, jdx)
    _close(ws.grad, jdw, atol=1e-4, rtol=1e-4)


def test_conv_dgrad_skipped_without_input_grad(monkeypatch):
    calls = []
    monkeypatch.setattr(conv, "_conv3d_fwd",
                        lambda x, w: calls.append(tuple(w.shape))
                        or conv.conv3d_plain(x, w))
    x = torch.from_numpy(_rand((1, 4, 4, 4, 4), 34))
    w = _leaf(_rand((3, 3, 3, 4, 6), 35, 0.2))
    ops.conv3d(x, w).sum().backward()
    assert calls == [(3, 3, 3, 4, 6)] and w.grad is not None
    xt = x.clone().requires_grad_(True)
    ops.conv3d(xt, w).sum().backward()
    assert calls[-1] == (3, 3, 3, 6, 4)


def test_backward_counters_stay_zero_on_cpu():
    ops.reset_launch_counts()
    x = _leaf(_rand((1, 4, 4, 4, 8), 36))
    y = ops.upsample2x(ops.downsample2x(ops.instance_norm_act(x)))
    y.sum().backward()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_WRAPPERS, 0)
    m = torch.empty(1, 2, 2, 2, 8, device="meta")
    for fn, args in ((ops.instance_norm_act_bwd, (m, m, None, None, None, None)),
                     (ops.downsample2x_bwd, (m, (1, 4, 4, 4, 8))),
                     (ops.upsample2x_bwd, (m,))):
        with pytest.raises(RuntimeError, match="no kernel"):
            fn(*args)


# ------------------------------------------ the kernels' launch plans, on CPU --

@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("sms,shape", [(7, NORM_SHAPE), (132, NORM_SHAPE),
                                       (132, (2, 8, 8, 8, 8))])
def test_norm_bwd_blocked_plain_matches_pallas_interpret(activation, sms, shape):
    """The plain version organised as csrc/in_act_bwd.cu (its block ranges
    and merge order: several blocks a sample in the grid form, one in the
    column form of N S <= 2048) against the reference's VJP, the Pallas
    kernel in interpret mode, within 1e-5."""
    x, g, b, ct = _norm_case(shape, 40)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda *a: instance_norm_act_pallas(*a, activation=activation),
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
        want = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x)
    _, mean, rstd = norm._plain_stats(xt, torch.from_numpy(g),
                                      torch.from_numpy(b), 1e-5, activation)
    n, c = shape[0], shape[-1]
    plan = norm.plan_in_bwd(n, x.size // (n * c), c, sms)
    assert plan.column == (x.size // c <= norm.BWD_COLUMN_VOXELS)
    assert (plan.bps > 1) != plan.column
    got = norm.instance_norm_act_bwd_blocked_plain(
        xt, torch.from_numpy(ct), torch.from_numpy(g), torch.from_numpy(b),
        mean, rstd, activation, sms=sms)
    for a, w in zip(got, want):
        _close(a, w, atol=1e-5, rtol=1e-5)


def _train_norm_shapes():
    from brats2019_tpu_torch.configs.presets import get_preset

    exp = get_preset("cascade")
    out = set()
    for cfg, patch in ((exp.unet, exp.train.patch),
                       (exp.coarse_unet, exp.train.coarse_patch)):
        s = tuple(v // cfg.stem_downsample for v in patch)
        for lvl in range(cfg.levels):
            out.add((1, math.prod(v >> lvl for v in s), cfg.feats(lvl)))
    return sorted(out)


@pytest.mark.parametrize("n,s,c", _train_norm_shapes() + [(2, 105, 8),
                                                          (1, 1, 320),
                                                          (1, 64 ** 3, 48)])
def test_norm_bwd_plan_fits_the_card(n, s, c):
    """Every block resident at once (one per SM of 132), shared memory under
    the limit, each thread on fixed channels; levels below the top hold all
    of x and g in shared memory; N S <= 2048 takes the column form."""
    p = norm.plan_in_bwd(n, s, c)
    c8 = c // 8
    assert p.smem <= norm.SMEM_LIMIT and p.threads <= 512
    if p.column:                 # one block a column, every voxel held
        assert n * s <= norm.BWD_COLUMN_VOXELS and p.bps == 1
        assert p.threads % 32 == 0
        assert p.smem == 32 * n * s + 2 * p.threads + 64 * n
        return
    assert n * p.bps <= 132 and p.threads % c8 == 0
    assert p.smem == 32 * p.keep + 32 * p.threads
    assert p.keep % c8 == 0      # whole voxels held: the rest keeps its channels
    assert p.bps <= s
    if s * c * 4 <= 16.8e6:      # x + g of the level fit the card's blocks
        assert p.keep >= -(-s // p.bps) * c8


def test_norm_bwd_plan_refuses_what_the_kernel_does_not_take():
    for args in ((1, 64, 12), (133, 64, 64), (1, 4097, 1032)):
        with pytest.raises(ValueError):
            norm.plan_in_bwd(*args)


def test_up_bwd_reads_a_strided_concat_gradient():
    """The up half of a concat gradient is read in place at the concat's
    channel pitch: equal to the contiguous copy's VJP, and the concat op's
    backward equals that of the plain up followed by torch.cat."""
    cat = torch.from_numpy(_rand((2, 8, 6, 4, 24), 41))
    view = cat[..., :16]
    assert resize.channel_pitch(view) == 24 and resize.channel_pitch(cat) == 24
    assert resize.channel_pitch(cat.permute(0, 2, 1, 3, 4)) is None
    torch.testing.assert_close(ops.upsample2x_bwd(view),
                               ops.upsample2x_bwd(view.contiguous()),
                               rtol=0, atol=0)
    x, skip = _leaf(_rand((2, 4, 3, 2, 16), 42)), _leaf(_rand((2, 8, 6, 4, 8), 43))
    ops.upsample2x_concat(x, skip).backward(cat)
    xr, sr = _leaf(x.detach().numpy()), _leaf(skip.detach().numpy())
    torch.cat([resize.upsample2x_plain(xr), sr], -1).backward(cat)
    _close(x.grad, xr.grad.numpy())
    torch.testing.assert_close(skip.grad, sr.grad, rtol=0, atol=0)
