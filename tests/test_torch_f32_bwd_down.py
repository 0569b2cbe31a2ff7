"""PyTorch port: the f32 IN+act backward and the f32 2x down, on the CPU
against the JAX package.

An f32 configuration (the presets ``unit`` and ``smoke``, the accuracy
benchmark's config) runs the IN+act backward on the f32 instance of
``csrc/in_act_bwd.cu`` (its grid, column or cluster form, by
``ops.norm.plan_in_bwd``) and the 2x down on ``csrc/resize2x.cu``
(``downsample2x_ndhwc_f32``). The kernels run only on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py`` phase 2); here their
plain versions are held to the JAX package:

* ``instance_norm_act_bwd_blocked_plain`` under the f32 plan (the plan's
  block ranges and merge order) against the VJP of the JAX package's Pallas
  IN+act (interpret mode), within 1e-5, at every IN of ``unit`` and
  ``smoke`` and at ragged C = 4 / 12 and N = 2 shapes;
* ``plan_in_bwd`` in f32 at those shapes: forms, ranges, threads and shared
  memory within the kernel's limits;
* ``downsample2x_plain`` in f32 against ``downsample2x_pallas`` (interpret
  mode) within 1e-6 at the f32 configurations' downs, and against the JAX
  package's ``reduce_window`` down (the Pallas kernel takes even H and W
  only) at odd extents.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from brats2019_tpu.ops import pallas_resize
from brats2019_tpu.ops import resize as jax_resize
from brats2019_tpu.ops.pallas_norm import instance_norm_act_pallas
from brats2019_tpu_torch.configs.presets import PRESETS, UNetConfig
from brats2019_tpu_torch.ops import norm, resize

F32 = torch.float32
SMS = 132


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


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _levels(cfg, patch):
    """(N, D, H, W, C) of the IN at each level of ``cfg`` on ``patch`` (the
    forward's and the backward's: two INs a level on the way down, two on
    the way up), and of each 2x down."""
    ins, downs = [], []
    s = tuple(v // cfg.stem_downsample for v in patch)
    for lvl in range(cfg.levels):
        ins.append((1, *s, cfg.feats(lvl)))
        if lvl < cfg.levels - 1:
            downs.append((1, *s, cfg.feats(lvl)))
            s = tuple(v // 2 for v in s)
    return ins, downs


def _preset_ins():
    return sorted({sh for p in ("unit", "smoke")
                   for sh in _levels(PRESETS[p].unet, PRESETS[p].train.patch)[0]})


# ragged: C = 4 and 12 (one and three vectors a voxel), odd extents, N = 2
# (the grid form), one voxel short of the column form's limit
RAGGED = [(1, 9, 7, 11, 4), (2, 9, 7, 13, 12), (2, 16, 16, 16, 12), (1, 5, 6, 7, 12)]
CASES = ([(sh, "relu") for sh in _preset_ins()]
         + [(sh, act) for sh in RAGGED for act in ("relu", "leaky_relu", "none")])


@pytest.fixture(scope="module")
def jax_norm_vjps():
    """{(shape, activation): (x, gamma, beta, ct, (dx, dgamma, dbeta))}: the
    JAX package's Pallas IN+act VJP in interpret mode, as its own tests run
    it on the CPU."""
    out = {}
    for i, (shape, act) in enumerate(CASES):
        x, g = _rand(shape, 10 * i, 3.0, 1.0), _rand(shape[-1:], 10 * i + 1, 0.5, 1.0)
        b, ct = _rand(shape[-1:], 10 * i + 2, 0.2), _rand(shape, 10 * i + 3)
        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(lambda *a, act=act: instance_norm_act_pallas(*a, activation=act),
                             jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
            want = tuple(np.asarray(w) for w in vjp(jnp.asarray(ct)))
        out[(shape, act)] = (x, g, b, ct, want)
    return out


@pytest.mark.parametrize("shape,activation", CASES, ids=str)
def test_f32_blocked_plain_matches_pallas_interpret(jax_norm_vjps, shape, activation):
    """The f32 kernel's plain model (its plan's block ranges, the merge in
    the kernel's order) gives the reference's dx, dgamma and dbeta within
    1e-5 of their largest magnitude."""
    x, g, b, ct, want = jax_norm_vjps[(shape, activation)]
    xt, gt, bt = (torch.from_numpy(a) for a in (x, g, b))
    _, mean, rstd = norm._plain_stats(xt, gt, bt, 1e-5, activation)
    got = norm.instance_norm_act_bwd_blocked_plain(
        xt, torch.from_numpy(ct), gt, bt, mean, rstd, activation, sms=SMS)
    assert got[0].dtype == F32 and got[0].shape == shape
    for a, w in zip(got, want):
        assert _rel(a, w) <= 1e-5


@pytest.mark.parametrize("shape", sorted(set(_preset_ins()) | set(RAGGED)), ids=str)
def test_f32_plan_in_bwd_fits_the_kernel(shape):
    """Every f32 plan is one of the kernel's three forms and within its
    limits (threads up to 512 on whole vectors of 4 channels, shared memory
    within SMEM_LIMIT and as the kernel counts it, every voxel of x and g
    held where the form holds all: column, cluster, and the grid form at the
    f32 presets, whose x and g fit the card's blocks), or the Triton kernels
    where neither the column nor the cluster form takes the shape and x has
    fewer than F32_GRID_VALUES values."""
    n, d, h, w, c = shape
    s, cv = d * h * w, c // 4
    p = norm.plan_in_bwd(n, s, c, SMS, F32)
    if p.route == "triton":
        assert n * s > norm.BWD_COLUMN_VOXELS and n * s * c < norm.F32_GRID_VALUES
        assert n > 1 or norm.f32_cluster_choice(s, c) is None
        return
    assert p.route == "in_act_bwd.cu" and p.threads <= norm.BWD_MAX_THREADS
    assert p.smem <= norm.SMEM_LIMIT
    if p.column:
        assert n * s <= norm.BWD_COLUMN_VOXELS and p.bps == 1 and p.threads % 32 == 0
        assert p.smem == 32 * n * s + 32 * (p.threads // 32) + 32 * n
    elif p.cluster:
        assert n == 1 and 1 <= p.bps <= norm.CLUSTER_MAX and p.bps <= s
        assert p.bps * p.width <= norm.CLUSTER_MAX
        assert cv % p.width == 0 and p.threads % 32 == 0 and p.threads % p.width == 0
        assert p.keep == -(-s // p.bps) * p.width
        assert p.smem == 32 * p.keep + 16 * p.threads + 32 * p.width
        assert 32 * p.keep <= norm.F32_CLUSTER_SMEM
    else:
        assert n * s * c >= norm.F32_GRID_VALUES
        assert n * p.bps <= SMS and p.threads % cv == 0 and p.keep % cv == 0
        assert p.smem == 32 * p.keep + 16 * p.threads
        assert p.bps <= s
        if s * c * 8 <= 16.8e6:
            assert p.keep >= -(-s // p.bps) * cv


def test_f32_plans_of_the_presets():
    """The forms measured fastest at each IN of a smoke and a unit step (an
    H100, PERF.md section 6, row 3f): the grid form at 64^3 (132 blocks,
    every voxel held), the Triton kernels at 32^3, the cluster form at 16^3
    (8 blocks over pairs of vectors at C = 32, 16 over one at C = 4), the
    column form at 8^3."""
    plan = lambda sh: norm.plan_in_bwd(sh[0], math.prod(sh[1:4]), sh[4], SMS, F32)
    top = plan((1, 64, 64, 64, 8))
    assert not (top.column or top.cluster) and top.bps == SMS and top.route == "in_act_bwd.cu"
    assert plan((1, 32, 32, 32, 16)).route == "triton"
    assert plan((1, 16, 16, 16, 32))[1:] == (8, 1024, 41024, False, "in_act_bwd.cu", True, 2)
    assert plan((1, 16, 16, 16, 4))[1:] == (16, 256, 12320, False, "in_act_bwd.cu", True, 1)
    assert plan((1, 8, 8, 8, 8)).column
    assert set(_preset_ins()) == {(1, 64, 64, 64, 8), (1, 32, 32, 32, 16),
                                  (1, 16, 16, 16, 32), (1, 16, 16, 16, 4), (1, 8, 8, 8, 8)}


# --------------------------------------------------------------- the down --

_ACC_UNET = UNetConfig(levels=2, base_features=8, compute_dtype="float32")
DOWNS = sorted({(8, *sh[1:]) for sh in _levels(_ACC_UNET, (32, 32, 32))[1]}
               | {sh for p in ("unit", "smoke")
                  for sh in _levels(PRESETS[p].unet, PRESETS[p].train.patch)[1]}
               | {(2, 9, 7, 13, 12), (1, 5, 6, 7, 4)})


@pytest.fixture(scope="module")
def jax_downs():
    """{shape: (x, the JAX package's Pallas down in interpret mode, or its
    reduce_window down where H or W is odd)}."""
    out = {}
    for i, shape in enumerate(DOWNS):
        x = _rand(shape, 100 + i, 2.0)
        if shape[2] % 2 or shape[3] % 2:
            want = jax_resize.downsample2x_jnp(jnp.asarray(x))
        else:
            with pltpu.force_tpu_interpret_mode():
                want = pallas_resize.downsample2x_pallas(jnp.asarray(x))
        out[shape] = (x, np.asarray(want))
    return out


@pytest.mark.parametrize("shape", DOWNS, ids=str)
def test_f32_down_plain_matches_pallas_interpret(jax_downs, shape):
    """The f32 down's plain version (the kernel's function: the 2^3 average,
    an odd extent's last plane dropped) within 1e-6 of the reference, and
    the plan sends it to resize2x.cu (C % 4 == 0)."""
    x, want = jax_downs[shape]
    got = resize.downsample2x_plain(torch.from_numpy(x))
    assert got.dtype == F32 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= 1e-6
    assert resize.plan_resize("downsample2x", shape[4], F32) == "resize2x.cu"
