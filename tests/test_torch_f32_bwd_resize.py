"""PyTorch port: the f32 2x up backward and the f32 2x down backward, on the
CPU against the JAX package.

An f32 configuration (the presets ``unit`` and ``smoke``) runs both on
``csrc/resize2x.cu``: the up backward (``upsample2x_bwd_ndhwc_f32``) reads
the decoder's concat gradient's up half in place at the concat's channel
pitch, in the instance (16-byte pieces of a block's channel chunk: 8 or 4)
that ``ops.resize.plan_up_bwd`` picks; the down backward
(``downsample2x_bwd_ndhwc_f32``) writes g / 8 over each 2^3 window. The
kernels run only on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py`` phase 2); here their plain versions are held to the JAX
package:

* ``upsample2x_bwd_plain`` in f32 on the up half of a concat gradient at
  pitches 12, 24 and 48 (unit's and smoke's ups) and at a size-1 axis,
  against the VJP of ``upsample2x_pallas`` (interpret mode), within 1e-6;
* ``downsample2x_bwd_plain`` in f32 against the VJP of ``downsample2x_pallas``
  (interpret mode) bitwise at unit's and smoke's downs, and against the VJP
  of the JAX package's ``reduce_window`` down (the Pallas kernel takes even
  extents only) at odd extents;
* the plans of every up and down backward of a unit and a smoke train step,
  in f32 and bf16: the route, the instance, its tile, the d run and shared
  memory within two blocks an SM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from brats2019_tpu.ops import pallas_resize
from brats2019_tpu.ops import resize as jax_resize
from brats2019_tpu_torch.configs.presets import PRESETS
from brats2019_tpu_torch.ops import resize

F32, BF16 = torch.float32, torch.bfloat16
SMS = 132
# two blocks of the up backward share an SM (__launch_bounds__(256, 2)): an
# H100 SM's 228 KB of shared memory, of which each block's launch reserves 1 KB
SMEM_PER_SM, SMEM_RESERVED = 228 * 1024, 1024


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _train_resizes(preset):
    """[(op, x shape, concat pitch or None)]: the up backwards (at the
    channel pitch of the concat gradient they read) and the down backwards
    of one train step of ``preset``, at their forward input's shape."""
    cfg, patch = PRESETS[preset].unet, PRESETS[preset].train.patch
    s = tuple(v // cfg.stem_downsample for v in patch)
    out = []
    for lvl in range(cfg.levels - 1):
        out.append(("downsample2x_bwd", (1, *s, cfg.feats(lvl)), None))
        s = tuple(v // 2 for v in s)
    for lvl in reversed(range(cfg.levels - 1)):
        c = cfg.feats(lvl + 1)
        out.append(("upsample2x_bwd", (1, *s, c), c + cfg.feats(lvl)))
        s = tuple(v * 2 for v in s)
    return out


TRAIN = sorted({r for p in ("unit", "smoke") for r in _train_resizes(p)})
UPS = sorted({(sh, pitch) for op, sh, pitch in TRAIN if op == "upsample2x_bwd"}
             | {((1, 1, 3, 1, 4), 12), ((1, 5, 3, 2, 12), 24)})
DOWNS = sorted({sh for op, sh, _ in TRAIN if op == "downsample2x_bwd"})
ODD_DOWNS = [(2, 9, 7, 13, 12), (1, 5, 6, 7, 4), (1, 2, 3, 2, 4)]


def test_the_train_steps_resizes():
    """unit: the up backward at C 8 from pitch 12, the down backward at
    (1, 16^3, 4); smoke: C 16 from pitch 24 and C 32 from pitch 48, the
    downs at (1, 64^3, 8) and (1, 32^3, 16)."""
    assert set(UPS) >= {((1, 8, 8, 8, 8), 12), ((1, 32, 32, 32, 16), 24),
                        ((1, 16, 16, 16, 32), 48)}
    assert set(DOWNS) == {(1, 16, 16, 16, 4), (1, 64, 64, 64, 8), (1, 32, 32, 32, 16)}


@pytest.fixture(scope="module")
def jax_up_vjps():
    """{(x shape, pitch): (the concat gradient, the JAX package's Pallas up
    VJP of its up half in interpret mode)}."""
    out = {}
    for i, (shape, pitch) in enumerate(UPS):
        n, d, h, w, c = shape
        cat = _rand((n, 2 * d, 2 * h, 2 * w, pitch), 200 + i)
        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(pallas_resize.upsample2x_pallas,
                             jnp.zeros(shape, jnp.float32))
            want = np.asarray(vjp(jnp.asarray(cat[..., :c]))[0])
        out[(shape, pitch)] = (cat, want)
    return out


@pytest.mark.parametrize("shape,pitch", UPS, ids=str)
def test_f32_up_bwd_plain_from_the_concat_matches_pallas(jax_up_vjps, shape, pitch):
    """The plain up backward on the up half of the concat gradient (a
    strided view at the concat's pitch, as the decoder's backward hands it
    over) within 1e-6 of the reference's VJP; the plan reads it in place on
    resize2x.cu."""
    cat, want = jax_up_vjps[(shape, pitch)]
    g = torch.from_numpy(cat)[..., :shape[4]]
    assert resize.channel_pitch(g) == pitch
    got = resize.upsample2x_bwd_plain(g)
    assert got.dtype == F32 and tuple(got.shape) == shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-6
    assert resize.plan_resize("upsample2x_bwd", shape[4], F32, pitch) == "resize2x.cu"


@pytest.fixture(scope="module")
def jax_down_vjps():
    """{x shape: (g, the JAX package's down VJP: the Pallas kernel in
    interpret mode at even extents, its reduce_window down at odd ones)}."""
    out = {}
    for i, shape in enumerate(DOWNS + ODD_DOWNS):
        n, d, h, w, c = shape
        g = _rand((n, d // 2, h // 2, w // 2, c), 300 + i)
        x = jnp.zeros(shape, jnp.float32)
        if d % 2 or h % 2 or w % 2:
            _, vjp = jax.vjp(jax_resize.downsample2x_jnp, x)
            want = vjp(jnp.asarray(g))[0]
        else:
            with pltpu.force_tpu_interpret_mode():
                _, vjp = jax.vjp(pallas_resize.downsample2x_pallas, x)
                want = vjp(jnp.asarray(g))[0]
        out[shape] = (g, np.asarray(want))
    return out


@pytest.mark.parametrize("shape", DOWNS + ODD_DOWNS, ids=str)
def test_f32_down_bwd_plain_is_bitwise_the_reference(jax_down_vjps, shape):
    """g / 8 on each voxel of its window (exact in f32), 0 on an odd
    extent's last plane: bitwise the reference's VJP, the kernel's function
    (resize2x.cu is held bitwise to this plain version on the card)."""
    g, want = jax_down_vjps[shape]
    got = resize.downsample2x_bwd_plain(torch.from_numpy(g), shape)
    assert got.dtype == F32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    assert resize.plan_resize("downsample2x_bwd", shape[4], F32) == "resize2x.cu"


@pytest.mark.parametrize("op,shape,pitch", TRAIN, ids=str)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
def test_train_step_resize_backwards_plan(op, shape, pitch, dtype):
    """Every up and down backward of a unit and a smoke train step walked
    through the planner by dtype (a route that lives only on CUDA tensors
    hides from every other CPU test): in f32 all on resize2x.cu; the up
    backward's instance one of 8 and 4 pieces with a 4 x (64 / pieces)
    tile of 256 threads, the one that keeps the most threads busy, its d
    run one of 8, 4, 2 and 1, its shared memory two blocks an SM; bf16 keeps
    its one 8-piece instance (Triton where C % 8 != 0) and the Triton down
    backward."""
    n, d, h, w, c = shape
    route = resize.plan_resize(op, c, dtype, pitch)
    if dtype == BF16:
        cuda = op == "upsample2x_bwd" and c % 8 == 0 and pitch % 8 == 0
        assert route == ("resize2x.cu" if cuda else "triton")
        if not cuda:
            return
    else:
        assert route == "resize2x.cu"
    if op == "downsample2x_bwd":
        return
    plan = resize.plan_up_bwd(n, d, h, w, c, dtype, SMS)
    assert plan.pieces in resize.UP_BWD_PIECES
    assert plan.tile == (4, 64 // plan.pieces)
    assert plan.tile[0] * plan.tile[1] * plan.pieces == 256     # the block
    per = 4 if dtype == F32 else 8
    assert plan.chunks == -(-c // (per * plan.pieces))
    assert plan.td in (8, 4, 2, 1)
    assert plan.blocks == (-(-d // plan.td) * -(-h // 4) * -(-w // plan.tile[1])
                           * plan.chunks * n)
    assert 2 * (plan.smem + SMEM_RESERVED) <= SMEM_PER_SM
    if dtype == BF16:
        assert plan.pieces == 8 and plan.smem == 92160
        return

    def busy(pc):
        p, btw = c // 4, 64 // pc
        return p / (-(-p // pc) * pc) * w / (-(-w // btw) * btw)

    assert busy(plan.pieces) == max(busy(pc) for pc in resize.UP_BWD_PIECES)


def test_f32_up_bwd_plans_of_smoke_and_unit():
    """The instances and runs that smoke's and unit's up backwards take on
    an H100 (132 SMs): smoke's top (C 16, 4 pieces) a tile of 4 x 16 and a
    run of 2, smoke's second (C 32) and unit's (C 8) the 8-piece instance,
    a run of 1; the 4-piece ring stays under the 8-piece one."""
    plan = lambda *sh: resize.plan_up_bwd(*sh, F32, SMS)
    assert plan(1, 32, 32, 32, 16)[:4] == (4, (4, 16), 2, 1)
    assert plan(1, 16, 16, 16, 32)[:4] == (8, (4, 8), 1, 1)
    assert plan(1, 8, 8, 8, 8)[:4] == (8, (4, 8), 1, 1)
    assert [resize.up_bwd_smem(p) for p in resize.UP_BWD_PIECES] == [92160, 87040]
    # C 32 in f32 fills a chunk as C 32 in bf16 half does: one launch shape
    assert plan(1, 16, 16, 16, 32) == resize.plan_up_bwd(1, 16, 16, 16, 32, BF16, SMS)
    with pytest.raises(ValueError):
        resize.plan_up_bwd(1, 8, 8, 8, 6, F32)
    with pytest.raises(ValueError):
        resize.plan_up_bwd(1, 8, 8, 8, 16, BF16, pieces=4)
    with pytest.raises(ValueError):       # no 2-piece instance
        resize.plan_up_bwd(1, 8, 8, 8, 16, F32, pieces=2)
    with pytest.raises(TypeError):
        resize.plan_up_bwd(1, 8, 8, 8, 16, torch.float16)
