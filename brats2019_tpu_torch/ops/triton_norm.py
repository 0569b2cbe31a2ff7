"""Triton kernels of the fused InstanceNorm3d + activation, forward and
backward.

Imported only by ``ops/norm.py`` when it launches on a CUDA tensor (this
module imports triton at the top; nothing else imports it).

Forward. Replaces ``brats2019_tpu/ops/pallas_norm.py``
instance_norm_act_pallas (:340) -> _fwd_pallas (:176, kernel _fwd_kernel
:142), and the jnp path the JAX package runs by default
(``ops/norm.py:49-67``).

What bounds it on the card: device-memory bandwidth. Per element it reads
the bf16 input twice and writes bf16 once, with a handful of flops, far
below the H100's ~295 flop/byte ridge.

Design. The TPU kernel carries its per-channel sums from one sequential grid
step to the next; Hopper blocks run in no order, so the reduction is split:

1. ``_in_stats_kernel``: grid (N*P, C blocks). Each program owns a fixed
   chunk of voxels of one sample and folds its (BLOCK_S, BLOCK_C) tiles into
   a running (count, mean, M2) with Chan's update: tile mean and centred
   M2 from registers, never the one-pass E[x^2] - mean^2 that loses digits
   over 262,144 voxels.
2. ``_in_finalize_kernel``: grid (N, C blocks). Loads all P partials of a
   channel block in one tile and merges them with the exact parallel
   formula (mean = sum n_i mu_i / n, M2 = sum M2_i + sum n_i (mu_i - mean)^2)
   - a fixed reduction tree, so repeat runs are bitwise equal (no atomics).
3. ``_in_apply_kernel``: grid (S blocks, N, C blocks). One fused
   elementwise pass ((x - mean) * rstd * gamma + beta, then the activation)
   with masked block loads; NDHWC rows are contiguous along C.

Where the conv before the norm ran with its STATS epilogue
(``csrc/conv3d_wgmma.cu``: (count, mean, centred M2) per box of the conv's
plan and channel, f32 (3, N, P, C)), :func:`launch_from_partials` skips the
statistics pass: two launches and two passes, x read once and y written once.

4. ``_in_merge_kernel``: grid (N, C blocks of 16). At (8, 64^3) a sample
   has 1,024 boxes, too many for one tile in registers as
   ``_in_finalize_kernel`` holds its P, so it walks P in chunks of 256 in a
   fixed order, twice: sum of counts and of count * mean, then, around the
   merged mean, the sum of M2 + count * (mean_i - mean)^2 (the same parallel
   formula; bitwise repeatable).
5. ``_in_apply_kernel`` as above.

In f32 (``csrc/conv3d.cu``'s STATS epilogue gives the partials: 32 to 512
boxes a sample at the f32 configurations' shapes) the two are one launch,
``_in_merge_apply_kernel``: each program merges its sample's partials in
the same fixed order before it applies (a launch less per IN; the partials
are read again by every program, from L2).

Statistics are f32 with biased variance, eps inside the rsqrt, as in the
reference. :func:`launch` returns the per-(n, c) f32 mean and rstd: the
backward's residuals, as ``_in_act_fwd`` (:324-326) keeps them.

Backward. Replaces ``_bwd_pallas`` (:265, kernel ``_bwd_kernel`` :225): with
g_a = g * act'(y_pre) and xhat = (x - mean) * rstd,

    dbeta = sum g_a     dgamma = sum g_a * xhat     (over n and space)
    dx    = gamma * rstd * (g_a - mean_s(g_a) - xhat * mean_s(g_a * xhat))

act' is taken at y_pre = xhat * gamma + beta with ``y_pre > 0`` (leaky: 0.01
at exactly 0), as ``_act_grad`` (:118-123). Bound by bandwidth as the
forward is: it reads x and g twice and writes dx once (bf16). The TPU
kernel carries the two sums across its sequential grid; here the forward's
split is reused:

6. ``_in_bwd_partial_kernel``: grid (N*P, C blocks); each program folds its
   chunk of voxels into (BLOCK_S, BLOCK_C) f32 tiles of g_a and g_a * xhat
   (x-hat and y_pre recomputed from x, mean, rstd: nothing of the forward
   but the two (N, C) vectors is kept) and reduces them once at the end.
7. ``_in_bwd_merge_kernel``: grid (C blocks); walks n and the P partials in
   a fixed order, writes the per-(n, c) sums and dgamma, dbeta (summed over
   n). No atomics: repeat runs are bitwise equal.
8. ``_in_bwd_dx_kernel``: grid (S blocks, N, C blocks), one fused pass that
   writes dx.

Since the backward moved to ``csrc/in_act_bwd.cu`` (one launch, x and g
read once where they fit in shared memory), kernels 6-8 run where C is not
a multiple of 8, and ``chip_smoke.py`` times them as its ``prev_ms``.

dtypes: every load converts to f32 and every store to the output tensor's
dtype, so the same kernels serve bf16 and f32 tensors (the f32 route of the
configurations whose compute dtype is float32: ``ops/norm.py``); the
statistics and sums are f32 in both.
"""

import torch
import triton
import triton.language as tl

from . import _build

ACT_CODES = {"none": 0, "relu": 1, "leaky_relu": 2}


@triton.jit
def _in_stats_kernel(x_ptr, part_ptr, S, C, NP, P, chunk,
                     BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
    pid = tl.program_id(0)
    cb = tl.program_id(1)
    n = pid // P
    p = pid % P
    offs_c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = offs_c < C
    s_start = p * chunk
    s_end = tl.minimum(s_start + chunk, S)
    base = x_ptr + n.to(tl.int64) * S * C
    cnt = tl.zeros([BLOCK_C], dtype=tl.float32)
    mean = tl.zeros([BLOCK_C], dtype=tl.float32)
    m2 = tl.zeros([BLOCK_C], dtype=tl.float32)
    for s0 in range(s_start, s_end, BLOCK_S):
        offs_s = s0 + tl.arange(0, BLOCK_S)
        smask = offs_s < s_end
        mask = smask[:, None] & cmask[None, :]
        ptrs = base + offs_s.to(tl.int64)[:, None] * C + offs_c[None, :]
        xb = tl.load(ptrs, mask=mask, other=0.0).to(tl.float32)
        nb = tl.sum(smask.to(tl.float32), axis=0)
        mb = tl.sum(xb, axis=0) / nb
        dev = tl.where(mask, xb - mb[None, :], 0.0)
        m2b = tl.sum(dev * dev, axis=0)
        tot = cnt + nb
        delta = mb - mean
        mean = mean + delta * (nb / tot)
        m2 = m2 + m2b + delta * delta * (cnt * nb / tot)
        cnt = tot
    out = pid.to(tl.int64) * C + offs_c
    stride = NP * C
    tl.store(part_ptr + out, cnt, mask=cmask)
    tl.store(part_ptr + stride + out, mean, mask=cmask)
    tl.store(part_ptr + 2 * stride + out, m2, mask=cmask)


@triton.jit
def _in_finalize_kernel(part_ptr, mean_ptr, rstd_ptr, NP, P, C, eps,
                        BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    n = tl.program_id(0)
    cb = tl.program_id(1)
    offs_p = tl.arange(0, BLOCK_P)
    offs_c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = offs_c < C
    mask = (offs_p < P)[:, None] & cmask[None, :]
    idx = (n * P + offs_p)[:, None] * C + offs_c[None, :]
    stride = NP * C
    cnt = tl.load(part_ptr + idx, mask=mask, other=0.0)
    mu = tl.load(part_ptr + stride + idx, mask=mask, other=0.0)
    m2 = tl.load(part_ptr + 2 * stride + idx, mask=mask, other=0.0)
    total = tl.sum(cnt, axis=0)
    mean = tl.sum(cnt * mu, axis=0) / total
    dev = tl.where(mask, mu - mean[None, :], 0.0)
    var = (tl.sum(m2, axis=0) + tl.sum(cnt * dev * dev, axis=0)) / total
    rstd = 1.0 / tl.sqrt(var + eps)
    tl.store(mean_ptr + n * C + offs_c, mean, mask=cmask)
    tl.store(rstd_ptr + n * C + offs_c, rstd, mask=cmask)


@triton.jit
def _merge_stats(part_ptr, n, offs_c, cmask, P, C, NPC, eps,
                 BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    """Sample n's per-box (count, mean, M2) merged over its P boxes, walked
    in chunks of BLOCK_P in a fixed order, twice: sum of counts and of count
    * mean, then, around the merged mean, the sum of M2 + count * (mean_i -
    mean)^2. Returns the (BLOCK_C,) mean and rstd."""
    base = n.to(tl.int64) * P * C
    acc_n = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.float32)
    acc_s = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.float32)
    for p0 in range(0, P, BLOCK_P):
        offs_p = p0 + tl.arange(0, BLOCK_P)
        mask = (offs_p < P)[:, None] & cmask[None, :]
        idx = base + offs_p.to(tl.int64)[:, None] * C + offs_c[None, :]
        cnt = tl.load(part_ptr + idx, mask=mask, other=0.0)
        mu = tl.load(part_ptr + NPC + idx, mask=mask, other=0.0)
        acc_n += cnt
        acc_s += cnt * mu
    total = tl.sum(acc_n, axis=0)
    mean = tl.sum(acc_s, axis=0) / total
    acc_m2 = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.float32)
    for p0 in range(0, P, BLOCK_P):
        offs_p = p0 + tl.arange(0, BLOCK_P)
        mask = (offs_p < P)[:, None] & cmask[None, :]
        idx = base + offs_p.to(tl.int64)[:, None] * C + offs_c[None, :]
        cnt = tl.load(part_ptr + idx, mask=mask, other=0.0)
        mu = tl.load(part_ptr + NPC + idx, mask=mask, other=0.0)
        m2 = tl.load(part_ptr + 2 * NPC + idx, mask=mask, other=0.0)
        dev = mu - mean[None, :]
        acc_m2 += m2 + cnt * dev * dev
    var = tl.sum(acc_m2, axis=0) / total
    return mean, 1.0 / tl.sqrt(var + eps)


@triton.jit
def _in_merge_kernel(part_ptr, mean_ptr, rstd_ptr, P, C, NPC, eps,
                     BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    n = tl.program_id(0)
    cb = tl.program_id(1)
    offs_c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = offs_c < C
    mean, rstd = _merge_stats(part_ptr, n, offs_c, cmask, P, C, NPC, eps,
                              BLOCK_P, BLOCK_C)
    tl.store(mean_ptr + n * C + offs_c, mean, mask=cmask)
    tl.store(rstd_ptr + n * C + offs_c, rstd, mask=cmask)


@triton.jit
def _apply_block(x_ptr, y_ptr, mean, rstd, g, b, n, sb, offs_c, cmask, S, C,
                 ACT: tl.constexpr, BLOCK_S: tl.constexpr):
    """One (BLOCK_S, BLOCK_C) block of sample n: y = act((x - mean) * rstd
    * g + b)."""
    offs_s = sb * BLOCK_S + tl.arange(0, BLOCK_S)
    mask = (offs_s < S)[:, None] & cmask[None, :]
    off = (n.to(tl.int64) * S * C + offs_s.to(tl.int64)[:, None] * C
           + offs_c[None, :])
    x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    y = (x - mean[None, :]) * rstd[None, :]
    y = y * g[None, :] + b[None, :]
    if ACT == 1:
        y = tl.maximum(y, 0.0)
    elif ACT == 2:
        y = tl.where(y >= 0, y, y * 0.01)
    tl.store(y_ptr + off, y.to(y_ptr.dtype.element_ty), mask=mask)


@triton.jit
def _in_apply_kernel(x_ptr, y_ptr, mean_ptr, rstd_ptr, g_ptr, b_ptr, S, C,
                     ACT: tl.constexpr, BLOCK_S: tl.constexpr,
                     BLOCK_C: tl.constexpr):
    sb = tl.program_id(0)
    n = tl.program_id(1)
    cb = tl.program_id(2)
    offs_c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = offs_c < C
    mean = tl.load(mean_ptr + n * C + offs_c, mask=cmask, other=0.0)
    rstd = tl.load(rstd_ptr + n * C + offs_c, mask=cmask, other=0.0)
    g = tl.load(g_ptr + offs_c, mask=cmask, other=0.0)
    b = tl.load(b_ptr + offs_c, mask=cmask, other=0.0)
    _apply_block(x_ptr, y_ptr, mean, rstd, g, b, n, sb, offs_c, cmask, S, C,
                 ACT, BLOCK_S)


@triton.jit
def _in_merge_apply_kernel(x_ptr, y_ptr, part_ptr, mean_ptr, rstd_ptr, g_ptr,
                           b_ptr, S, C, P, NPC, eps, ACT: tl.constexpr,
                           BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr,
                           BLOCK_P: tl.constexpr, ITERS: tl.constexpr):
    """The merge folded into the apply's prologue: every program merges its
    sample's partials in the same fixed order (so all agree bitwise), the
    programs of the first S block write mean and rstd, then each applies
    ITERS consecutive S blocks."""
    sp = tl.program_id(0)
    n = tl.program_id(1)
    cb = tl.program_id(2)
    offs_c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = offs_c < C
    mean, rstd = _merge_stats(part_ptr, n, offs_c, cmask, P, C, NPC, eps,
                              BLOCK_P, BLOCK_C)
    if sp == 0:
        tl.store(mean_ptr + n * C + offs_c, mean, mask=cmask)
        tl.store(rstd_ptr + n * C + offs_c, rstd, mask=cmask)
    g = tl.load(g_ptr + offs_c, mask=cmask, other=0.0)
    b = tl.load(b_ptr + offs_c, mask=cmask, other=0.0)
    for it in tl.static_range(ITERS):
        _apply_block(x_ptr, y_ptr, mean, rstd, g, b, n, sp * ITERS + it, offs_c,
                     cmask, S, C, ACT, BLOCK_S)


def _pow2(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def _blocks(c: int):
    block_c = min(64, _pow2(c))
    return block_c, max(16, 4096 // block_c)


def apply(x, y, mean, rstd, gamma, beta, activation: str) -> None:
    """The apply pass: y = act((x - mean) * rstd * gamma + beta)."""
    n, s, c = x.shape
    block_c, block_s = _blocks(c)
    _in_apply_kernel[(triton.cdiv(s, block_s), n, triton.cdiv(c, block_c))](
        x, y, mean, rstd, gamma, beta, s, c,
        ACT=ACT_CODES[activation], BLOCK_S=block_s, BLOCK_C=block_c,
        num_warps=4,
    )


def launch(x, y, gamma, beta, eps: float, activation: str):
    """x, y: contiguous (N, S, C) on one CUDA device; gamma, beta: f32 (C,).
    Writes y; returns the f32 (N, C) mean and rstd."""
    n, s, c = x.shape
    block_c, block_s = _blocks(c)
    p_max = 128
    chunk = triton.cdiv(triton.cdiv(s, p_max), block_s) * block_s
    p = triton.cdiv(s, chunk)
    c_blocks = triton.cdiv(c, block_c)
    part = torch.empty((3, n * p, c), dtype=torch.float32, device=x.device)
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty((n, c), dtype=torch.float32, device=x.device)
    _in_stats_kernel[(n * p, c_blocks)](
        x, part, s, c, n * p, p, chunk,
        BLOCK_S=block_s, BLOCK_C=block_c, num_warps=4,
    )
    _in_finalize_kernel[(n, c_blocks)](
        part, mean, rstd, n * p, p, c, eps,
        BLOCK_P=_pow2(p), BLOCK_C=block_c, num_warps=4,
    )
    apply(x, y, mean, rstd, gamma, beta, activation)
    return mean, rstd


def stats(x):
    """The statistics pass of :func:`launch` alone: x contiguous (N, S, C)
    -> f32 (3, N, P, C) per-chunk (count, mean, centred M2), the partials
    format of the conv's STATS epilogue, so a shard's partials can be merged
    with other shards' (``parallel/spatial_unet.py``: InstanceNorm statistics
    over a whole volume split across shards)."""
    n, s, c = x.shape
    block_c, block_s = _blocks(c)
    p_max = 128
    chunk = triton.cdiv(triton.cdiv(s, p_max), block_s) * block_s
    p = triton.cdiv(s, chunk)
    part = torch.empty((3, n * p, c), dtype=torch.float32, device=x.device)
    _in_stats_kernel[(n * p, triton.cdiv(c, block_c))](
        x, part, s, c, n * p, p, chunk,
        BLOCK_S=block_s, BLOCK_C=block_c, num_warps=4,
    )
    return part.view(3, n, p, c)


# 256 boxes x 16 channels a step, 8 warps: the merge is latency-bound (its
# partials sit in L2), so each step keeps many loads in flight
MERGE_BLOCK_P, MERGE_BLOCK_C = 256, 16


def merge(part, eps: float):
    """``part`` f32 contiguous (3, N, P, C) per-box (count, mean, M2) -> the
    f32 (N, C) mean and rstd."""
    _, n, p, c = part.shape
    mean = torch.empty((n, c), dtype=torch.float32, device=part.device)
    rstd = torch.empty((n, c), dtype=torch.float32, device=part.device)
    block_c = min(MERGE_BLOCK_C, _pow2(c))
    _in_merge_kernel[(n, triton.cdiv(c, block_c))](
        part, mean, rstd, p, c, n * p * c, eps,
        BLOCK_P=MERGE_BLOCK_P, BLOCK_C=block_c, num_warps=8,
    )
    return mean, rstd


def merge_apply(x, y, part, gamma, beta, eps: float, activation: str):
    """:func:`merge` folded into :func:`apply`: one launch. Each program
    merges its sample's P partials (chunks of at most 2048 / BLOCK_C boxes)
    before it applies; where P is large it applies several S blocks
    (ITERS, a power of two), so the partials are read fewer times, while
    the grid keeps at least two programs an SM. Writes y; returns the f32
    (N, C) mean and rstd."""
    n, s, c = x.shape
    p = part.shape[2]
    block_c, block_s = _blocks(c)
    block_p = min(_pow2(p), max(16, 2048 // block_c))
    s_blocks, c_blocks = triton.cdiv(s, block_s), triton.cdiv(c, block_c)
    iters, sms = 1, _build.sm_count(x.device)
    while iters * block_s < 8 * p and 2 * sms * iters <= s_blocks * n * c_blocks:
        iters *= 2
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty((n, c), dtype=torch.float32, device=x.device)
    _in_merge_apply_kernel[(triton.cdiv(s_blocks, iters), n, c_blocks)](
        x, y, part, mean, rstd, gamma, beta, s, c, p, n * p * c, eps,
        ACT=ACT_CODES[activation], BLOCK_S=block_s, BLOCK_C=block_c,
        BLOCK_P=block_p, ITERS=iters, num_warps=4,
    )
    return mean, rstd


def launch_from_partials(x, y, part, gamma, beta, eps: float, activation: str):
    """The forward from the conv's partials; x, y as in :func:`launch`: in
    f32 :func:`merge_apply` (one launch), in bf16 :func:`merge`, then
    :func:`apply`. Writes y; returns the f32 (N, C) mean and rstd."""
    if x.dtype == torch.float32:
        return merge_apply(x, y, part, gamma, beta, eps, activation)
    mean, rstd = merge(part, eps)
    apply(x, y, mean, rstd, gamma, beta, activation)
    return mean, rstd


# ------------------------------------------------------------------ backward --

@triton.jit
def _act_grad(y_pre, g, ACT: tl.constexpr):
    r = g
    if ACT == 1:
        r = tl.where(y_pre > 0, g, 0.0)
    elif ACT == 2:
        r = tl.where(y_pre > 0, g, g * 0.01)
    return r


@triton.jit
def _in_bwd_partial_kernel(x_ptr, g_ptr, mean_ptr, rstd_ptr, gam_ptr, bet_ptr,
                           part_ptr, S, C, NP, P, chunk, ACT: tl.constexpr,
                           BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
    pid = tl.program_id(0)
    cb = tl.program_id(1)
    n = pid // P
    p = pid % P
    offs_c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = offs_c < C
    mean = tl.load(mean_ptr + n * C + offs_c, mask=cmask, other=0.0)
    rstd = tl.load(rstd_ptr + n * C + offs_c, mask=cmask, other=0.0)
    gam = tl.load(gam_ptr + offs_c, mask=cmask, other=0.0)
    bet = tl.load(bet_ptr + offs_c, mask=cmask, other=0.0)
    s_start = p * chunk
    s_end = tl.minimum(s_start + chunk, S)
    base = n.to(tl.int64) * S * C
    acc1 = tl.zeros([BLOCK_S, BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_S, BLOCK_C], dtype=tl.float32)
    for s0 in range(s_start, s_end, BLOCK_S):
        offs_s = s0 + tl.arange(0, BLOCK_S)
        mask = (offs_s < s_end)[:, None] & cmask[None, :]
        off = base + offs_s.to(tl.int64)[:, None] * C + offs_c[None, :]
        x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        g = tl.load(g_ptr + off, mask=mask, other=0.0).to(tl.float32)
        xhat = (x - mean[None, :]) * rstd[None, :]
        ga = _act_grad(xhat * gam[None, :] + bet[None, :], g, ACT)
        ga = tl.where(mask, ga, 0.0)
        acc1 += ga
        acc2 += ga * xhat
    out = pid.to(tl.int64) * C + offs_c
    tl.store(part_ptr + out, tl.sum(acc1, axis=0), mask=cmask)
    tl.store(part_ptr + NP * C + out, tl.sum(acc2, axis=0), mask=cmask)


@triton.jit
def _in_bwd_merge_kernel(part_ptr, sums_ptr, dgam_ptr, dbet_ptr, N, P, C, NP,
                         BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    cb = tl.program_id(0)
    offs_p = tl.arange(0, BLOCK_P)
    offs_c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = offs_c < C
    mask = (offs_p < P)[:, None] & cmask[None, :]
    dgam = tl.zeros([BLOCK_C], dtype=tl.float32)
    dbet = tl.zeros([BLOCK_C], dtype=tl.float32)
    for n in range(0, N):
        idx = (n * P + offs_p)[:, None] * C + offs_c[None, :]
        s1 = tl.sum(tl.load(part_ptr + idx, mask=mask, other=0.0), axis=0)
        s2 = tl.sum(tl.load(part_ptr + NP * C + idx, mask=mask, other=0.0),
                    axis=0)
        tl.store(sums_ptr + n * C + offs_c, s1, mask=cmask)
        tl.store(sums_ptr + (N + n) * C + offs_c, s2, mask=cmask)
        dbet += s1
        dgam += s2
    tl.store(dgam_ptr + offs_c, dgam, mask=cmask)
    tl.store(dbet_ptr + offs_c, dbet, mask=cmask)


@triton.jit
def _in_bwd_dx_kernel(x_ptr, g_ptr, dx_ptr, mean_ptr, rstd_ptr, gam_ptr,
                      bet_ptr, sums_ptr, N, S, C, inv_s, ACT: tl.constexpr,
                      BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
    sb = tl.program_id(0)
    n = tl.program_id(1)
    cb = tl.program_id(2)
    offs_s = sb * BLOCK_S + tl.arange(0, BLOCK_S)
    offs_c = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = offs_c < C
    mask = (offs_s < S)[:, None] & cmask[None, :]
    off = (n.to(tl.int64) * S * C + offs_s.to(tl.int64)[:, None] * C
           + offs_c[None, :])
    x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(g_ptr + off, mask=mask, other=0.0).to(tl.float32)
    mean = tl.load(mean_ptr + n * C + offs_c, mask=cmask, other=0.0)
    rstd = tl.load(rstd_ptr + n * C + offs_c, mask=cmask, other=0.0)
    gam = tl.load(gam_ptr + offs_c, mask=cmask, other=0.0)
    bet = tl.load(bet_ptr + offs_c, mask=cmask, other=0.0)
    m1 = tl.load(sums_ptr + n * C + offs_c, mask=cmask, other=0.0) * inv_s
    m2 = tl.load(sums_ptr + (N + n) * C + offs_c, mask=cmask, other=0.0) * inv_s
    xhat = (x - mean[None, :]) * rstd[None, :]
    ga = _act_grad(xhat * gam[None, :] + bet[None, :], g, ACT)
    dx = (gam * rstd)[None, :] * (ga - m1[None, :] - xhat * m2[None, :])
    tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=mask)


def launch_bwd(x, g, dx, mean, rstd, gamma, beta, activation: str):
    """x, g, dx: contiguous (N, S, C) on one CUDA device; mean, rstd (N, C)
    and gamma, beta (C,) f32. Writes dx; returns f32 (dgamma, dbeta)."""
    n, s, c = x.shape
    block_c = min(64, _pow2(c))
    block_s = max(16, 2048 // block_c)
    p_max = 128
    chunk = triton.cdiv(triton.cdiv(s, p_max), block_s) * block_s
    p = triton.cdiv(s, chunk)
    c_blocks = triton.cdiv(c, block_c)
    act = ACT_CODES[activation]
    part = torch.empty((2, n * p, c), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    dgamma = torch.empty((c,), dtype=torch.float32, device=x.device)
    dbeta = torch.empty((c,), dtype=torch.float32, device=x.device)
    _in_bwd_partial_kernel[(n * p, c_blocks)](
        x, g, mean, rstd, gamma, beta, part, s, c, n * p, p, chunk,
        ACT=act, BLOCK_S=block_s, BLOCK_C=block_c, num_warps=4,
    )
    _in_bwd_merge_kernel[(c_blocks,)](
        part, sums, dgamma, dbeta, n, p, c, n * p,
        BLOCK_P=_pow2(p), BLOCK_C=block_c, num_warps=4,
    )
    _in_bwd_dx_kernel[(triton.cdiv(s, block_s), n, c_blocks)](
        x, g, dx, mean, rstd, gamma, beta, sums, n, s, c, 1.0 / s,
        ACT=act, BLOCK_S=block_s, BLOCK_C=block_c, num_warps=4,
    )
    return dgamma, dbeta
