"""Fused InstanceNorm3d + activation seam (reference:
``brats2019_tpu/ops/norm.py`` instance_norm_act, whose default jnp path is
:49-67, and ``ops/pallas_norm.py`` instance_norm_act_pallas with its VJP
``_in_act_fwd``/``_in_act_bwd`` :324-337).

NDHWC; statistics per (n, c) over the spatial axes, in f32, biased variance,
``eps`` inside the rsqrt; the output keeps ``x.dtype``.

* CPU tensor: the plain versions :func:`instance_norm_act_plain` and
  :func:`instance_norm_act_bwd_plain`.
* CUDA tensor, bf16 or f32 (the compute dtype of the path), or an error;
  there is no fallback. Forward: the Triton kernels of
  ``ops/triton_norm.py`` (their loads and stores take the tensor's dtype;
  statistics are f32 in both). Backward: ``csrc/in_act_bwd.cu`` (one
  persistent launch, the launch plan of :func:`plan_in_bwd`) where C fills
  whole 16-byte vectors (bf16 C % 8 == 0, f32 C % 4 == 0), the Triton
  kernels for other C; :func:`instance_norm_act_bwd_blocked_plain` is the
  plain version organised as that kernel is.

``partials``: the f32 (3, N, P, C) per-box (count, mean, centred M2) of x
that the conv before the norm computed in its epilogue (``ops/conv.py``
``conv3d(..., stats=True)``: the bf16 wgmma instance's or, in f32, the FFMA
instance's). Given them, the forward skips its statistics
pass: it merges them (:func:`merge_partials_plain` on the CPU, the Triton
merge on CUDA, folded into the apply's launch in f32) and applies, reading
x once.

:func:`instance_norm_act` is an ``autograd.Function``: the forward saves x,
gamma, beta and the f32 (N, C) mean/rstd; the backward returns dx in
``x.dtype`` and dgamma, dbeta in f32, summed over n. act' is taken at
y_pre = xhat * gamma + beta with ``y_pre > 0`` (leaky: 0.01 at exactly 0),
as ``pallas_norm._act_grad`` (:118-123).

Activations: relu, leaky_relu (slope 0.01), none.

The forward is the ``torch.library`` operator ``brats_torch::instance_norm_act``
(``ops/library.py``: the plain version on the CPU, the kernels on CUDA, a
fake form for tracing); the backward is called from the
``autograd.Function`` as before.

``instance_norm_act.launches`` and ``instance_norm_act_bwd.launches`` count
kernel launches (one per call); ``instance_norm_act.launches_partials`` those
of them that took the conv's partials, ``instance_norm_act_bwd.launches_cuda``
those on ``csrc/in_act_bwd.cu`` (bf16 and f32), ``.launches_f32`` of each
those on f32 tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build, library
from .conv import check_dtype, f32_counter

ACTIVATIONS = ("relu", "leaky_relu", "none")
ACT_CODES = {"none": 0, "relu": 1, "leaky_relu": 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_GRID_SIG = [_P] * 11 + [_I, ctypes.c_longlong] + [_I] * 6 + [_P]
_COLUMN_SIG = [_P] * 9 + [_I] * 6 + [_P]
_SIG = {
    "in_act_bwd_ndhwc_bf16": _GRID_SIG,
    "in_act_bwd_ndhwc_f32": _GRID_SIG,
    "in_act_bwd_column_ndhwc_bf16": _COLUMN_SIG,
    "in_act_bwd_column_ndhwc_f32": _COLUMN_SIG,
    "in_act_bwd_cluster_ndhwc_f32": [_P] * 9 + [_I] * 8 + [_P],
}
SMEM_LIMIT = 232_448      # dynamic shared memory a block may ask for (H100)
BWD_MAX_THREADS = 512
BWD_MAX_C = 1024   # the per-sample sums (2C f32) reuse the reduction rows
# N S up to this: the one-block-per-column form (csrc/in_act_bwd.cu takes
# up to 4096; at 4096 its fewer blocks read slower than the grid form's)
BWD_COLUMN_VOXELS = 2048
# the f32 plans (PERF.md section 6, row 3f): the column form up to
# BWD_COLUMN_VOXELS voxels, as in bf16; for one sample the cluster form (16
# vector columns a cluster: 8 blocks over groups of two 16-byte vectors, or
# 16 over one) where a block's share of x and g is at most F32_CLUSTER_SMEM
# bytes; the grid form where x has at least F32_GRID_VALUES values; the
# Triton kernels between (at (1, 32^3, 16) the cluster form's 32 SMs and
# the grid form's barriers both lost to the three launches)
CLUSTER_MAX = 16
F32_CLUSTER_SMEM = 65_536
F32_GRID_VALUES = 1 << 20


def _lib() -> ctypes.CDLL:
    return _build.load_library("in_act_bwd", ["in_act_bwd.cu"], _SIG)


def _act(y: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(y)
    if activation == "leaky_relu":
        return F.leaky_relu(y, 0.01)
    if activation == "none":
        return y
    raise ValueError(f"unknown activation {activation!r}; one of {ACTIVATIONS}")


def _act_grad(y_pre: torch.Tensor, g: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.where(y_pre > 0, g, 0.0)
    if activation == "leaky_relu":
        return torch.where(y_pre > 0, g, g * 0.01)
    return g


def _plain_apply(x, mean, rstd, scale, bias, activation):
    n, c = x.shape[0], x.shape[-1]
    bshape = (n,) + (1,) * (x.dim() - 2) + (c,)
    y = (x.float() - mean.reshape(bshape)) * rstd.reshape(bshape)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return _act(y, activation).to(x.dtype)


def _plain_stats(x, scale, bias, eps, activation):
    red = tuple(range(1, x.dim() - 1))
    xf = x.float()
    mu = xf.mean(red, keepdim=True)
    var = (xf - mu).square().mean(red, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    n, c = x.shape[0], x.shape[-1]
    mu, rstd = mu.reshape(n, c), rstd.reshape(n, c)
    return _plain_apply(x, mu, rstd, scale, bias, activation), mu, rstd


def merge_partials_plain(part: torch.Tensor, eps: float = 1e-5):
    """(3, N, P, C) per-box (count, mean, centred M2) -> the f32 (N, C) mean
    and rstd, by the parallel formula of ``_in_merge_kernel``: mean = sum
    n_i mu_i / n, M2 = sum (M2_i + n_i (mu_i - mean)^2), biased variance."""
    cnt, mu, m2 = part.float()
    total = cnt.sum(1)
    mean = (cnt * mu).sum(1) / total
    var = (m2 + cnt * (mu - mean[:, None]) ** 2).sum(1) / total
    return mean, torch.rsqrt(var + eps)


def instance_norm_act_plain(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    eps: float = 1e-5,
    activation: str = "relu",
) -> torch.Tensor:
    return _plain_stats(x, scale, bias, eps, activation)[0]


def instance_norm_act_bwd_plain(
    x: torch.Tensor,
    g: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    activation: str = "relu",
):
    """The explicit VJP of ``pallas_norm.py:22-27`` in f32:
    (dx in x.dtype, dgamma f32 (C,), dbeta f32 (C,))."""
    n, c = x.shape[0], x.shape[-1]
    red = tuple(range(1, x.dim() - 1))
    bshape = (n,) + (1,) * len(red) + (c,)
    mu, rs = mean.reshape(bshape), rstd.reshape(bshape)
    gam, bet = gamma.float(), beta.float()
    xhat = (x.float() - mu) * rs
    ga = _act_grad(xhat * gam + bet, g.float(), activation)
    s1 = ga.sum(red, keepdim=True)
    s2 = (ga * xhat).sum(red, keepdim=True)
    inv_s = 1.0 / (x.numel() // (n * c))
    dx = gam * rs * (ga - s1 * inv_s - xhat * (s2 * inv_s))
    return dx.to(x.dtype), s2.reshape(n, c).sum(0), s1.reshape(n, c).sum(0)


MERGE_LANES = 32   # csrc/in_act_bwd.cu sums a column of partials with one warp


class InBwdPlan(NamedTuple):
    """Launch plan of ``csrc/in_act_bwd.cu``. The grid form: ``bps`` blocks
    per sample of ``threads`` threads (a multiple of C/E, E the channels of a
    16-byte vector: 8 bf16, 4 f32; so each thread keeps its E channels),
    each holding up to ``keep`` 16-byte vectors of x and of g in ``smem``
    bytes of shared memory. The ``column`` form: one block of ``threads``
    per E-channel column over all samples, which is one block range per
    sample (``bps`` 1). The ``cluster`` form (f32, one sample): a cluster of
    ``bps`` blocks per group of ``width`` vectors, each block holding
    ``keep`` vectors (its S / bps voxels of the group)."""
    threads: int
    bps: int
    keep: int
    smem: int
    column: bool = False
    route: str = "in_act_bwd.cu"    # or "triton": the three Triton kernels
    cluster: bool = False
    width: int = 0


TRITON_BWD = InBwdPlan(0, 0, 0, 0, route="triton")


def vector_channels(dtype: torch.dtype) -> int:
    """Channels of a 16-byte vector of ``dtype`` (bf16 8, f32 4)."""
    return 4 if dtype == torch.float32 else 8


def column_plan(n: int, s: int, c: int, dtype: torch.dtype) -> InBwdPlan:
    """The column form's plan: a block per E-channel column, a thread per
    voxel up to 512, every voxel of x and g held."""
    e = vector_channels(dtype)
    threads = min(BWD_MAX_THREADS, -(-n * s // 32) * 32)
    return InBwdPlan(threads, 1, s * (c // e),
                     32 * n * s + 8 * e * (threads // 32) + 8 * e * n,
                     column=True)


def grid_plan(n: int, s: int, c: int, sms: int, dtype: torch.dtype) -> InBwdPlan:
    """The grid form's plan: up to 512 threads (a multiple of C/E), the
    samples' voxels cut into ``bps`` ranges each, at most ``sms // n`` and
    no more than give each thread one vector of x; each block holds as many
    whole voxels of its range as shared memory takes."""
    cv = c // vector_channels(dtype)
    threads = (BWD_MAX_THREADS // cv) * cv
    bps = max(1, min(sms // n, -(-s * cv // threads)))
    fixed = 4 * vector_channels(dtype) * threads     # the block reduction's rows
    # whole voxels: a thread's vectors past the held ones keep its channels
    keep = min(-(-s // bps), (SMEM_LIMIT - fixed) // (32 * cv)) * cv
    return InBwdPlan(threads, bps, keep, 32 * keep + fixed)


def cluster_plan(s: int, c: int, k: int, width: int) -> InBwdPlan:
    """The f32 cluster form's plan for one sample: a cluster of ``k`` blocks
    over the S voxels per group of ``width`` 16-byte vectors (a power of two
    that divides C/4), each block holding its ceil(S/k) voxels of the group
    with a thread per vector up to 512 (a multiple of 32)."""
    keep = -(-s // k) * width
    threads = min(BWD_MAX_THREADS, max(2 * width, -(-keep // 32) * 32))
    return InBwdPlan(threads, k, keep, 32 * keep + 16 * threads + 32 * width,
                     cluster=True, width=width)


def f32_cluster_choice(s: int, c: int):
    """(k, width) of the f32 cluster form for one sample of S voxels and C
    channels, or None: groups of two 16-byte vectors (whole 32-byte sectors
    a voxel) where C/4 is even, else one; 16 vector columns a cluster
    (k = 16 / width); None where a block's share of x and g exceeds
    F32_CLUSTER_SMEM."""
    width = 2 if (c // 4) % 2 == 0 else 1
    k = min(CLUSTER_MAX // width, s)
    if 32 * -(-s // k) * width > F32_CLUSTER_SMEM:
        return None
    return k, width


@functools.lru_cache(maxsize=None)
def plan_in_bwd(n: int, s: int, c: int, sms: int = 132,
                dtype: torch.dtype = torch.bfloat16) -> InBwdPlan:
    """The plan for x of N samples, S voxels and C channels in ``dtype`` on
    a card of ``sms`` SMs: ``csrc/in_act_bwd.cu``. Where N S is at most
    BWD_COLUMN_VOXELS the column form; in f32 for one
    sample the cluster form where :func:`f32_cluster_choice` finds one, and
    :data:`TRITON_BWD` below F32_GRID_VALUES values; else the grid form, one
    block per SM at most (the grid barrier needs them all resident), the
    samples' voxels cut into equal block-contiguous ranges, no more blocks
    than give each thread one vector of x. Raises TypeError for another
    dtype and ValueError for what the kernel does not take (a C that does not
    fill whole 16-byte vectors goes to the Triton kernels before this is
    asked)."""
    check_dtype(dtype, "instance_norm_act_bwd")
    e = vector_channels(dtype)
    f32 = dtype == torch.float32
    if c % e or not 0 < c // e <= BWD_MAX_C // e or n < 1 or s < 1:
        raise ValueError(f"in_act_bwd.cu: no plan for N={n} S={s} C={c} {dtype}")
    if n * s <= BWD_COLUMN_VOXELS:
        return column_plan(n, s, c, dtype)
    choice = f32_cluster_choice(s, c) if f32 and n == 1 else None
    if choice is not None:
        return cluster_plan(s, c, *choice)
    if f32 and n * s * c < F32_GRID_VALUES:
        return TRITON_BWD
    if n > sms:
        raise ValueError(f"in_act_bwd.cu: N={n} samples need more blocks than "
                         f"the {sms} SMs hold at once")
    return grid_plan(n, s, c, sms, dtype)


def _tree(vals: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 (a power of two) as the kernel's xor butterfly does:
    adjacent pairs, then pairs of pairs."""
    while vals.shape[0] > 1:
        vals = vals[0::2] + vals[1::2]
    return vals[0]


def instance_norm_act_bwd_blocked_plain(x, g, gamma, beta, mean, rstd,
                                        activation: str = "relu",
                                        sms: int = 132):
    """:func:`instance_norm_act_bwd_plain` organised as ``csrc/in_act_bwd.cu``
    is, in f32: per block range of :func:`plan_in_bwd` for x.dtype (one
    range per sample in its column form; the grid form's where the plan
    keeps an f32 shape on Triton), the partial
    sums of ga and ga * xhat over its voxel range; per (n, c) the partials
    merged in the kernel's order (lane q of a warp sums r = q, q + 32, ... in
    turn, then a butterfly over the 32 lanes; the grid form's merge and the
    cluster form's, block q on lane q, add in that one order); dgamma, dbeta
    summed over n in order. (dx in x.dtype, dgamma f32 (C,), dbeta f32
    (C,))."""
    n, c = x.shape[0], x.shape[-1]
    s = x.numel() // (n * c)
    plan = plan_in_bwd(n, s, c, sms, x.dtype)
    if plan.route != "in_act_bwd.cu":   # an f32 shape the plan keeps on Triton
        plan = grid_plan(n, s, c, sms, x.dtype)
    x3, g3 = x.reshape(n, s, c).float(), g.reshape(n, s, c).float()
    mu, rs = mean.reshape(n, 1, c).float(), rstd.reshape(n, 1, c).float()
    gam, bet = gamma.float(), beta.float()
    xhat = (x3 - mu) * rs
    ga = _act_grad(xhat * gam + bet, g3, activation)
    part = torch.zeros((2, n, plan.bps, c), dtype=torch.float32, device=x.device)
    for r in range(plan.bps):
        v0, v1 = s * r // plan.bps, s * (r + 1) // plan.bps
        part[0, :, r] = ga[:, v0:v1].sum(1)
        part[1, :, r] = (ga * xhat)[:, v0:v1].sum(1)
    lanes = torch.zeros((MERGE_LANES, 2, n, c), dtype=torch.float32,
                        device=x.device)
    for r in range(plan.bps):
        lanes[r % MERGE_LANES] += part[:, :, r]
    tot = _tree(lanes)                                   # (2, n, c)
    dbeta = torch.zeros(c, dtype=torch.float32, device=x.device)
    dgamma = torch.zeros(c, dtype=torch.float32, device=x.device)
    for i in range(n):
        dbeta += tot[0, i]
        dgamma += tot[1, i]
    inv_s = 1.0 / s
    m1, m2 = (tot[0] * inv_s)[:, None], (tot[1] * inv_s)[:, None]
    dx = (gam * rs) * (ga - m1 - xhat * m2)
    return dx.to(x.dtype).reshape(x.shape), dgamma, dbeta


def _check_kernel_input(x: torch.Tensor, activation: str) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; one of {ACTIVATIONS}")
    if x.dim() != 5:
        raise ValueError(f"instance_norm_act: expected NDHWC, got {tuple(x.shape)}")
    check_dtype(x.dtype, "instance_norm_act")


def _affine(x, scale, bias):
    c = x.shape[-1]
    gamma = torch.ones(c, device=x.device) if scale is None else scale
    beta = torch.zeros(c, device=x.device) if bias is None else bias
    return (gamma.to(device=x.device, dtype=torch.float32).contiguous(),
            beta.to(device=x.device, dtype=torch.float32).contiguous())


def _check_partials(part: torch.Tensor, x: torch.Tensor) -> None:
    n, c = x.shape[0], x.shape[-1]
    if (part.dim() != 4 or part.shape[0] != 3 or part.shape[1] != n
            or part.shape[3] != c or part.dtype != torch.float32
            or part.device != x.device):
        raise ValueError(f"instance_norm_act: partials {tuple(part.shape)} "
                         f"{part.dtype} on {part.device} do not fit x "
                         f"{tuple(x.shape)} on {x.device}")


def instance_norm_act_kernel(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    eps: float = 1e-5,
    activation: str = "relu",
    partials: Optional[torch.Tensor] = None,
):
    """Launch the Triton forward on a CUDA NDHWC bf16 or f32 tensor: (y,
    the f32 (N, C) mean, rstd); from the conv's ``partials`` when given
    (merge and apply), else statistics, finalize and apply."""
    _check_kernel_input(x, activation)
    from . import triton_norm

    n, d, h, w, c = x.shape
    x3 = x.contiguous().view(n, d * h * w, c)
    gamma, beta = _affine(x, scale, bias)
    y3 = torch.empty_like(x3)
    with torch.cuda.device(x.device):
        if partials is None:
            mean, rstd = triton_norm.launch(x3, y3, gamma, beta, float(eps),
                                            activation)
        else:
            _check_partials(partials, x)
            mean, rstd = triton_norm.launch_from_partials(
                x3, y3, partials.contiguous(), gamma, beta, float(eps),
                activation)
    _build.count_launch(instance_norm_act, "launches", *f32_counter(x),
                        *(() if partials is None else ("launches_partials",)))
    return y3.view(n, d, h, w, c), mean, rstd


def _bwd_inputs(x, g, gamma, beta, mean, rstd, activation):
    _check_kernel_input(x, activation)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"instance_norm_act_bwd: g {tuple(g.shape)} {g.dtype} "
                         f"vs x {tuple(x.shape)} {x.dtype}")
    n, d, h, w, c = x.shape
    x3 = x.contiguous().view(n, d * h * w, c)
    g3 = g.contiguous().view(n, d * h * w, c)
    f32 = lambda t: t.to(device=x.device, dtype=torch.float32).contiguous()
    return x3, g3, f32(mean), f32(rstd), f32(gamma), f32(beta)


def instance_norm_act_bwd_kernel_triton(x, g, gamma, beta, mean, rstd,
                                        activation: str = "relu"):
    """The Triton backward (partials, merge, dx: three launches) on CUDA
    NDHWC x and g: what :func:`instance_norm_act_bwd_kernel` launches in f32
    and, in bf16, where C is not a multiple of 8."""
    from . import triton_norm

    x3, g3, *consts = _bwd_inputs(x, g, gamma, beta, mean, rstd, activation)
    dx3 = torch.empty_like(x3)
    with torch.cuda.device(x.device):
        dgamma, dbeta = triton_norm.launch_bwd(x3, g3, dx3, *consts, activation)
    _build.count_launch(instance_norm_act_bwd, "launches", *f32_counter(x))
    return dx3.view(x.shape), dgamma, dbeta


def launch_in_act_bwd(plan: InBwdPlan, x3, g3, mean, rstd, gamma, beta,
                      activation: str = "relu", bar=None):
    """``csrc/in_act_bwd.cu`` by ``plan`` on CUDA (N, S, C) x3, g3 (bf16 or
    f32, contiguous, 16-byte aligned) and f32 mean, rstd (N, C), gamma, beta
    (C): (dx3, dgamma, dbeta); counts nothing. ``bar``: the grid form's
    barrier counters; None (the port's calls) makes them anew, zeroed on
    this stream for this launch alone, so no two launches (other streams,
    graph replays) ever share a counter. A launch leaves them at 0
    arrivals, so a caller that orders its launches on one stream may pass one
    pair to all (``chip_smoke.py`` times the zeroing that way). The column
    and cluster forms have no counters."""
    n, s, c = x3.shape
    f32 = x3.dtype == torch.float32
    grid = not (plan.column or plan.cluster)
    dx3 = torch.empty_like(x3)
    # the blocks' partials, then the per-sample sums (the grid form's)
    part = (torch.empty(2 * n * (plan.bps + 1) * c, dtype=torch.float32,
                        device=x3.device) if grid else None)
    dgamma = torch.empty(c, dtype=torch.float32, device=x3.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x3.device)
    ptr = lambda t: t.data_ptr()
    lib = _lib()
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        if bar is None and grid:
            # a fill kernel: a memset node took ~1 us longer a call (PERF.md)
            bar = torch.zeros(2, dtype=torch.int32, device=x3.device)
        if plan.cluster:
            rc = lib.in_act_bwd_cluster_ndhwc_f32(
                *map(ptr, (x3, g3, dx3, mean, rstd, gamma, beta, dgamma, dbeta)),
                s, c, ACT_CODES[activation], plan.bps, plan.width, plan.threads,
                plan.keep, plan.smem, stream)
        elif plan.column:
            fn = (lib.in_act_bwd_column_ndhwc_f32 if f32
                  else lib.in_act_bwd_column_ndhwc_bf16)
            rc = fn(*map(ptr, (x3, g3, dx3, mean, rstd, gamma, beta, dgamma,
                               dbeta)),
                    n, s, c, ACT_CODES[activation], plan.threads, plan.smem,
                    stream)
        else:
            fn = lib.in_act_bwd_ndhwc_f32 if f32 else lib.in_act_bwd_ndhwc_bf16
            rc = fn(*map(ptr, (x3, g3, dx3, mean, rstd, gamma, beta, part,
                               dgamma, dbeta, bar)),
                    n, s, c, ACT_CODES[activation], plan.bps, plan.threads,
                    plan.keep, plan.smem, stream)
    _build.check(rc, "instance_norm_act_bwd (in_act_bwd.cu)")
    return dx3, dgamma, dbeta


def instance_norm_act_bwd_kernel(x, g, gamma, beta, mean, rstd,
                                 activation: str = "relu"):
    """The backward on CUDA NDHWC x and g, by :func:`plan_in_bwd`:
    ``csrc/in_act_bwd.cu`` (one launch) where C fills whole 16-byte vectors
    (bf16 C % 8 == 0, f32 C % 4 == 0); the Triton kernels for other C.
    (dx, dgamma, dbeta)."""
    c = x.shape[-1]
    check_dtype(x.dtype, "instance_norm_act_bwd")
    n, s = x.shape[0], x.numel() // max(1, x.shape[0] * c)
    plan = (TRITON_BWD if c % vector_channels(x.dtype) else
            plan_in_bwd(n, s, c, _build.sm_count(x.device), x.dtype))
    if plan.route == "triton":
        return instance_norm_act_bwd_kernel_triton(x, g, gamma, beta, mean,
                                                   rstd, activation)
    x3, g3, *consts = _bwd_inputs(x, g, gamma, beta, mean, rstd, activation)
    if (x3.data_ptr() | g3.data_ptr()) % 16:
        x3, g3 = x3.clone(), g3.clone()
    dx3, dgamma, dbeta = launch_in_act_bwd(plan, x3, g3, *consts, activation)
    _build.count_launch(instance_norm_act_bwd, "launches", "launches_cuda",
                        *f32_counter(x))
    return dx3.view(x.shape), dgamma, dbeta


def _device_check(x: torch.Tensor, what: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: no kernel for device {x.device}")


def instance_norm_act_bwd(x, g, gamma, beta, mean, rstd, activation="relu"):
    """(dx, dgamma, dbeta): the plain VJP on the CPU, the kernel on CUDA."""
    _device_check(x, "instance_norm_act_bwd")
    if x.device.type == "cpu":
        return instance_norm_act_bwd_plain(x, g, gamma, beta, mean, rstd,
                                           activation)
    return instance_norm_act_bwd_kernel(x, g, gamma, beta, mean, rstd,
                                        activation)


def instance_norm_partials_plain(x: torch.Tensor) -> torch.Tensor:
    """f32 (3, N, 1, C) (count, mean, centred M2) of x over its spatial
    axes: one partial a sample, in the partials format."""
    red = tuple(range(1, x.dim() - 1))
    xf = x.float()
    n, c = x.shape[0], x.shape[-1]
    mean = xf.mean(red)
    m2 = (xf - mean.reshape((n,) + (1,) * (x.dim() - 2) + (c,))).square().sum(red)
    cnt = torch.full_like(mean, float(xf[0, ..., 0].numel()))
    return torch.stack([cnt, mean, m2])[:, :, None, :]


def instance_norm_partials(x: torch.Tensor) -> torch.Tensor:
    """The InstanceNorm partials of x (NDHWC), f32 (3, N, P, C): on a CUDA
    tensor the statistics pass of the Triton forward alone
    (``triton_norm.stats``, counted on
    ``instance_norm_act.launches_shard_stats``), on the CPU its plain
    version. Partials
    of several shards of one volume, concatenated along P, merge into the
    whole volume's statistics (``instance_norm_act(..., partials=)``)."""
    _device_check(x, "instance_norm_partials")
    if x.device.type == "cpu":
        return instance_norm_partials_plain(x)
    _check_kernel_input(x, "none")
    from . import triton_norm

    n, d, h, w, c = x.shape
    with torch.cuda.device(x.device):
        part = triton_norm.stats(x.contiguous().view(n, d * h * w, c))
    _build.count_launch(instance_norm_act, "launches_shard_stats")
    return part


def _in_act_cpu(x, scale, bias, eps, activation, partials):
    if partials is None:
        return _plain_stats(x, scale, bias, eps, activation)
    _check_partials(partials, x)
    mean, rstd = merge_partials_plain(partials, eps)
    return _plain_apply(x, mean, rstd, scale, bias, activation), mean, rstd


def _in_act_cuda(x, scale, bias, eps, activation, partials):
    return instance_norm_act_kernel(x, scale, bias, eps=eps,
                                    activation=activation, partials=partials)


def _in_act_fake(x, scale, bias, eps, activation, partials):
    n, c = x.shape[0], x.shape[-1]
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            x.new_empty((n, c), dtype=torch.float32),
            x.new_empty((n, c), dtype=torch.float32))


# brats_torch::instance_norm_act: (y, f32 (N, C) mean, rstd), from the conv's
# partials when given
instance_norm_act_op = library.define_op(
    "instance_norm_act",
    "(Tensor x, Tensor? scale, Tensor? bias, float eps, str activation, "
    "Tensor? partials) -> (Tensor, Tensor, Tensor)",
    _in_act_cpu, _in_act_cuda, _in_act_fake)


def instance_norm_act_fwd(x, scale, bias, eps, activation, partials):
    """(y, f32 (N, C) mean, rstd): the forward on the route of x's device
    (the kernels on CUDA, the plain version on the CPU), from ``partials``
    when given; ``brats_torch::instance_norm_act``."""
    return instance_norm_act_op(x, scale, bias, float(eps), activation,
                                partials)


class _InstanceNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, activation, partials):
        y, mean, rstd = instance_norm_act_fwd(x, scale, bias, eps, activation,
                                              partials)
        if any(ctx.needs_input_grad[:3]):   # else no backward will run
            gamma, beta = _affine(x, scale, bias)
            ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.activation = activation
        return y

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = instance_norm_act_bwd(
            x, g, gamma, beta, mean, rstd, ctx.activation
        )
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dgamma if need[1] else None,
                dbeta if need[2] else None, None, None, None)


def instance_norm_act(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
    activation: str = "relu",
    partials: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused InstanceNorm3d + activation. NDHWC; stats per (N, C), from the
    conv's ``partials`` when given."""
    _device_check(x, "instance_norm_act")
    return _InstanceNormAct.apply(x, scale, bias, float(eps), activation,
                                  partials)


instance_norm_act.launches = 0
instance_norm_act.launches_partials = 0
instance_norm_act.launches_shard_stats = 0
instance_norm_act_bwd.launches = 0
instance_norm_act_bwd.launches_cuda = 0
instance_norm_act.launches_f32 = 0
instance_norm_act_bwd.launches_f32 = 0
