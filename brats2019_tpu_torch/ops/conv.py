"""The 3^3 SAME conv seam (reference: ``brats2019_tpu/ops/pallas_conv.py``
conv3d_pallas and the flax/XLA conv of ``models/blocks.py:35-43``).

``conv3d(x, w)`` takes NDHWC ``x`` (N, D, H, W, Ci) and a DHWIO kernel
``w`` (3, 3, 3, Ci, Co), and returns (N, D, H, W, Co) in ``x.dtype``:

* on a CPU tensor, the plain version :func:`conv3d_plain` (f32 math);
* on a CUDA tensor, a hand-written kernel, or an error. There is no
  fallback. :func:`plan_conv` picks the instance from the dtype and the
  shape (and the device's SM count) alone. bf16 (bf16 in, f32 accumulation,
  bf16 out): ``csrc/conv3d_wgmma.cu`` (wgmma on a box of voxels whose halo
  patch sits in shared memory) where Ci % 16 == 0 and Co % 8 == 0, else
  ``csrc/conv3d.cu`` (mma.sync implicit GEMM, any Ci, Co). f32 (the
  configurations whose compute dtype is float32, as the JAX package computes
  them): the FFMA instance of ``csrc/conv3d.cu`` (f32 in, f32 accumulation,
  f32 out; no tensor cores, no TF32; a box of voxels whose halo patch and
  weight slab sit in shared memory, a Co tile sized to Co,
  :func:`f32_plan`). Any other dtype raises TypeError.

It is an ``autograd.Function``. ``conv3d_pallas`` has no VJP in the JAX
package (its gradient was XLA's), so the port builds one:

* dgrad: for a SAME stride-1 3^3 conv the input gradient is exactly the
  same conv of the output gradient with the spatially flipped,
  Ci<->Co-transposed weight (:func:`dgrad_weight`). It runs through
  :func:`conv3d` itself, so on CUDA it is the hand-written kernel and counts
  in ``conv3d.launches``; it is skipped where the input needs no grad (the
  stem's input).
* wgrad: the operator ``brats_torch::conv3d_wgrad`` (x, gy, w) over
  ``aten.convolution_backward`` with only the weight mask, as the JAX
  package computed it outside any Pallas kernel. On CUDA it runs on the
  operands in their dtype (cuDNN, f32 accumulation) with TF32 off and
  deterministic algorithms; on the CPU in f32. The operator is the seam a
  profiler trace selects the wgrad calls by.

``conv3d(x, w, stats=True)`` returns ``(y, partials)``: on the bf16 wgmma
instance and on the f32 FFMA instance ``partials`` is the f32 (3, N, boxes,
Co) InstanceNorm statistics of y, (count, mean, centred M2) per box of the
plan and output channel, written by the kernel's STATS epilogue
(``ops/norm.py`` merges them, so the norm after the conv reads y once); on a
CPU tensor whose shape the planner gives one of those two instances in its
dtype, :func:`conv_stats_plain` of the plain output, box by box as the
kernel folds it; on every other route (the bf16 ``csrc/conv3d.cu`` mma.sync
instance, the Winograd backend) None, and the norm takes its own
statistics. The partials are not differentiable.

``conv3d.launches`` counts kernel launches of every instance,
``conv3d.launches_wgmma`` those of the wgmma instance,
``conv3d.launches_stats`` those with a STATS epilogue (either instance),
``conv3d.launches_f32`` those of the f32 FFMA instance.
:func:`conv3d_boxed_plain` is plain torch organised as the wgmma kernel is
(boxes, zero-filled halo patches, channel chunks, tap-shifted views, masked
tails), so its index arithmetic is tested on the CPU.

Two backends sit behind the seam (the pattern of the reference's
``ops/norm.py`` ``set_backend``): ``"direct"`` (the two sources above, the
default) and ``"winograd"`` (``ops/winograd.py``, ``csrc/winograd3d_wgmma.cu`` and
``csrc/winograd3d.cu``; even D, H, W only, launches counted in ``conv3d_winograd.launches``). The backward
is shared: dgrad goes through whichever backend is set, wgrad is plain torch.

The forward routes are ``torch.library`` operators (``ops/library.py``):
``brats_torch::conv3d`` (y), ``brats_torch::conv3d_stats`` (y, partials),
called only where the instance has the STATS epilogue (an operator cannot
return None), and ``brats_torch::conv3d_winograd``. The seam picks the
operator from the backend, dtype and shape; the dispatcher picks the plain
version or the kernel from the device, so an exported program
(``infer/export_hlo.py``) records the backend set when it was traced.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from . import _build, library, winograd

_BACKENDS = ("direct", "winograd")
_backend = "direct"


def set_backend(name: str) -> None:
    """Choose the conv kernel for the whole process: "direct" or "winograd"."""
    global _backend
    if name not in _BACKENDS:
        raise ValueError(f"conv backend must be one of {_BACKENDS}, got {name!r}")
    _backend = name


def get_backend() -> str:
    return _backend


_SIG = {
    "conv3d_ndhwc_bf16": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "conv3d_ndhwc_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "conv3d_stats_ndhwc_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "conv3d_f32_smem_bytes": [ctypes.c_int] * 3,
    "conv3d_f32_blocks_per_sm": [ctypes.c_int] * 3,
    "conv3d_f32_prepare": [],
}
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_SIG_WGMMA = {
    "conv3d_wgmma_ndhwc_bf16": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "conv3d_wgmma_smem_bytes": [ctypes.c_int] * 2,
    "conv3d_wgmma_stats_ndhwc_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "conv3d_wgmma_stats_smem_bytes": [ctypes.c_int] * 2,
}


def _lib() -> ctypes.CDLL:
    return _build.load_library("conv3d", ["conv3d.cu"], _SIG,
                               prepare="conv3d_f32_prepare")


def _lib_wgmma() -> ctypes.CDLL:
    return _build.load_library("conv3d_wgmma", ["conv3d_wgmma.cu"], _SIG_WGMMA)


# ------------------------------------------------------------- the planner --

SMEM_LIMIT = 232_448      # dynamic shared memory a block may ask for (H100)
SM_COUNT = 132            # an H100's SMs: what a plan made off the card assumes
BOX_HW = 8                # the wgmma kernel's box extent along h and w
CHUNK = 64                # its channel chunk
B_STAGES, PATCH_STAGES = 4, 2


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How one conv call runs on the card: a pure function of its shape."""

    instance: str          # "wgmma" (conv3d_wgmma.cu), "mma_sync" or "ffma_f32" (conv3d.cu)
    box: tuple             # (bd, bh, bw) voxels of an M tile; mma_sync (rows,)
    bn: int                # output channels per block (ffma_f32: the Co tile)
    chunk: int             # input channels per K chunk (ffma_f32: a slab of Ci)
    stages: int            # weight slabs (wgmma) / (A, B) chunk pairs in the ring
    smem_bytes: int
    boxes: tuple           # M tiles per axis (nbd, nbh, nbw) per sample; mma_sync: (tiles,)
    n_tiles: int           # Co tiles
    grid: int              # output tiles
    blocks: int            # thread blocks (wgmma: persistent, at most one per SM, walk the tiles)
    flop_per_filled_byte: float   # the call's flops over bytes filled into shared memory


def wgmma_smem_bytes(bd: int, bn: int, stats: bool = False) -> int:
    """Dynamic shared memory of the (bd, bn) instance, with the STATS
    epilogue's scratch (a row of column sums per consumer warp and the box
    means) if ``stats``; the same arithmetic as ``smem_bytes`` in
    csrc/conv3d_wgmma.cu."""
    nvox = (bd + 2) * (BOX_HW + 2) * (BOX_HW + 2)
    patch = (CHUNK // 8) * (nvox + 1) * 16
    slab = (bn // 64) * CHUNK * 128
    return (1024 + B_STAGES * slab + PATCH_STAGES * patch
            + 8 * (2 * B_STAGES + 2 * PATCH_STAGES)
            + (9 * bn * 4 if stats else 0))


# The wgmma kernel's instances: (box depth, Co tile, one tile's time relative
# to (4, 64)). The weights are read from ``tools/torch_conv_check.py --time``
# on an H100, which also prints how far the planner's choice is from the
# fastest instance at every flagship shape: the 128-row box refetches the
# weight twice as often, the 128-wide tile shares one A read between two
# 64-channel products. (2, 64) is there for the levels whose 256-row tiles
# would leave most SMs idle. On a tie the earlier entry wins.
_INSTANCE_COST = ((4, 128, 1.45), (4, 64, 1.0), (2, 64, 0.75))
WGMMA_INSTANCES = tuple((bd, bn) for bd, bn, _ in _INSTANCE_COST)


def check_dtype(dtype: torch.dtype, what: str) -> None:
    """bf16 and f32 have kernels; any other dtype raises TypeError."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what}: the kernels take bf16 or f32, not {dtype}")


def f32_counter(t: torch.Tensor) -> tuple:
    """The f32 route's counter name, for a launch on ``t`` (none in bf16)."""
    return ("launches_f32",) if t.dtype == torch.float32 else ()


@functools.lru_cache(maxsize=4096)   # a process sees a few dozen shapes
def plan_conv(n: int, d: int, h: int, w: int, ci: int, co: int,
              sms: int = SM_COUNT, dtype: torch.dtype = torch.bfloat16
              ) -> ConvPlan:
    """The instance, tile and grid for a (n, d, h, w, ci) -> co conv in
    ``dtype`` on a device of ``sms`` SMs."""
    check_dtype(dtype, "conv3d")
    flops = 2.0 * 27 * ci * co * n * d * h * w
    if dtype == torch.float32:
        return f32_plan(n, d, h, w, ci, co, sms)
    if ci % 16 or co % 8:
        tiles = -(-(n * d * h * w) // 128)
        n_tiles = -(-co // 64)
        filled = tiles * n_tiles * 27 * -(-ci // 32) * (128 + 64) * 32 * 2
        return ConvPlan("mma_sync", (128,), 64, 32, 2, 128 * 68 * 4, (tiles,),
                        n_tiles, tiles * n_tiles, tiles * n_tiles, flops / filled)
    # One block per SM walks the tiles, so a call costs about (tiles per SM,
    # rounded up) x one tile's time.
    best = None
    for bd, bn, weight in _INSTANCE_COST:
        if bn == 128 and co <= 64:
            continue
        plan = wgmma_plan(n, d, h, w, ci, co, bd, bn, sms)
        cost = -(-plan.grid // plan.blocks) * weight
        if best is None or cost < best[0]:
            best = (cost, plan)
    return best[1]


# The f32 FFMA instance of csrc/conv3d.cu: a box of BD x 8 x 8 voxels, a Co
# tile sized to Co, Ci in slabs of a multiple of 4 channels; a thread holds 4
# w voxels x 8 channels (4 where the Co tile is not a multiple of 8).
F32_BOX_HW = 8
F32_BOX_DEPTHS = (8, 4, 2)
F32_MAX_CO_TILE = 64
F32_MAX_THREADS = 512
F32_SMEM_PER_THREAD = 384   # the slab's budget: bytes of shared memory a thread


def f32_co_tile(co: int) -> int:
    """The f32 instance's Co tile: Co (rounded up to 4) where it is at most
    64, else the tiles of at most 64 that cover Co with the least padding."""
    per = -(-co // -(-co // F32_MAX_CO_TILE))
    return -(-per // 4) * 4


def f32_threads(bd: int, co_tile: int) -> int:
    """Threads of a block: 16 per box depth (8 h-rows x 2 w-quads of 4
    voxels) for each group of 8 (or 4) channels of the Co tile."""
    return 16 * bd * co_tile // (8 if co_tile % 8 == 0 else 4)


def f32_smem_bytes(bd: int, co_tile: int, slab: int) -> int:
    """Dynamic shared memory of the f32 instance: the (bd+2) x 10 x 10 halo
    patch of a slab (a row of 10 voxels padded to an odd number of 16-byte
    units) and the 27 x slab x co_tile weight slab; the same arithmetic as
    ``conv3d_f32_smem_bytes`` in csrc/conv3d.cu."""
    row = 4 * ((F32_BOX_HW + 2) * slab // 4 | 1)
    return 4 * ((bd + 2) * (F32_BOX_HW + 2) * row + 27 * slab * co_tile)


def f32_plan(n: int, d: int, h: int, w: int, ci: int, co: int,
             sms: int = SM_COUNT, bd: int | None = None) -> ConvPlan:
    """The plan of the f32 instance at this shape: the deepest box that still
    gives every SM a block (else the shallowest), the Co tile of
    :func:`f32_co_tile` (halved while the grid has fewer blocks than SMs and
    the halves stay multiples of 4 that divide it), and the widest slab of Ci
    (a multiple of 4, in slabs of equal width) whose patch and weights fit
    ``F32_SMEM_PER_THREAD`` bytes a thread (at least 128 threads' worth).
    ``bd`` forces the box depth."""
    ct = f32_co_tile(co)
    cip = -(-ci // 4) * 4

    def grid_of(depth, tile):
        return (n * -(-d // depth) * -(-h // F32_BOX_HW) * -(-w // F32_BOX_HW)
                * -(-co // tile))

    if bd is None:
        fit = [b for b in F32_BOX_DEPTHS if f32_threads(b, ct) <= F32_MAX_THREADS]
        bd = next((b for b in fit if grid_of(b, ct) >= sms), fit[-1])
        while grid_of(bd, ct) < sms and ct % 8 == 0:
            ct //= 2
    n_tiles = -(-co // ct)
    if bd not in F32_BOX_DEPTHS or f32_threads(bd, ct) > F32_MAX_THREADS:
        raise ValueError(f"no f32 instance for box depth {bd}, Co tile {ct}")
    budget = min(SMEM_LIMIT, F32_SMEM_PER_THREAD * max(128, f32_threads(bd, ct)))
    slab = cip
    while slab > 4 and f32_smem_bytes(bd, ct, slab) > budget:
        slab -= 4
    n_slabs = -(-cip // slab)
    slab = -(-cip // n_slabs // 4) * 4
    grid = grid_of(bd, ct)
    patch = (bd + 2) * (F32_BOX_HW + 2) ** 2 * slab
    filled = grid * n_slabs * (patch + 27 * slab * ct) * 4
    return ConvPlan("ffma_f32", (bd, F32_BOX_HW, F32_BOX_HW), ct, slab, 1,
                    f32_smem_bytes(bd, ct, slab),
                    (-(-d // bd), -(-h // F32_BOX_HW), -(-w // F32_BOX_HW)),
                    n_tiles, grid, grid,
                    2.0 * 27 * ci * co * n * d * h * w / filled)


def wgmma_plan(n: int, d: int, h: int, w: int, ci: int, co: int,
               bd: int, bn: int, sms: int = SM_COUNT) -> ConvPlan:
    """The plan of the wgmma kernel's (bd, bn) instance at this shape
    (:func:`plan_conv` chooses bd and bn)."""
    if ci % 16 or co % 8 or (bd, bn) not in WGMMA_INSTANCES or sms < 1:
        raise ValueError(f"no wgmma instance for Ci {ci}, Co {co}, box depth "
                         f"{bd}, Co tile {bn}")
    n_tiles = -(-co // bn)
    nbd, nbh, nbw = -(-d // bd), -(-h // BOX_HW), -(-w // BOX_HW)
    grid = n * nbd * nbh * nbw * n_tiles
    nvox = (bd + 2) * (BOX_HW + 2) * (BOX_HW + 2)
    # a weight slab is 64 K rows: one tap of a chunk, or 64 // ci whole taps
    slabs = -(-ci // CHUNK) * -(-27 // (CHUNK // ci if CHUNK % ci == 0 else 1))
    filled = grid * (nvox * ci * 2 + slabs * CHUNK * bn * 2)
    return ConvPlan("wgmma", (bd, BOX_HW, BOX_HW), bn, CHUNK, B_STAGES,
                    wgmma_smem_bytes(bd, bn), (nbd, nbh, nbw), n_tiles, grid,
                    min(grid, sms),
                    2.0 * 27 * ci * co * n * d * h * w / filled)


def conv3d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3^3 conv in f32 on x's values, cast back to x.dtype."""
    xc = x.float().permute(0, 4, 1, 2, 3)            # NCDHW view of NDHWC
    wc = w.float().permute(4, 3, 0, 1, 2)            # DHWIO -> OIDHW
    y = F.conv3d(xc, wc, padding=1)
    return y.permute(0, 2, 3, 4, 1).contiguous().to(x.dtype)


def conv3d_boxed_plain(x: torch.Tensor, w: torch.Tensor,
                       plan: ConvPlan) -> torch.Tensor:
    """The conv in plain torch, organised as csrc/conv3d_wgmma.cu is: per
    sample and box a zero-filled halo patch, per Co tile an f32 accumulator
    summed over (channel chunk, tap) from tap-shifted views of the patch
    against the zero-padded weight slab, then a store masked to the volume
    and to Co. f32 math on x's values, cast back to x.dtype."""
    if plan.instance != "wgmma":
        raise ValueError("conv3d_boxed_plain follows the wgmma instance's plan")
    n, d, h, wd, ci = x.shape
    co = w.shape[4]
    bd, bh, bw = plan.box
    nbd, nbh, nbw = plan.boxes
    bn, ck = plan.bn, plan.chunk
    xf, wf = x.float(), w.float()
    y = torch.zeros((n, d, h, wd, co), dtype=torch.float32, device=x.device)
    for s in range(n):
        for d0 in range(0, nbd * bd, bd):
            for h0 in range(0, nbh * bh, bh):
                for w0 in range(0, nbw * bw, bw):
                    # patch voxel (a, b, c) is volume voxel (d0-1+a, h0-1+b, w0-1+c)
                    patch = xf.new_zeros((bd + 2, bh + 2, bw + 2, ci))
                    lo = [max(0, v - 1) for v in (d0, h0, w0)]
                    hi = [min(lim, v + e + 1) for lim, v, e in
                          ((d, d0, bd), (h, h0, bh), (wd, w0, bw))]
                    patch[lo[0] - d0 + 1:hi[0] - d0 + 1,
                          lo[1] - h0 + 1:hi[1] - h0 + 1,
                          lo[2] - w0 + 1:hi[2] - w0 + 1] = xf[
                              s, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
                    vd, vh, vw = min(bd, d - d0), min(bh, h - h0), min(bw, wd - w0)
                    for n0 in range(0, plan.n_tiles * bn, bn):
                        vn = min(bn, co - n0)
                        acc = xf.new_zeros((bd * bh * bw, bn))
                        for c0 in range(0, ci, ck):
                            kc = min(ck, ci - c0)
                            for tap in range(27):
                                kd, kh, kw = tap // 9, (tap // 3) % 3, tap % 3
                                a = patch[kd:kd + bd, kh:kh + bh, kw:kw + bw,
                                          c0:c0 + kc].reshape(-1, kc)
                                slab = xf.new_zeros((kc, bn))
                                slab[:, :vn] = wf[kd, kh, kw, c0:c0 + kc, n0:n0 + vn]
                                acc += a @ slab
                        y[s, d0:d0 + vd, h0:h0 + vh, w0:w0 + vw, n0:n0 + vn] = (
                            acc.view(bd, bh, bw, bn)[:vd, :vh, :vw, :vn])
    return y.to(x.dtype)


STATS_INSTANCES = ("wgmma", "ffma_f32")   # the instances with a STATS epilogue


def conv_stats_plain(y: torch.Tensor, plan: ConvPlan) -> torch.Tensor:
    """The STATS epilogue in plain torch: for each sample, box of ``plan``
    (``plan.box``, ``plan.boxes``, boxes numbered (bd * nbh + bh) * nbw + bw
    as the kernel walks them; the wgmma or the f32 FFMA instance's plan) and
    channel, the count of the box's voxels inside the volume, their mean and
    their centred sum of squares, in f32, of ``y`` as stored (the conv
    output in the compute dtype). Returns (3, N, boxes, C)."""
    if plan.instance not in STATS_INSTANCES:
        raise ValueError(f"conv_stats_plain follows the plan of an instance "
                         f"with a STATS epilogue {STATS_INSTANCES}, not "
                         f"{plan.instance!r}")
    n, d, h, w, c = y.shape
    bd, bh, bw = plan.box
    nbd, nbh, nbw = plan.boxes
    pad = (0, 0, 0, nbw * bw - w, 0, nbh * bh - h, 0, nbd * bd - d)

    def boxed(t):   # (n, D, H, W, c) -> (n, boxes, voxels of a box, c)
        t = F.pad(t, pad)
        t = t.reshape(t.shape[0], nbd, bd, nbh, bh, nbw, bw, t.shape[-1])
        t = t.permute(0, 1, 3, 5, 2, 4, 6, 7)
        return t.reshape(t.shape[0], nbd * nbh * nbw, bd * bh * bw, t.shape[-1])

    vals = boxed(y.float())
    inside = boxed(torch.ones((1, d, h, w, 1), device=y.device))
    cnt = inside.sum(2)                                   # (1, boxes, 1)
    mean = vals.sum(2) / cnt
    m2 = (((vals - mean[:, :, None]) * inside) ** 2).sum(2)
    return torch.stack([cnt.expand_as(mean), mean, m2])


def _check_kernel_args(x: torch.Tensor, w: torch.Tensor,
                       dtypes=(torch.bfloat16,)) -> None:
    if x.dtype not in dtypes or w.dtype != x.dtype:
        names = " or ".join(str(t).replace("torch.", "") for t in dtypes)
        raise TypeError(f"conv3d kernel takes {names} input and weight of one "
                        f"dtype, got {x.dtype}, {w.dtype}")
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"conv3d: bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if w.shape[3] != x.shape[4]:
        raise ValueError(
            f"conv3d: x has {x.shape[4]} channels, w expects {w.shape[3]}")
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv3d kernel takes x and w on one CUDA device, got "
                         f"{x.device}, {w.device}")
    if x.numel() == 0:
        raise ValueError("conv3d: empty input")


_sm_count = _build.sm_count


def conv3d_kernel_mma_sync(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch csrc/conv3d.cu (any Ci, Co) on CUDA bf16 tensors."""
    _check_kernel_args(x, w)
    return _launch_mma_sync(x, w)


def _launch_mma_sync(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    n, d, h, wd, ci = x.shape
    x = x.contiguous()
    w = w.contiguous()
    co = w.shape[4]
    y = torch.empty((n, d, h, wd, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().conv3d_ndhwc_bf16(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), n, d, h, wd, ci, co, stream
        )
    _build.check(rc, "conv3d")
    _build.count_launch(conv3d)
    return y


def conv3d_kernel_wgmma(x: torch.Tensor, w: torch.Tensor,
                        plan: ConvPlan | None = None, stats: bool = False):
    """Launch csrc/conv3d_wgmma.cu on CUDA bf16 tensors (Ci % 16 == 0,
    Co % 8 == 0), with the shape's own plan unless one is given: y, or with
    ``stats`` the STATS instance's (y, partials)."""
    _check_kernel_args(x, w)
    n, d, h, wd, ci = x.shape
    co = w.shape[4]
    if plan is None:
        plan = plan_conv(n, d, h, wd, ci, co, _sm_count(x.device))
    if plan.instance != "wgmma":
        raise ValueError(
            f"conv3d: the wgmma kernel takes Ci % 16 == 0 and Co % 8 == 0, "
            f"got Ci {ci}, Co {co}")
    return _launch_wgmma(x, w, plan, stats)


def _launch_wgmma(x: torch.Tensor, w: torch.Tensor, plan: ConvPlan,
                  stats: bool = False):
    n, d, h, wd, ci = x.shape
    co = w.shape[4]
    x = x.contiguous()
    w = w.contiguous()
    y = torch.empty((n, d, h, wd, co), dtype=x.dtype, device=x.device)
    part = None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if stats:
            part = torch.empty((3, n, math.prod(plan.boxes), co),
                               dtype=torch.float32, device=x.device)
            rc = _lib_wgmma().conv3d_wgmma_stats_ndhwc_bf16(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(), n, d,
                h, wd, ci, co, plan.box[0], plan.bn, plan.blocks, stream
            )
        else:
            rc = _lib_wgmma().conv3d_wgmma_ndhwc_bf16(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), n, d, h, wd, ci, co,
                plan.box[0], plan.bn, plan.blocks, stream
            )
    _build.check(rc, "conv3d (wgmma)")
    _build.count_launch(conv3d, "launches", "launches_wgmma",
                        *(("launches_stats",) if stats else ()))
    return (y, part) if stats else y


def conv3d_kernel_f32(x: torch.Tensor, w: torch.Tensor,
                      plan: ConvPlan | None = None, stats: bool = False):
    """Launch the f32 FFMA instance of csrc/conv3d.cu on CUDA f32 tensors,
    with the shape's own plan unless one is given: y, or with ``stats`` the
    STATS instance's (y, partials)."""
    _check_kernel_args(x, w, (torch.float32,))
    n, d, h, wd, ci = x.shape
    x = x.contiguous()
    w = w.contiguous()
    co = w.shape[4]
    if plan is None:
        plan = plan_conv(n, d, h, wd, ci, co, _sm_count(x.device), x.dtype)
    y = torch.empty((n, d, h, wd, co), dtype=x.dtype, device=x.device)
    part = None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (n, d, h, wd, ci, co, plan.box[0], plan.bn, plan.chunk, stream)
        if stats:
            part = torch.empty((3, n, math.prod(plan.boxes), co),
                               dtype=torch.float32, device=x.device)
            rc = _lib().conv3d_stats_ndhwc_f32(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(), *args)
        else:
            rc = _lib().conv3d_ndhwc_f32(x.data_ptr(), w.data_ptr(),
                                         y.data_ptr(), *args)
    _build.check(rc, "conv3d (f32)")
    _build.count_launch(conv3d, "launches", "launches_f32",
                        *(("launches_stats",) if stats else ()))
    return (y, part) if stats else y


def conv3d_kernel(x: torch.Tensor, w: torch.Tensor, stats: bool = False):
    """Launch the instance :func:`plan_conv` names for this dtype and
    shape: y, or with ``stats`` (y, partials), partials None on the bf16
    mma.sync instance."""
    _check_kernel_args(x, w, KERNEL_DTYPES)
    plan = plan_conv(*x.shape, w.shape[4], _sm_count(x.device), x.dtype)
    if plan.instance == "wgmma":
        return _launch_wgmma(x, w, plan, stats)
    if plan.instance == "ffma_f32":
        return conv3d_kernel_f32(x, w, plan, stats)
    y = _launch_mma_sync(x, w)
    return (y, None) if stats else y


def _stats_route(x: torch.Tensor, co: int) -> bool:
    """Whether the direct conv's instance for x's dtype and shape has a STATS
    epilogue (the instance :func:`plan_conv` names does not depend on the SM
    count)."""
    return (x.dim() == 5 and x.dtype in KERNEL_DTYPES
            and plan_conv(*x.shape, co, dtype=x.dtype).instance in STATS_INSTANCES)


def _conv3d_stats_cpu(x: torch.Tensor, w: torch.Tensor):
    # by the plan of x's dtype: the boxes the card's instance folds
    y = conv3d_plain(x, w)
    return y, conv_stats_plain(y, plan_conv(*x.shape, w.shape[4], dtype=x.dtype))


def _conv3d_stats_cuda(x: torch.Tensor, w: torch.Tensor):
    y, part = conv3d_kernel(x, w, stats=True)
    if part is None:
        raise ValueError(f"conv3d_stats: the instance for {tuple(x.shape)} -> "
                         f"{w.shape[4]} {x.dtype} has no STATS epilogue")
    return y, part


def _conv3d_fake(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.new_empty(tuple(x.shape[:4]) + (w.shape[4],))


def _conv3d_stats_fake(x: torch.Tensor, w: torch.Tensor):
    sms = _sm_count(x.device) if x.device.type == "cuda" else SM_COUNT
    plan = plan_conv(*x.shape, w.shape[4], sms, x.dtype)
    part = x.new_empty((3, x.shape[0], math.prod(plan.boxes), w.shape[4]),
                       dtype=torch.float32)
    return _conv3d_fake(x, w), part


# brats_torch::conv3d (y) and brats_torch::conv3d_stats (y, partials), the
# latter only where the instance has the STATS epilogue (an operator cannot
# return None)
conv3d_op = library.define_op(
    "conv3d", "(Tensor x, Tensor w) -> Tensor",
    conv3d_plain, conv3d_kernel, _conv3d_fake)
conv3d_stats_op = library.define_op(
    "conv3d_stats", "(Tensor x, Tensor w) -> (Tensor, Tensor)",
    _conv3d_stats_cpu, _conv3d_stats_cuda, _conv3d_stats_fake)


def _conv3d_fwd(x: torch.Tensor, w: torch.Tensor, stats: bool = False):
    """y, or with ``stats`` (y, partials or None) by the route the module
    docstring gives, through the backend's operator."""
    if _backend == "winograd":
        y = winograd.conv3d_winograd_op(x, w)
        return (y, None) if stats else y
    if not stats:
        return conv3d_op(x, w)
    if not _stats_route(x, w.shape[4]):
        return conv3d_op(x, w), None
    return conv3d_stats_op(x, w)


def dgrad_weight(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Ci, Co) -> (3, 3, 3, Co, Ci): w_t[t, co, ci] = w[2-t, ci, co]."""
    return w.flip(0, 1, 2).transpose(3, 4).contiguous()


def _wgrad(x: torch.Tensor, gy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dL/dw (DHWIO, the operands' dtype) of the SAME 3^3 conv for input x
    and output gradient gy (both NDHWC)."""
    xc = x.permute(0, 4, 1, 2, 3)
    gc = gy.permute(0, 4, 1, 2, 3)
    wc = w.permute(4, 3, 0, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        _, dw, _ = torch.ops.aten.convolution_backward(
            gc, xc, wc, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False,
            [0, 0, 0], 1, [False, True, False],
        )
    return dw.permute(2, 3, 4, 1, 0)


# brats_torch::conv3d_wgrad (x, gy, w) -> dw in w.dtype: f32 math on the
# CPU, cuDNN on the operands in their dtype on CUDA
conv3d_wgrad = library.define_op(
    "conv3d_wgrad", "(Tensor x, Tensor gy, Tensor w) -> Tensor",
    lambda x, gy, w: _wgrad(x.float(), gy.float(), w.float()).to(w.dtype),
    lambda x, gy, w: _wgrad(x, gy, w).to(w.dtype),
    lambda x, gy, w: w.new_empty(w.shape))


class _Conv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stats):
        ctx.save_for_backward(x, w)
        if not stats:
            return _conv3d_fwd(x, w)
        y, part = _conv3d_fwd(x, w, True)
        if part is not None:
            ctx.mark_non_differentiable(part)
        return y, part

    @staticmethod
    def backward(ctx, gy, *_g_part):
        x, w = ctx.saved_tensors
        gy = gy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _conv3d_fwd(gy, dgrad_weight(w))
        if ctx.needs_input_grad[1]:
            dw = conv3d_wgrad(x, gy, w)
        return dx, dw, None


def conv3d(x: torch.Tensor, w: torch.Tensor, *, stats: bool = False):
    """y, or with ``stats`` (y, partials or None): see the module docstring."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"conv3d: no kernel for device {x.device}")
    return _Conv3d.apply(x, w, stats)


conv3d.launches = 0
conv3d.launches_wgmma = 0
conv3d.launches_stats = 0
conv3d.launches_f32 = 0
