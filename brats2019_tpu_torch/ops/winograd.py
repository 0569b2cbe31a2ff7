"""Winograd F(2x2x2, 3x3x3) conv3d (reference:
``brats2019_tpu/ops/pallas_winograd.py`` conv3d_winograd): the second
backend of the 3^3 SAME conv seam (``ops/conv.py`` ``set_backend``).

``conv3d_winograd(x, w)`` takes NDHWC ``x`` (N, D, H, W, Ci) with even D, H,
W and a DHWIO kernel ``w`` (3, 3, 3, Ci, Co), and returns (N, D, H, W, Co) in
``x.dtype``:

* on a CPU tensor, the plain version :func:`conv3d_winograd_plain`: the same
  decomposition step by step in f32 (U = (G x G x G) g, V = B^T d B on the
  unfolded 4^3 tiles, 64 per-point matmuls, A^T);
* on a CUDA tensor, a hand-written kernel, or an error. There is no
  fallback, and odd D/H/W raise as in the reference. :func:`plan_winograd`
  picks the instance from the dtype and the shape (and the device's SM
  count) alone. bf16 (bf16 in, f32 accumulation, bf16 out):
  ``csrc/winograd3d_wgmma.cu`` (wgmma on bricks of 4^3 tiles, V made in
  packed bf16 by a transformer warpgroup, U by TMA) where Ci % 16 == 0 and
  Co % 8 == 0, else ``csrc/winograd3d.cu`` (mma.sync, V made in f32 and
  rounded to bf16 once; any Ci, Co). f32 (the configurations whose compute
  dtype is float32; the reference computes in the dtype it is given): the
  FFMA instance of ``csrc/winograd3d.cu`` (f32 U and V, f32 products on the
  CUDA cores, f32 out; no tensor cores, no TF32; a Co tile sized to Co, U and
  V in shared memory, A^T once per point: :func:`f32_chunk`). Any other
  dtype raises TypeError.

The weight transform runs outside the kernel in the reference (an XLA
einsum) and here (a torch einsum); its zero-padded result, in the input's
dtype, is cached per weight tensor and version, so a served model
transforms each kernel once. ``conv3d_winograd.launches`` counts kernel
launches of every instance, ``conv3d_winograd.launches_wgmma`` those of the
wgmma instance, ``conv3d_winograd.launches_f32`` those of the f32 one.
:func:`conv3d_winograd_bricked_plain` is plain torch organised as the wgmma
kernel is (bricks, zero-filled raw patches, channel chunks against the padded
U, groups of four w-points folded in place, masked ragged tiles), so its index
arithmetic is tested on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading
import weakref

import torch
import torch.nn.functional as F

from . import _build, library

# F(2,3) matrices (Lavin & Gray 2016), exact in binary floating point
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))

_SIG = {
    "winograd3d_ndhwc_bf16": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "winograd3d_ndhwc_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
    "winograd3d_f32_smem_bytes": [ctypes.c_int] * 3,
    "winograd3d_f32_prepare": [],
}
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_SIG_WGMMA = {
    "winograd3d_wgmma_ndhwc_bf16": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "winograd3d_wgmma_smem_bytes": [],
}
# the bf16 kernels' channel chunk and Co block: U is zero-padded to
# multiples (the f32 instance pads Ci to 4 and Co to its Co tile)
_CI_PAD, _CO_PAD = 32, 64
_CI_PAD_F32 = 4

_u_cache: dict = {}
_u_lock = threading.Lock()
_g_cache: dict = {}


def _lib() -> ctypes.CDLL:
    return _build.load_library("winograd3d", ["winograd3d.cu"], _SIG,
                               prepare="winograd3d_f32_prepare")


def _lib_wgmma() -> ctypes.CDLL:
    return _build.load_library("winograd3d_wgmma", ["winograd3d_wgmma.cu"],
                               _SIG_WGMMA)


# ------------------------------------------------------------- the planner --

SMEM_LIMIT = 232_448      # dynamic shared memory a block may ask for (H100)
SM_COUNT = 132            # an H100's SMs: what a plan made off the card assumes
BRICK = 4                 # the wgmma kernel's brick: 4 tiles along d, h and w
GROUP = 4                 # points a product step: the 4 w-points of a (d, h) point
U_STAGES, V_STAGES, RAW_STAGES = 3, 3, 2   # U slabs, V buffers, raw patch buffers


@dataclasses.dataclass(frozen=True)
class WinogradPlan:
    """How one Winograd conv call runs on the card: a pure function of its
    shape."""

    instance: str          # "wgmma" (winograd3d_wgmma.cu), "mma_sync" or "ffma_f32" (winograd3d.cu)
    brick: tuple           # tiles of a block along d, h, w
    bn: int                # output channels per block
    chunk: int             # input channels per K chunk
    smem_bytes: int
    bricks: tuple          # bricks per axis (nbd, nbh, nbw) per sample
    n_tiles: int           # Co tiles
    grid: int              # (brick, Co tile) pairs
    blocks: int            # thread blocks (wgmma: persistent, at most one per SM)
    fill: float            # share of the bricks' tile slots that hold a real tile
    raw_channels: int = 0  # ffma_f32: channels its raw patch holds (Ci padded, or a chunk)


def wgmma_smem_bytes() -> int:
    """Dynamic shared memory of the wgmma instance; the same arithmetic as
    ``SMEM_BYTES`` in csrc/winograd3d_wgmma.cu."""
    pieces = _CI_PAD // 8
    raw = pieces * ((2 * BRICK + 2) ** 3 + 1) * 16
    v = GROUP * pieces * (BRICK ** 3 * 16 + 64)
    u = GROUP * _CI_PAD * _CO_PAD * 2
    return (1024 + U_STAGES * u + RAW_STAGES * raw + V_STAGES * v
            + 8 * (2 * (U_STAGES + V_STAGES + RAW_STAGES) + 1))


def instance_plan(instance: str, n: int, d: int, h: int, w: int, ci: int,
                  co: int, sms: int = SM_COUNT) -> WinogradPlan:
    """The plan of the named instance at this shape (:func:`plan_winograd`
    chooses the instance)."""
    chunk, bn = _CI_PAD, _CO_PAD
    if instance == "wgmma":
        if ci % 16 or co % 8:
            raise ValueError(f"no wgmma instance for Ci {ci}, Co {co}")
        brick, smem = (BRICK,) * 3, wgmma_smem_bytes()
    elif instance == "mma_sync":
        # a 2 x 4 x 4 brick: its 6 x 10 x 10 raw patch and 16 points of V
        brick, smem = (2, 4, 4), (600 + 16 * 32) * (_CI_PAD + 8) * 2
    elif instance == "ffma_f32":
        # the same brick in f32, a Co tile sized to Co, Ci in chunks of V
        # and U (the raw patch holds all of Ci, or a chunk)
        cip = -(-ci // _CI_PAD_F32) * _CI_PAD_F32
        bn = f32_co_tile(co)
        raw, chunk = f32_chunk(cip, bn)
        brick, smem = (2, 4, 4), f32_smem_bytes(raw, bn, chunk)
    else:
        raise ValueError(f"unknown Winograd instance {instance!r}")
    tiles = (d // 2, h // 2, w // 2)
    n_tiles = -(-co // bn)
    bricks = tuple(-(-t // b) for t, b in zip(tiles, brick))
    grid = n * math.prod(bricks) * n_tiles
    fill = math.prod(tiles) / (math.prod(bricks) * math.prod(brick))
    blocks = min(grid, sms) if instance == "wgmma" else grid
    return WinogradPlan(instance, brick, bn, chunk, smem, bricks,
                        n_tiles, grid, blocks, fill,
                        raw if instance == "ffma_f32" else 0)


# The f32 FFMA instance of csrc/winograd3d.cu: Co tiles of at most 32
# channels sized to Co; the raw patch of all of Ci, V and U of a chunk of Ci
# and M of a d-point in shared memory.
F32_MAX_CO_TILE = 32
F32_SMEM_TARGET = 113_664   # two blocks an SM, where the raw patch allows


def f32_co_tile(co: int) -> int:
    """The f32 instance's Co tile: Co (rounded up to 4) where it is at most
    32, else the tiles of at most 32 that cover Co with the least padding."""
    per = -(-co // -(-co // F32_MAX_CO_TILE))
    return -(-per // 4) * 4


def f32_threads(co_tile: int) -> int:
    """Threads of an f32 block (the kernel's ``fw_threads``)."""
    return 128 if co_tile <= 8 else 16 * co_tile


def f32_smem_bytes(raw: int, co_tile: int, chunk: int) -> int:
    """Dynamic shared memory of the f32 instance: the 600-voxel raw patch of
    ``raw`` channels (Ci padded, or a chunk) at a pitch of raw + 1 floats, V
    (16 points x chunk x 32 tiles) and U (16 x chunk x co_tile) of a chunk, M
    (16 x 32 x co_tile) of a d-point; the same arithmetic as
    ``fw_smem_bytes`` in csrc/winograd3d.cu."""
    return 4 * (600 * (raw + 1) + 16 * chunk * (32 + co_tile)
                + 16 * 32 * co_tile)


def f32_chunk(ci_pad: int, co_tile: int) -> tuple:
    """(raw channels, chunk) of the f32 instance: the raw patch holds all of
    Ci where it fits beside a chunk, else one chunk at a time (filled again
    for each d-point); the chunk is the widest multiple of 4 (chunks of equal
    width) that keeps the block at ``F32_SMEM_TARGET`` bytes (two blocks an
    SM), or failing that at ``SMEM_LIMIT``."""
    for resident in (True, False):
        for limit in (F32_SMEM_TARGET, SMEM_LIMIT):
            chunk = ci_pad
            size = lambda c: f32_smem_bytes(ci_pad if resident else c, co_tile, c)
            while chunk > 4 and size(chunk) > limit:
                chunk -= 4
            if size(chunk) <= limit:
                chunk = -(-ci_pad // -(-ci_pad // chunk) // 4) * 4
                return (ci_pad if resident else chunk), chunk
    raise ValueError(f"no f32 Winograd instance for Ci {ci_pad}, Co tile {co_tile}")


@functools.lru_cache(maxsize=4096)   # a process sees a few dozen shapes
def plan_winograd(n: int, d: int, h: int, w: int, ci: int, co: int,
                  sms: int = SM_COUNT,
                  dtype: torch.dtype = torch.bfloat16) -> WinogradPlan:
    """The instance, brick and grid for a (n, d, h, w, ci) -> co Winograd conv
    (even d, h, w) in ``dtype`` (bf16 or f32; TypeError for any other) on a
    device of ``sms`` SMs."""
    _check_dtype(dtype)
    if dtype == torch.float32:
        instance = "ffma_f32"
    else:
        instance = "mma_sync" if ci % 16 or co % 8 else "wgmma"
    return instance_plan(instance, n, d, h, w, ci, co, sms)


def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Ci, Co) -> (64, Ci, Co) f32: U[p] = (G x G x G) g."""
    g = _g_cache.get(w.device)
    if g is None:   # kept per device: no host->device copy on later calls
        g = _g_cache[w.device] = torch.tensor(_G, dtype=torch.float32,
                                              device=w.device)
    u = torch.einsum("pa,qb,rc,abcio->pqrio", g, g, g, w.float())
    return u.reshape(64, w.shape[3], w.shape[4])


def _bt_axis(t: torch.Tensor, dim: int) -> torch.Tensor:
    """B^T along ``dim`` (size 4): (t0 - t2, t1 + t2, t2 - t1, t1 - t3)."""
    t0, t1, t2, t3 = t.unbind(dim)
    return torch.stack((t0 - t2, t1 + t2, t2 - t1, t1 - t3), dim)


def _at_axis(m: torch.Tensor, dim: int) -> torch.Tensor:
    """A^T along ``dim`` (size 4 -> 2): (m0 + m1 + m2, m1 - m2 - m3)."""
    m0, m1, m2, m3 = m.unbind(dim)
    return torch.stack((m0 + m1 + m2, m1 - m2 - m3), dim)


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(
            f"conv3d_winograd: bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if w.shape[3] != x.shape[4]:
        raise ValueError(f"conv3d_winograd: x has {x.shape[4]} channels, w "
                         f"expects {w.shape[3]}")
    if any(v % 2 for v in x.shape[1:4]):
        raise ValueError(
            f"conv3d_winograd needs even D, H, W, got {tuple(x.shape[1:4])}")
    if x.numel() == 0:
        raise ValueError("conv3d_winograd: empty input")


def conv3d_winograd_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The decomposition in f32 on x's and w's values, cast back to
    x.dtype (one sample at a time: V is 8x the input)."""
    _check_shapes(x, w)
    _, d, h, wd, ci = x.shape
    co = w.shape[4]
    td, th, tw = d // 2, h // 2, wd // 2
    u = transform_weights(w)
    out = []
    for xs in x.float().split(1):
        xp = F.pad(xs[0], (0, 0, 1, 1, 1, 1, 1, 1))
        # (Td, Th, Tw, Ci, 4, 4, 4): the 4^3 window at 2t-1 .. 2t+2 per axis
        v = xp.unfold(0, 4, 2).unfold(1, 4, 2).unfold(2, 4, 2)
        v = _bt_axis(_bt_axis(_bt_axis(v, 4), 5), 6)
        v = v.permute(4, 5, 6, 0, 1, 2, 3).reshape(64, td * th * tw, ci)
        m = torch.bmm(v, u).reshape(4, 4, 4, td, th, tw, co)
        yt = _at_axis(_at_axis(_at_axis(m, 0), 1), 2)
        out.append(yt.permute(3, 0, 4, 1, 5, 2, 6).reshape(d, h, wd, co))
    return torch.stack(out).to(x.dtype)


def conv3d_winograd_bricked_plain(x: torch.Tensor, w: torch.Tensor,
                                  plan: WinogradPlan) -> torch.Tensor:
    """The conv in plain torch, organised as csrc/winograd3d_wgmma.cu is: per
    sample and brick of 4^3 tiles a zero-filled 10^3 raw patch; per Co tile 8
    output-phase accumulators; per 32-channel chunk (against the zero-padded
    U) and (d-point, h-point) the 4 w-points of V from two planes and two rows
    of the patch, their 4 products, A^T along w in place and the sign-add
    into the phases; then a store masked to the real tiles and to Co. f32 math
    on x's and w's values, cast back to x.dtype."""
    if plan.instance != "wgmma":
        raise ValueError("conv3d_winograd_bricked_plain follows the wgmma "
                         "instance's plan")
    _check_shapes(x, w)
    n, d, h, wd, ci = x.shape
    co = w.shape[4]
    td, th, tw = d // 2, h // 2, wd // 2
    bt = plan.brick[0]
    ck, bn = plan.chunk, plan.bn
    cip = -(-ci // _CI_PAD) * _CI_PAD
    cop = -(-co // _CO_PAD) * _CO_PAD
    u = x.new_zeros((64, cip, cop), dtype=torch.float32)
    u[:, :ci, :co] = transform_weights(w)
    xf = x.float()
    y = torch.zeros((n, d, h, wd, co), dtype=torch.float32, device=x.device)
    bt_pick = ((0, 2, -1.0), (1, 2, 1.0), (2, 1, -1.0), (1, 3, -1.0))
    at = ((1, 1, 1, 0), (0, 1, -1, -1))
    win = torch.arange(bt) * 2       # a tile's window starts at patch voxel 2i
    for s in range(n):
        for td0 in range(0, plan.bricks[0] * bt, bt):
            for th0 in range(0, plan.bricks[1] * bt, bt):
                for tw0 in range(0, plan.bricks[2] * bt, bt):
                    # patch voxel (a, b, c) is volume voxel (2 td0 - 1 + a, ...)
                    o = [2 * t0 - 1 for t0 in (td0, th0, tw0)]
                    pe = 2 * bt + 2
                    patch = xf.new_zeros((pe, pe, pe, cip))
                    lo = [max(0, v) for v in o]
                    hi = [min(lim, v + pe) for lim, v in zip((d, h, wd), o)]
                    patch[lo[0] - o[0]:hi[0] - o[0], lo[1] - o[1]:hi[1] - o[1],
                          lo[2] - o[2]:hi[2] - o[2], :ci] = xf[
                              s, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
                    for n0 in range(0, plan.n_tiles * bn, bn):
                        ph = xf.new_zeros((2, 2, 2, bt ** 3, bn))
                        for c0 in range(0, cip, ck):
                            pc = patch[..., c0:c0 + ck]
                            for p in range(4):
                                a1, a2, sgn_d = bt_pick[p]
                                for q in range(4):
                                    b1, b2, sgn_h = bt_pick[q]
                                    # rows[k][c]: (id, ih, iw, ck) at window voxel c
                                    def comb(b):
                                        r1 = pc[win + a1][:, win + b]
                                        r2 = pc[win + a2][:, win + b]
                                        return r1 + sgn_d * r2
                                    rows = comb(b1) + sgn_h * comb(b2)
                                    hc = [rows[:, :, win + c] for c in range(4)]
                                    vs = (hc[0] - hc[2], hc[1] + hc[2],
                                          hc[2] - hc[1], hc[1] - hc[3])
                                    m = [v.reshape(bt ** 3, ck)
                                         @ u[(p * 4 + q) * 4 + r, c0:c0 + ck,
                                             n0:n0 + bn] for r, v in enumerate(vs)]
                                    m0 = m[0] + m[1] + m[2]
                                    m1 = m[1] - m[2] - m[3]
                                    for sd in range(2):
                                        for sh in range(2):
                                            coef = at[sd][p] * at[sh][q]
                                            if coef:
                                                ph[sd, sh, 0] += coef * m0
                                                ph[sd, sh, 1] += coef * m1
                        vd, vh, vw = (min(bt, t - t0) for t, t0 in
                                      ((td, td0), (th, th0), (tw, tw0)))
                        vn = min(bn, co - n0)
                        # (sd, sh, sw, id, ih, iw, co) -> (id, sd, ih, sh, iw, sw, co)
                        out = ph.view(2, 2, 2, bt, bt, bt, bn)[
                            :, :, :, :vd, :vh, :vw, :vn].permute(3, 0, 4, 1, 5, 2, 6)
                        y[s, 2 * td0:2 * (td0 + vd), 2 * th0:2 * (th0 + vh),
                          2 * tw0:2 * (tw0 + vw), n0:n0 + vn] = out.reshape(
                              2 * vd, 2 * vh, 2 * vw, vn)
    return y.to(x.dtype)


def padded_u(w: torch.Tensor) -> torch.Tensor:
    """The kernel's weight operand: ``transform_weights(w)`` in w's dtype
    (bf16, or f32 for the f32 instance, which is never rounded),
    zero-padded to (64, Ci up to 32k, Co up to 64k) in bf16 and (64, Ci up
    to 4k, Co up to a multiple of :func:`f32_co_tile`) in f32. Cached per
    weight tensor (weakly) and version counter, under a lock, so the threads
    of a serving process share one transform per kernel."""
    version = None if w.is_inference() else w._version
    key = id(w)
    with _u_lock:
        ent = _u_cache.get(key)
        if (ent is not None and ent[0]() is w and ent[1] == version
                and ent[2] == w.data_ptr()):
            return ent[3]
    ci, co = w.shape[3], w.shape[4]
    f32 = w.dtype == torch.float32
    pad = _CI_PAD_F32 if f32 else _CI_PAD
    cip = -(-ci // pad) * pad
    co_pad = f32_co_tile(co) if f32 else _CO_PAD
    cop = -(-co // co_pad) * co_pad
    with torch.no_grad():
        u = torch.zeros((64, cip, cop), dtype=w.dtype, device=w.device)
        u[:, :ci, :co] = transform_weights(w.detach()).to(w.dtype)
    with _u_lock:
        for k in [k for k, e in _u_cache.items() if e[0]() is None]:
            del _u_cache[k]
        _u_cache[key] = (weakref.ref(w), version, w.data_ptr(), u)
    return u


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"conv3d_winograd: the kernels take bf16 or f32, not {dtype}")


def _check_kernel_args(x: torch.Tensor, w: torch.Tensor,
                       dtypes=KERNEL_DTYPES) -> None:
    _check_dtype(x.dtype)
    if x.dtype not in dtypes or w.dtype != x.dtype:
        raise TypeError(f"conv3d_winograd instance takes {dtypes} x and a "
                        f"weight of its dtype, got {x.dtype}, {w.dtype}")
    _check_shapes(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("conv3d_winograd kernel takes x and w on one CUDA "
                         f"device, got {x.device}, {w.device}")


def _launch(x: torch.Tensor, w: torch.Tensor, plan: WinogradPlan) -> torch.Tensor:
    n, d, h, wd, ci = x.shape
    co = w.shape[4]
    x = x.contiguous()
    u = padded_u(w)
    y = torch.empty((n, d, h, wd, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.instance == "wgmma":
            rc = _lib_wgmma().winograd3d_wgmma_ndhwc_bf16(
                x.data_ptr(), u.data_ptr(), y.data_ptr(), n, d, h, wd, ci, co,
                u.shape[1], u.shape[2], plan.blocks, stream,
            )
        elif plan.instance == "ffma_f32":
            rc = _lib().winograd3d_ndhwc_f32(
                x.data_ptr(), u.data_ptr(), y.data_ptr(), n, d, h, wd, ci, co,
                u.shape[1], u.shape[2], plan.bn, plan.chunk, plan.raw_channels,
                stream,
            )
        else:
            rc = _lib().winograd3d_ndhwc_bf16(
                x.data_ptr(), u.data_ptr(), y.data_ptr(), n, d, h, wd, ci, co,
                u.shape[1], u.shape[2], stream,
            )
    _build.check(rc, f"conv3d_winograd ({plan.instance})")
    if plan.instance == "wgmma":
        _build.count_launch(conv3d_winograd, "launches", "launches_wgmma")
    elif plan.instance == "ffma_f32":
        _build.count_launch(conv3d_winograd, "launches", "launches_f32")
    else:
        _build.count_launch(conv3d_winograd)
    return y


def conv3d_winograd_kernel_mma_sync(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch csrc/winograd3d.cu (any Ci, Co) on CUDA bf16 tensors."""
    _check_kernel_args(x, w, (torch.bfloat16,))
    return _launch(x, w, instance_plan("mma_sync", *x.shape, w.shape[4]))


def conv3d_winograd_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the instance :func:`plan_winograd` names for this dtype and
    shape on CUDA tensors."""
    _check_kernel_args(x, w)
    plan = plan_winograd(*x.shape, w.shape[4], _build.sm_count(x.device),
                         x.dtype)
    return _launch(x, w, plan)


def _winograd_fake(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.new_empty(tuple(x.shape[:4]) + (w.shape[4],))


# brats_torch::conv3d_winograd: the plain version on the CPU, the kernel on CUDA
conv3d_winograd_op = library.define_op(
    "conv3d_winograd", "(Tensor x, Tensor w) -> Tensor",
    conv3d_winograd_plain, conv3d_winograd_kernel, _winograd_fake)


def conv3d_winograd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version on a CPU tensor, the kernel on a CUDA tensor
    (``brats_torch::conv3d_winograd``). Forward only, as the reference (which
    has no VJP); under autograd use ``ops.conv.conv3d`` with
    ``set_backend("winograd")``."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"conv3d_winograd: no kernel for device {x.device}")
    return conv3d_winograd_op(x, w)


conv3d_winograd.launches = 0
conv3d_winograd.launches_wgmma = 0
conv3d_winograd.launches_f32 = 0
