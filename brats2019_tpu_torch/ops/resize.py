"""Trilinear resizes for NDHWC volumes (reference:
``brats2019_tpu/ops/resize.py`` and ``ops/pallas_resize.py``).

* :func:`downsample2x` — exact 2x down, the 2^3 average pool.
* :func:`upsample2x` — exact 2x trilinear up: half-pixel taps (0.25, 0.75)
  with replicate-clamped edges.

* :func:`upsample2x_concat` — ``cat([upsample2x(x), skip], -1)``, the
  decoder's (up, skip) concat, with the up half written by the kernel
  straight into the concat buffer.

All are ``autograd.Function``s whose backward is the exact VJP
(:func:`downsample2x_bwd`: g/8 broadcast to the 2^3 window;
:func:`upsample2x_bwd`: the stride-2 4-tap correlation with the
replicate-clamp edge folds, ``pallas_resize.py:128-234``). Forward and
backward run their plain version on a CPU tensor and a kernel on a CUDA bf16
or f32 tensor (or raise), by :func:`plan_resize`: ``csrc/resize2x.cu`` takes
the 2x up and its backward where C and the channel pitch (of the up's output,
or of the backward's gradient) fill whole 16-byte pieces (bf16: multiples of
8; f32: of 4), and the 2x down and its backward in f32 where C is a multiple
of 4; the Triton kernels of ``ops/triton_resize.py`` take the rest (the bf16
down and its backward, other C or pitches; their loads and stores take the
tensor's dtype; arithmetic is f32). The up backward reads the concat
gradient's up half in place, at the concat's channel pitch, in the instance
(16-byte pieces of a block's channel chunk: 8 or 4) and the d run that
:func:`plan_up_bwd` picks. ``.launches`` counts kernel launches;
``upsample2x.launches_cuda``, ``downsample2x.launches_cuda``,
``upsample2x_bwd.launches_cuda`` and ``downsample2x_bwd.launches_cuda`` those
of them on resize2x.cu, ``upsample2x.launches_concat`` those that wrote into a
concat buffer, ``.launches_f32`` of each those on f32 tensors.

The three forwards are ``torch.library`` operators (``ops/library.py``:
``brats_torch::downsample2x``, ``upsample2x``, ``upsample2x_concat``), which
the ``autograd.Function``s call; the backwards are called as before.

* :func:`resize_trilinear` — arbitrary target shape, plain torch on every
  device, as the JAX package runs it outside any Pallas kernel. It is
  ``jax.image.resize(method="trilinear")``, which ANTIALIASES when it
  shrinks: the canvas -> coarse-grid resize is a separable 4-tap
  (1,3,3,1)/8 filter with edge rows renormalised to (3,3,1)/7, not
  ``F.interpolate``'s 2-tap average. The per-axis weight matrices are
  built in numpy f32 exactly as jax builds them and applied by einsum.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import _build, library
from .library import device_const
from .conv import check_dtype, f32_counter

_SIG = {
    "upsample2x_ndhwc_bf16": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    "upsample2x_ndhwc_f32": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    "upsample2x_bwd_ndhwc_bf16": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    "upsample2x_bwd_ndhwc_f32": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "upsample2x_bwd_smem_bytes": [ctypes.c_int],
    "downsample2x_ndhwc_f32": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "downsample2x_bwd_ndhwc_f32": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}


def _lib() -> ctypes.CDLL:
    return _build.load_library("resize2x", ["resize2x.cu"], _SIG)


# ----------------------------------------------------------- plain versions --

def downsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    n, d, h, w, c = x.shape
    d2, h2, w2 = d // 2, h // 2, w // 2
    xf = x[:, : 2 * d2, : 2 * h2, : 2 * w2].float()
    s = xf.reshape(n, d2, 2, h2, 2, w2, 2, c).sum(dim=(2, 4, 6))
    return (s * 0.125).to(x.dtype)


def _up_axis(x: torch.Tensor, ax: int) -> torch.Tensor:
    """2x half-pixel linear upsample of one axis with clamped edges."""
    size = x.shape[ax]
    prev = torch.cat([x.narrow(ax, 0, 1), x.narrow(ax, 0, size - 1)], ax)
    nxt = torch.cat([x.narrow(ax, 1, size - 1), x.narrow(ax, size - 1, 1)], ax)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    out = torch.stack([even, odd], dim=ax + 1)
    shape = list(x.shape)
    shape[ax] *= 2
    return out.reshape(shape)


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    y = x.float()
    for ax in (1, 2, 3):
        y = _up_axis(y, ax)
    return y.to(x.dtype)


UP_TILE = (4, 4, 8)   # csrc/resize2x.cu: input voxels of a block's tile (d, h, w)


def upsample2x_tiled_plain(x: torch.Tensor) -> torch.Tensor:
    """The 2x up in plain torch, organised as csrc/resize2x.cu is: per tile
    of UP_TILE input voxels (all samples and channels at once: the kernel's
    channel chunks do not interact), a halo tile gathered at clamped indices
    (the replicate edge), each halo d-row interpolated along w then h, and
    the d phases of a voxel completed from two consecutive rows as the kernel
    walks them. f32 math, x.dtype out."""
    n, d, h, w, c = x.shape
    td, th, tw = UP_TILE
    xf = x.float()
    y = torch.empty((n, 2 * d, 2 * h, 2 * w, c), dtype=torch.float32,
                    device=x.device)
    clamp = lambda lo, size, lim: torch.arange(lo - 1, lo + size + 1).clamp(0, lim - 1)
    for d0 in range(0, d, td):
        for h0 in range(0, h, th):
            for w0 in range(0, w, tw):
                halo = xf[:, clamp(d0, td, d)][:, :, clamp(h0, th, h)][
                    :, :, :, clamp(w0, tw, w)]         # (n, td+2, th+2, tw+2, c)
                we = 0.25 * halo[:, :, :, :-2] + 0.75 * halo[:, :, :, 1:-1]
                wo = 0.75 * halo[:, :, :, 1:-1] + 0.25 * halo[:, :, :, 2:]
                rw = torch.stack([we, wo], 4)          # (n, td+2, th+2, tw, 2, c)
                he = 0.25 * rw[:, :, :-2] + 0.75 * rw[:, :, 1:-1]
                ho = 0.75 * rw[:, :, 1:-1] + 0.25 * rw[:, :, 2:]
                row = torch.stack([he, ho], 3)         # (n, td+2, th, 2, tw, 2, c)
                dn, hn, wn = min(td, d - d0), min(th, h - h0), min(tw, w - w0)
                for v in range(dn):                    # rows v, v+1, v+2 of voxel v
                    ev = 0.25 * row[:, v] + 0.75 * row[:, v + 1]
                    od = 0.75 * row[:, v + 1] + 0.25 * row[:, v + 2]
                    for a, ph in ((0, ev), (1, od)):
                        y[:, 2 * (d0 + v) + a, 2 * h0:2 * (h0 + hn),
                          2 * w0:2 * (w0 + wn)] = ph[:, :hn, :, :wn].reshape(
                              n, 2 * hn, 2 * wn, c)
    return y.to(x.dtype)


def downsample2x_bwd_plain(g: torch.Tensor, x_shape) -> torch.Tensor:
    """VJP of the 2^3 average pool: g/8 on each voxel of its window; voxels
    past an even extent (dropped by the forward) get 0."""
    n, d2, h2, w2, c = g.shape
    gf = (g.float() * 0.125)[:, :, None, :, None, :, None, :]
    up = gf.expand(n, d2, 2, h2, 2, w2, 2, c).reshape(n, 2 * d2, 2 * h2, 2 * w2, c)
    out = torch.zeros(tuple(x_shape), dtype=torch.float32, device=g.device)
    out[:, : 2 * d2, : 2 * h2, : 2 * w2] = up
    return out.to(g.dtype)


def _up_axis_t(g: torch.Tensor, ax: int) -> torch.Tensor:
    """Transpose of :func:`_up_axis`: dx[j] = 0.25 g[2j-1] + 0.75 (g[2j] +
    g[2j+1]) + 0.25 g[2j+2], tap indices clamped to the axis."""
    size2 = g.shape[ax]
    j2 = 2 * torch.arange(size2 // 2, device=g.device)
    tap = lambda k: g.index_select(ax, (j2 + k - 1).clamp(0, size2 - 1))
    return 0.75 * (tap(1) + tap(2)) + 0.25 * (tap(0) + tap(3))


def upsample2x_bwd_plain(g: torch.Tensor) -> torch.Tensor:
    y = g.float()
    for ax in (1, 2, 3):
        y = _up_axis_t(y, ax)
    return y.to(g.dtype)


# ----------------------------------------------------------------- kernels --

RESIZE_OPS = ("downsample2x", "downsample2x_bwd", "upsample2x", "upsample2x_bwd")


def plan_resize(op: str, c: int, dtype: torch.dtype,
                pitch: Optional[int] = None) -> str:
    """The kernel that runs ``op`` (one of :data:`RESIZE_OPS`) on a CUDA
    tensor of C channels in ``dtype`` (``pitch``: the channel pitch of the up
    forward's output or of the up backward's gradient, None where it is C):
    ``"resize2x.cu"`` or ``"triton"``. resize2x.cu takes the up and its
    backward where C and the pitch are multiples of a 16-byte piece's
    channels (8 in bf16, 4 in f32), the down and its backward in f32 at
    multiples of 4. bf16 and f32; any other dtype raises TypeError."""
    if op not in RESIZE_OPS:
        raise ValueError(f"unknown resize op {op!r}; one of {RESIZE_OPS}")
    check_dtype(dtype, op)
    f32 = dtype == torch.float32
    piece = 4 if f32 else 8
    cuda = f32 or op.startswith("upsample2x")
    if not cuda or c % piece or (pitch is not None and pitch % piece):
        return "triton"
    return "resize2x.cu"


# csrc/resize2x.cu's up backward: dx voxels of a block in h, the fine rows of
# its ring, its instances (16-byte pieces of a channel chunk)
UP_BWD_TILE_H, UP_BWD_RING = 4, 4
UP_BWD_PIECES = (8, 4)


class UpBwdPlan(NamedTuple):
    pieces: int     # the instance: 16-byte pieces of a block's channel chunk
    tile: tuple     # (h, w) dx voxels of a block: (4, 64 / pieces)
    td: int         # dx voxels of a block's run along d
    chunks: int     # channel chunks
    blocks: int
    smem: int       # dynamic shared memory of a block, bytes


def up_bwd_smem(pieces: int) -> int:
    """The ring of ``csrc/resize2x.cu`` ``UpBwdTile<pieces>``: 4 fine rows of
    (2 * 4 + 2) x (2 * 64 / pieces + 2) voxels x pieces 16-byte slots."""
    return (UP_BWD_RING * (2 * UP_BWD_TILE_H + 2) * (2 * (64 // pieces) + 2)
            * pieces * 16)


def _up_bwd_td(n: int, d: int, nth: int, ntw: int, chunks: int, sms: int) -> int:
    """The d run (8, 4, 2, 1) whose busiest SM walks the fewest fine rows:
    waves of two blocks an SM times the 2 td + 2 fine rows of a block (the
    longer run on a tie)."""
    best = None
    for run in (8, 4, 2, 1):
        blocks = -(-d // run) * nth * ntw * chunks * n
        cost = -(-blocks // (2 * sms)) * (2 * run + 2)
        if best is None or cost < best[0]:
            best = (cost, run)
    return best[1]


@functools.lru_cache(maxsize=4096)   # a process sees a few dozen shapes
def plan_up_bwd(n: int, d: int, h: int, w: int, c: int, dtype: torch.dtype,
                sms: int = 132, pieces: Optional[int] = None) -> UpBwdPlan:
    """The launch of resize2x.cu's up backward for dx (N, D, H, W, C) on a
    card of ``sms`` SMs: its instance and its d run, which the kernel takes as
    arguments. bf16 has one instance, 8 pieces (64 channels) a chunk. f32 (4 channels a piece) takes the instance whose block keeps the
    most of its 256 threads busy, counting the pieces of its last chunk and
    the w voxels of its last tile (the wider instance on a tie): C = 16 is 4
    pieces, a tile of 4 x 16 dx voxels. ``pieces`` forces an f32 instance."""
    check_dtype(dtype, "upsample2x_bwd")
    per = 4 if dtype == torch.float32 else 8
    if c % per or c < per:
        raise ValueError(f"upsample2x_bwd: C = {c} is not whole 16-byte pieces")
    p = c // per
    if pieces is None:
        if per == 8:
            pieces = 8
        else:
            busy = lambda pc: (p / (-(-p // pc) * pc)
                               * w / (-(-w // (64 // pc)) * (64 // pc)))
            pieces = max(UP_BWD_PIECES, key=lambda pc: (busy(pc), pc))
    elif pieces not in UP_BWD_PIECES or (per == 8 and pieces != 8):
        raise ValueError(f"upsample2x_bwd: no {pieces}-piece instance in {dtype}")
    btw = 64 // pieces
    nth, ntw = -(-h // UP_BWD_TILE_H), -(-w // btw)
    chunks = -(-p // pieces)
    td = _up_bwd_td(n, d, nth, ntw, chunks, sms)
    return UpBwdPlan(pieces, (UP_BWD_TILE_H, btw), td, chunks,
                     -(-d // td) * nth * ntw * chunks * n, up_bwd_smem(pieces))


def _check5d(x: torch.Tensor, what: str) -> None:
    if x.dim() != 5:
        raise ValueError(f"{what}: expected NDHWC, got {tuple(x.shape)}")
    check_dtype(x.dtype, what)


def _down_out(x: torch.Tensor, what: str):
    _check5d(x, what)
    n, d, h, w, c = x.shape
    if min(d, h, w) < 2:
        raise ValueError(f"{what}: spatial dims < 2 in {tuple(x.shape)}")
    return torch.empty((n, d // 2, h // 2, w // 2, c), dtype=x.dtype,
                       device=x.device)


def downsample2x_kernel_triton(x: torch.Tensor) -> torch.Tensor:
    """The Triton ``_down2x_kernel`` (any C): what :func:`downsample2x_kernel`
    launches in bf16 and where an f32 C is not a multiple of 4."""
    from . import triton_resize

    y = _down_out(x, "downsample2x")
    with torch.cuda.device(x.device):
        triton_resize.launch_down(x.contiguous(), y)
    _build.count_launch(downsample2x, "launches", *f32_counter(x))
    return y


def downsample2x_kernel(x: torch.Tensor) -> torch.Tensor:
    """The 2x down on a CUDA tensor, by :func:`plan_resize`: csrc/resize2x.cu
    in f32 where C % 4 == 0 (a copy first where x is not contiguous or not
    16-byte aligned), else the Triton kernel."""
    y = _down_out(x, "downsample2x")
    n, d, h, w, c = x.shape
    if plan_resize("downsample2x", c, x.dtype) == "triton":
        return downsample2x_kernel_triton(x)
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().downsample2x_ndhwc_f32(x.data_ptr(), y.data_ptr(), n, d, h,
                                           w, c, stream)
    _build.check(rc, "downsample2x (resize2x.cu)")
    _build.count_launch(downsample2x, "launches", "launches_cuda", "launches_f32")
    return y


def upsample2x_kernel_triton(x: torch.Tensor) -> torch.Tensor:
    """The Triton ``_up2x_kernel`` (any C): what :func:`upsample2x_kernel`
    launches where C does not fill whole 16-byte pieces (bf16 C % 8, f32
    C % 4)."""
    _check5d(x, "upsample2x")
    from . import triton_resize

    n, d, h, w, c = x.shape
    x = x.contiguous()
    y = torch.empty((n, 2 * d, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        triton_resize.launch_up(x, y)
    _build.count_launch(upsample2x, "launches", *f32_counter(x))
    return y


def _launch_up_cuda(x: torch.Tensor, out: torch.Tensor, offset: int) -> None:
    """csrc/resize2x.cu in x's dtype: up(x) into channels [offset, offset +
    C) of the contiguous (N, 2D, 2H, 2W, pitch) ``out``."""
    x = x.contiguous()
    n, d, h, w, c = x.shape
    fn = (_lib().upsample2x_ndhwc_f32 if x.dtype == torch.float32
          else _lib().upsample2x_ndhwc_bf16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), n, d, h, w, c, out.shape[-1],
                offset, stream)
    _build.check(rc, "upsample2x (resize2x.cu)")


def upsample2x_kernel(x: torch.Tensor) -> torch.Tensor:
    """The 2x up on a CUDA tensor, by :func:`plan_resize`: csrc/resize2x.cu
    (bf16 C % 8 == 0, f32 C % 4 == 0) or the Triton kernel."""
    _check5d(x, "upsample2x")
    n, d, h, w, c = x.shape
    if plan_resize("upsample2x", c, x.dtype) == "triton":
        return upsample2x_kernel_triton(x)
    y = torch.empty((n, 2 * d, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    _launch_up_cuda(x, y, 0)
    _build.count_launch(upsample2x, "launches", "launches_cuda", *f32_counter(x))
    return y


def upsample2x_concat_kernel(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """``cat([up(x), skip], -1)`` on CUDA tensors: csrc/resize2x.cu writes
    up(x) into the concat buffer's first C channels where :func:`plan_resize`
    gives it x at the buffer's channel pitch; else (C or the pitch off the
    16-byte pieces) the Triton up is made apart and copied into the buffer.
    skip is copied into the rest."""
    _check5d(x, "upsample2x_concat")
    _check5d(skip, "upsample2x_concat")
    n, d, h, w, cu = x.shape
    if tuple(skip.shape[:4]) != (n, 2 * d, 2 * h, 2 * w) or skip.device != x.device:
        raise ValueError(f"upsample2x_concat: skip {tuple(skip.shape)} on "
                         f"{skip.device} for x {tuple(x.shape)} on {x.device}")
    buf = torch.empty((n, 2 * d, 2 * h, 2 * w, cu + skip.shape[-1]),
                      dtype=x.dtype, device=x.device)
    if plan_resize("upsample2x", cu, x.dtype, buf.shape[-1]) == "triton":
        buf[..., :cu] = upsample2x_kernel(x)
    else:
        _launch_up_cuda(x, buf, 0)
        _build.count_launch(upsample2x, "launches", "launches_cuda",
                            "launches_concat", *f32_counter(x))
    buf[..., cu:] = skip
    return buf


def _down_bwd_out(g: torch.Tensor, x_shape) -> torch.Tensor:
    _check5d(g, "downsample2x_bwd")
    n, d, h, w, c = x_shape
    if tuple(g.shape) != (n, d // 2, h // 2, w // 2, c):
        raise ValueError(f"downsample2x_bwd: g {tuple(g.shape)} for x {tuple(x_shape)}")
    return torch.empty(tuple(x_shape), dtype=g.dtype, device=g.device)


def downsample2x_bwd_kernel_triton(g: torch.Tensor, x_shape) -> torch.Tensor:
    """The Triton ``_down2x_bwd_kernel`` (any C): what
    :func:`downsample2x_bwd_kernel` launches in bf16 and where an f32 C is
    not a multiple of 4."""
    from . import triton_resize

    dx = _down_bwd_out(g, x_shape)
    with torch.cuda.device(g.device):
        triton_resize.launch_down_bwd(g.contiguous(), dx)
    _build.count_launch(downsample2x_bwd, "launches", *f32_counter(g))
    return dx


def downsample2x_bwd_kernel(g: torch.Tensor, x_shape) -> torch.Tensor:
    """The VJP of the 2x down on a CUDA g, by :func:`plan_resize`:
    csrc/resize2x.cu in f32 where C % 4 == 0 (a copy first where g is not
    contiguous or not 16-byte aligned), else the Triton kernel."""
    n, d, h, w, c = x_shape
    if plan_resize("downsample2x_bwd", c, g.dtype) == "triton":
        return downsample2x_bwd_kernel_triton(g, x_shape)
    dx = _down_bwd_out(g, x_shape)
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = _lib().downsample2x_bwd_ndhwc_f32(g.data_ptr(), dx.data_ptr(), n, d,
                                               h, w, c, stream)
    _build.check(rc, "downsample2x_bwd (resize2x.cu)")
    _build.count_launch(downsample2x_bwd, "launches", "launches_cuda", "launches_f32")
    return dx


def upsample2x_bwd_kernel_triton(g: torch.Tensor) -> torch.Tensor:
    """The Triton ``_up2x_bwd_kernel`` (any C) on a contiguous copy of g:
    what :func:`upsample2x_bwd_kernel` launches where C or g's channel pitch
    is not whole 16-byte pieces (bf16: multiples of 8; f32: of 4)."""
    _check5d(g, "upsample2x_bwd")
    from . import triton_resize

    n, d2, h2, w2, c = g.shape
    if d2 % 2 or h2 % 2 or w2 % 2:
        raise ValueError(f"upsample2x_bwd: odd extent in {tuple(g.shape)}")
    g = g.contiguous()
    dx = torch.empty((n, d2 // 2, h2 // 2, w2 // 2, c), dtype=g.dtype,
                     device=g.device)
    with torch.cuda.device(g.device):
        triton_resize.launch_up_bwd(g, dx)
    _build.count_launch(upsample2x_bwd, "launches", *f32_counter(g))
    return dx


def channel_pitch(t: torch.Tensor):
    """The channel pitch of an NDHWC ``t`` that is C channels of a
    contiguous (N, D, H, W, pitch) buffer (all of it, or a channel slice such
    as a concat's first half), else None."""
    n, d, h, w, c = t.shape
    pitch = t.stride(3)
    want = (d * h * w * pitch, h * w * pitch, w * pitch, pitch, 1)
    if pitch < c or any(size > 1 and st != ws for size, st, ws
                        in zip(t.shape, t.stride(), want)):
        return None
    return pitch


def _launch_up_bwd_cuda(g: torch.Tensor, dx: torch.Tensor, pitch: int,
                        plan: UpBwdPlan) -> None:
    """csrc/resize2x.cu in g's dtype: dx (N, D, H, W, C) from g, C channels
    at a channel pitch of ``pitch`` from g's first, in ``plan``'s instance
    (bf16 has only the 8-piece one) and d run."""
    n, d, h, w, c = dx.shape
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        if g.dtype == torch.float32:
            rc = _lib().upsample2x_bwd_ndhwc_f32(g.data_ptr(), dx.data_ptr(), n, d,
                                                 h, w, c, pitch, plan.pieces,
                                                 plan.td, stream)
        else:
            rc = _lib().upsample2x_bwd_ndhwc_bf16(g.data_ptr(), dx.data_ptr(), n,
                                                  d, h, w, c, pitch, plan.td,
                                                  stream)
    _build.check(rc, "upsample2x_bwd (resize2x.cu)")


def upsample2x_bwd_kernel(g: torch.Tensor) -> torch.Tensor:
    """The VJP of the 2x up on a CUDA g (N, 2D, 2H, 2W, C), by
    :func:`plan_resize`: csrc/resize2x.cu where C fills whole 16-byte pieces
    (bf16 C % 8 == 0, f32 C % 4 == 0), read in place at g's channel pitch (a
    copy at pitch C first where g is not C channels of an NDHWC buffer, or
    not 16-byte aligned), in the instance :func:`plan_up_bwd` picks; the
    Triton kernel where C or the pitch is off the pieces."""
    _check5d(g, "upsample2x_bwd")
    n, d2, h2, w2, c = g.shape
    if d2 % 2 or h2 % 2 or w2 % 2:
        raise ValueError(f"upsample2x_bwd: odd extent in {tuple(g.shape)}")
    pitch = channel_pitch(g)
    if plan_resize("upsample2x_bwd", c, g.dtype, pitch) == "triton":
        return upsample2x_bwd_kernel_triton(g)
    if pitch is None or g.data_ptr() % 16:
        g = g.clone(memory_format=torch.contiguous_format)
        pitch = c
    dx = torch.empty((n, d2 // 2, h2 // 2, w2 // 2, c), dtype=g.dtype,
                     device=g.device)
    plan = plan_up_bwd(n, d2 // 2, h2 // 2, w2 // 2, c, g.dtype,
                       _build.sm_count(g.device))
    _launch_up_bwd_cuda(g, dx, pitch, plan)
    _build.count_launch(upsample2x_bwd, "launches", "launches_cuda", *f32_counter(g))
    return dx


def _device_check(x: torch.Tensor, what: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: no kernel for device {x.device}")


def downsample2x_bwd(g: torch.Tensor, x_shape) -> torch.Tensor:
    """VJP of :func:`downsample2x` for an input of shape ``x_shape``."""
    _device_check(g, "downsample2x_bwd")
    if g.device.type == "cpu":
        return downsample2x_bwd_plain(g, x_shape)
    return downsample2x_bwd_kernel(g, x_shape)


def upsample2x_bwd(g: torch.Tensor) -> torch.Tensor:
    """VJP of :func:`upsample2x`: (N, 2D, 2H, 2W, C) -> (N, D, H, W, C)."""
    _device_check(g, "upsample2x_bwd")
    if g.device.type == "cpu":
        return upsample2x_bwd_plain(g)
    return upsample2x_bwd_kernel(g)


def _down_fake(x: torch.Tensor) -> torch.Tensor:
    n, d, h, w, c = x.shape
    return x.new_empty((n, d // 2, h // 2, w // 2, c))


def _up_fake(x: torch.Tensor) -> torch.Tensor:
    n, d, h, w, c = x.shape
    return x.new_empty((n, 2 * d, 2 * h, 2 * w, c))


def _up_concat_cpu(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    return torch.cat([upsample2x_plain(x), skip], -1)


def _up_concat_fake(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    n, d, h, w, c = x.shape
    return x.new_empty((n, 2 * d, 2 * h, 2 * w, c + skip.shape[-1]))


# the forwards as brats_torch:: operators: the plain version on the CPU, the
# kernel on CUDA. The concat form allocates and returns its buffer.
downsample2x_op = library.define_op(
    "downsample2x", "(Tensor x) -> Tensor",
    downsample2x_plain, downsample2x_kernel, _down_fake)
upsample2x_op = library.define_op(
    "upsample2x", "(Tensor x) -> Tensor",
    upsample2x_plain, upsample2x_kernel, _up_fake)
upsample2x_concat_op = library.define_op(
    "upsample2x_concat", "(Tensor x, Tensor skip) -> Tensor",
    _up_concat_cpu, upsample2x_concat_kernel, _up_concat_fake)


class _Down2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.x_shape = tuple(x.shape)
        return downsample2x_op(x)

    @staticmethod
    def backward(ctx, g):
        return downsample2x_bwd(g, ctx.x_shape)


class _Up2xConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, skip):
        ctx.cu = x.shape[-1]
        return upsample2x_concat_op(x, skip)

    @staticmethod
    def backward(ctx, g):
        cu = ctx.cu
        # the up half is read in place, at the concat's channel pitch
        return upsample2x_bwd(g[..., :cu]), g[..., cu:]


class _Up2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return upsample2x_op(x)

    @staticmethod
    def backward(ctx, g):
        return upsample2x_bwd(g)


def downsample2x(x: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, D/2, H/2, W/2, C): 2^3 average pool."""
    _device_check(x, "downsample2x")
    return _Down2x.apply(x)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, 2D, 2H, 2W, C): 2x trilinear, half-pixel."""
    _device_check(x, "upsample2x")
    return _Up2x.apply(x)


def upsample2x_concat(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, Cu), (N, 2D, 2H, 2W, Cs) -> (N, 2D, 2H, 2W, Cu + Cs):
    ``cat([upsample2x(x), skip], -1)`` (the order of the JAX package's
    decoder, ``models/unet3d.py:135``) without a second copy of the up half."""
    _device_check(x, "upsample2x_concat")
    if skip.dtype != x.dtype:
        raise TypeError(f"upsample2x_concat: skip {skip.dtype}, x {x.dtype}")
    return _Up2xConcat.apply(x, skip)


downsample2x.launches = 0
downsample2x.launches_cuda = 0
upsample2x.launches = 0
upsample2x.launches_cuda = 0
upsample2x.launches_concat = 0
downsample2x_bwd.launches = 0
downsample2x_bwd.launches_cuda = 0
upsample2x_bwd.launches = 0
upsample2x_bwd.launches_cuda = 0
downsample2x.launches_f32 = 0
upsample2x.launches_f32 = 0
downsample2x_bwd.launches_f32 = 0
upsample2x_bwd.launches_f32 = 0


# ----------------------------------------------------------- any-shape resize --

def linear_weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of ``jax.image.resize``'s linear kernel
    (jax._src.image.scale.compute_weight_mat with antialias=True): when
    shrinking, the triangle kernel widens by n_in/n_out; columns are
    normalised to sum 1, and samples outside the input get zero weight."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    dist = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
    weights = np.maximum(f32(0.0), f32(1.0) - dist / kernel_scale).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    weights = np.where(ok, weights / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0).astype(f32)


_WEIGHT_MATRICES: dict = {}


def _weight_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """:func:`linear_weight_matrix` on ``device``, built once per device
    (``library.device_const``)."""
    return device_const(
        _WEIGHT_MATRICES, (n_in, n_out, device),
        lambda: torch.from_numpy(linear_weight_matrix(n_in, n_out)).to(device))


def resize_trilinear(x: torch.Tensor, spatial: Sequence[int]) -> torch.Tensor:
    """Resize the 3 spatial dims of (..., D, H, W, C); f32 math, x.dtype out."""
    nd = x.dim()
    y = x.float()
    letters = "abcdefgh"[:nd]
    for i, n_out in enumerate(spatial):
        ax = nd - 4 + i
        n_in = y.shape[ax]
        if n_in == n_out:
            continue  # jax skips identity axes
        wmat = _weight_matrix(n_in, n_out, y.device)
        out = letters[:ax] + "z" + letters[ax + 1:]
        y = torch.einsum(f"{letters},{letters[ax]}z->{out}", y, wmat)
    return y.contiguous().to(x.dtype)
