"""Triton kernels of the exact 2x resizes between U-Net levels, forward and
backward.

Imported only by ``ops/resize.py`` when it launches on a CUDA tensor (this
module imports triton at the top; nothing else imports it). The 2x up runs
on ``csrc/resize2x.cu`` where C fills whole 16-byte pieces (bf16 C % 8, f32
C % 4 == 0), its backward there in bf16 where C is a multiple of 8, and the
f32 2x down there where C % 4 == 0; the Triton kernels here take the rest
(the bf16 down, both down backwards, the f32 up backward, other channel
counts, a gradient whose channel pitch is not a multiple of 8), and
``chip_smoke.py`` times them as the CUDA kernels' ``prev_ms``.

Replaces (``brats2019_tpu/ops/pallas_resize.py``):

* ``downsample2x_pallas`` (:268, kernel ``_down_fwd_kernel`` :254): the 2^3
  average pool, and the ``reduce_window`` path of ``ops/resize.py:59``;
* ``upsample2x_pallas`` (:103, kernel ``_up_fwd_kernel`` :82): 2x trilinear
  with half-pixel taps (0.25, 0.75) and replicate-clamped edges, and the
  ``jax.image.resize`` path of ``ops/resize.py:70``.

What bounds them on the card: device-memory bandwidth (8 loads and 1 store
per output of the pool, 1 store per 1/8 load of the upsample; a few flops
each).

and their VJPs:

* ``_downsample2x_bwd_impl`` (:304, kernel ``_down_bwd_kernel`` :292):
  every voxel of a 2^3 window receives g/8 (a voxel the forward dropped,
  past an even extent, receives 0);
* ``_upsample2x_bwd_impl`` (:213, kernel ``_up_bwd_kernel`` :188): the exact
  transpose of the upsample. Per axis, dx[j] = 0.25 g[2j-1] + 0.75 g[2j] +
  0.75 g[2j+1] + 0.25 g[2j+2] with the tap indices clamped to [0, 2n-1]:
  the clamp folds the forward's replicate-clamped edge taps back onto the
  edge voxels (at n == 1 every tap lands on g[0] or g[1], dx = g0 + g1).
  The TPU kernel falls back to bf16 arithmetic for bf16 cotangents only to
  fit its intermediates into 16 MB of VMEM at the (64, 64, 128) grad plane;
  a Hopper program keeps no plane, only one row block in registers, so the
  64 taps are summed in f32 at every shape and stored as bf16.

What bounds them on the card: device-memory bandwidth (8 loads and 1 store
per output of the pool, 1 store per 1/8 load of the upsample; the down
backward 1 load per 8 stores, the up backward 64 cached taps per output,
each g element 8 times from L1/L2 but once from device memory).

Design: one program per output (n, d, h) row and a block of the flattened
(w, c) row, so loads and stores walk contiguous NDHWC memory with C minor.
The TPU kernel gets edge clamping from clamped BlockSpec index maps; here
each program computes its own clamped tap indices. All arithmetic is f32;
the store casts to the output dtype, so the same kernels take bf16 and f32
tensors (the f32 route of ``ops/resize.py`` ``plan_resize``).
"""

import triton
import triton.language as tl


@triton.jit
def _down2x_kernel(x_ptr, y_ptr, D, H, W, C, Do, Ho, Wo,
                   BLOCK: tl.constexpr):
    row = tl.program_id(0)          # over N * Do * Ho output rows
    blk = tl.program_id(1)
    ho = row % Ho
    t = row // Ho
    do = t % Do
    n = t // Do
    offs = blk * BLOCK + tl.arange(0, BLOCK)
    mask = offs < Wo * C
    wo = offs // C
    c = offs % C
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for a in tl.static_range(2):
        for b in tl.static_range(2):
            plane = ((n.to(tl.int64) * D + 2 * do + a) * H + 2 * ho + b) * W
            for e in tl.static_range(2):
                src = (plane + 2 * wo + e) * C + c
                acc += tl.load(x_ptr + src, mask=mask, other=0.0).to(tl.float32)
    out = row.to(tl.int64) * Wo * C + offs
    tl.store(y_ptr + out, (acc * 0.125).to(y_ptr.dtype.element_ty), mask=mask)


@triton.jit
def _taps(o, size):
    """Clamped half-pixel taps of output index o along an axis of ``size``."""
    i = o // 2
    even = (o % 2) == 0
    t0 = tl.where(even, tl.maximum(i - 1, 0), i)
    t1 = tl.where(even, i, tl.minimum(i + 1, size - 1))
    w0 = tl.where(even, 0.25, 0.75)
    return t0, t1, w0, 1.0 - w0


@triton.jit
def _w_interp(x_ptr, plane, t0, t1, w0, w1, c, C, mask):
    v0 = tl.load(x_ptr + (plane + t0) * C + c, mask=mask, other=0.0)
    v1 = tl.load(x_ptr + (plane + t1) * C + c, mask=mask, other=0.0)
    return w0 * v0.to(tl.float32) + w1 * v1.to(tl.float32)


@triton.jit
def _up2x_kernel(x_ptr, y_ptr, D, H, W, C, BLOCK: tl.constexpr):
    row = tl.program_id(0)          # over N * 2D * 2H output rows
    blk = tl.program_id(1)
    oh = row % (2 * H)
    t = row // (2 * H)
    od = t % (2 * D)
    n = t // (2 * D)
    offs = blk * BLOCK + tl.arange(0, BLOCK)
    mask = offs < 2 * W * C
    ow = offs // C
    c = offs % C
    d0, d1, wd0, wd1 = _taps(od, D)
    h0, h1, wh0, wh1 = _taps(oh, H)
    w0, w1, ww0, ww1 = _taps(ow, W)
    nd = n.to(tl.int64) * D
    r00 = _w_interp(x_ptr, ((nd + d0) * H + h0) * W, w0, w1, ww0, ww1, c, C, mask)
    r01 = _w_interp(x_ptr, ((nd + d0) * H + h1) * W, w0, w1, ww0, ww1, c, C, mask)
    r10 = _w_interp(x_ptr, ((nd + d1) * H + h0) * W, w0, w1, ww0, ww1, c, C, mask)
    r11 = _w_interp(x_ptr, ((nd + d1) * H + h1) * W, w0, w1, ww0, ww1, c, C, mask)
    acc = wd0 * (wh0 * r00 + wh1 * r01) + wd1 * (wh0 * r10 + wh1 * r11)
    out = row.to(tl.int64) * 2 * W * C + offs
    tl.store(y_ptr + out, acc.to(y_ptr.dtype.element_ty), mask=mask)


_BLOCK = 1024


def launch_down(x, y) -> None:
    """x (N, D, H, W, C), y (N, D//2, H//2, W//2, C): contiguous, one device."""
    n, d, h, w, c = x.shape
    _, do, ho, wo, _ = y.shape
    grid = (n * do * ho, triton.cdiv(wo * c, _BLOCK))
    _down2x_kernel[grid](x, y, d, h, w, c, do, ho, wo, BLOCK=_BLOCK,
                         num_warps=4)


def launch_up(x, y) -> None:
    """x (N, D, H, W, C), y (N, 2D, 2H, 2W, C): contiguous, one device."""
    n, d, h, w, c = x.shape
    grid = (n * 4 * d * h, triton.cdiv(2 * w * c, _BLOCK))
    _up2x_kernel[grid](x, y, d, h, w, c, BLOCK=_BLOCK, num_warps=4)


@triton.jit
def _down2x_bwd_kernel(g_ptr, dx_ptr, D, H, W, C, Do, Ho, Wo,
                       BLOCK: tl.constexpr):
    row = tl.program_id(0)          # over N * D * H rows of dx
    blk = tl.program_id(1)
    h = row % H
    t = row // H
    d = t % D
    n = t // D
    offs = blk * BLOCK + tl.arange(0, BLOCK)
    mask = offs < W * C
    w = offs // C
    c = offs % C
    inside = (d < 2 * Do) & (h < 2 * Ho) & (w < 2 * Wo)
    src = (((n.to(tl.int64) * Do + d // 2) * Ho + h // 2) * Wo + w // 2) * C + c
    v = tl.load(g_ptr + src, mask=mask & inside, other=0.0).to(tl.float32)
    out = row.to(tl.int64) * W * C + offs
    tl.store(dx_ptr + out, (v * 0.125).to(dx_ptr.dtype.element_ty), mask=mask)


@triton.jit
def _tap(j, k: tl.constexpr, size2):
    """Clamped index of tap k (0..3) of dx index j: 2j + k - 1 in [0, size2)."""
    return tl.minimum(tl.maximum(2 * j + (k - 1), 0), size2 - 1)


@triton.jit
def _up2x_bwd_kernel(g_ptr, dx_ptr, D, H, W, C, BLOCK: tl.constexpr):
    row = tl.program_id(0)          # over N * D * H rows of dx
    blk = tl.program_id(1)
    h = row % H
    t = row // H
    d = t % D
    n = t // D
    offs = blk * BLOCK + tl.arange(0, BLOCK)
    mask = offs < W * C
    w = offs // C
    c = offs % C
    nd = n.to(tl.int64) * (2 * D)
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for a in tl.static_range(4):
        wd = 0.25 + 0.25 * (a * (3 - a))  # 0.25, 0.75, 0.75, 0.25
        gd = _tap(d, a, 2 * D)
        for b in tl.static_range(4):
            wh = 0.25 + 0.25 * (b * (3 - b))  # 0.25, 0.75, 0.75, 0.25
            plane = ((nd + gd) * (2 * H) + _tap(h, b, 2 * H)) * (2 * W)
            r = tl.zeros([BLOCK], dtype=tl.float32)
            for e in tl.static_range(4):
                we = 0.25 + 0.25 * (e * (3 - e))  # 0.25, 0.75, 0.75, 0.25
                src = (plane + _tap(w, e, 2 * W)) * C + c
                r += we * tl.load(g_ptr + src, mask=mask, other=0.0).to(tl.float32)
            acc += (wd * wh) * r
    out = row.to(tl.int64) * W * C + offs
    tl.store(dx_ptr + out, acc.to(dx_ptr.dtype.element_ty), mask=mask)


def launch_down_bwd(g, dx) -> None:
    """g (N, D//2, H//2, W//2, C), dx (N, D, H, W, C): contiguous, one device."""
    n, d, h, w, c = dx.shape
    _, do, ho, wo, _ = g.shape
    grid = (n * d * h, triton.cdiv(w * c, _BLOCK))
    _down2x_bwd_kernel[grid](g, dx, d, h, w, c, do, ho, wo, BLOCK=_BLOCK,
                             num_warps=4)


def launch_up_bwd(g, dx) -> None:
    """g (N, 2D, 2H, 2W, C), dx (N, D, H, W, C): contiguous, one device."""
    n, d, h, w, c = dx.shape
    grid = (n * d * h, triton.cdiv(w * c, _BLOCK))
    _up2x_bwd_kernel[grid](g, dx, d, h, w, c, BLOCK=_BLOCK, num_warps=4)
