"""Shifted-window 3D self-attention (the Swin UNETR's ``WindowAttention``,
MONAI's ``monai/networks/nets/swin_unetr.py``). It replaces no TPU kernel:
the JAX package has no attention. It was added for ``models/swin_unetr.py``,
whose encoder spends its attention here.

:func:`window_attention` takes the ``qkv`` projection of a grid cut into
windows, (windows, T, 3C) with T = wd * wh * ww tokens a window and the
channels ordered (q | k | v, head, head dim), and returns (windows, T, C),
heads side by side: per window and head

    softmax(q k^T * scale + B[rel(i, j), h] + M(i, j)) v

* B: the (2 wc - 1)^3 x heads relative-position table, wc the
  configuration's window; rel(i, j) = ((dd + wc - 1) (2 wc - 1) + dh + wc -
  1) (2 wc - 1) + dw + wc - 1 from the offsets (dd, dh, dw) of query i to
  key j inside their window. A window that ``window_and_shift`` clamped
  below wc indexes the same table by its tokens' own offsets
  (:func:`relative_index`).
* M: the shift mask. With a shift s > 0 along an axis, the grid (padded to
  P along it) has three regions there, [0, P - w), [P - w, P - s), [P - s,
  P), counted on the rolled grid; a query and a key in different regions
  along any axis get -100, else 0 (:func:`shift_mask`). Without a shift
  there is no mask.

The windows are those of a grid (N, D, H, W) zero-padded at the far side to
multiples of the window and, when shifted, rolled by -s: the caller makes
them (the partition, pad and roll are copies around this operator, in
``models/swin_unetr.py``); ``dims`` (D, H, W), ``window`` and ``shift`` give
the operator the geometry it needs for B and M. Padded tokens take part as
keys, as MONAI's do.

Routes, by the tensor's device, behind the ``torch.library`` operator
``brats_torch::window_attention`` (``ops/library.py``):

* CPU: :func:`window_attention_plain`, B and M materialised for a block of
  windows at a time, softmax in f32;
* CUDA, bf16, head dim 16: the CUDA C++ kernel of
  ``csrc/window_attention.cu`` (:func:`window_attention_kernel`): a block of
  4 warps per (window, head), the window's keys and values of the head in
  shared memory, q k^T and p v on the tensor cores (``mma.sync``
  m16n8k16), an online softmax over the window's keys in blocks of 32, B
  read from the head's column of the table (handed over transposed and
  times log2 e, a 26-196 KB copy a call) at the query's offset code less
  the key's, and M a compare of the query's and key's region codes in the
  windows that a shifted axis cuts: neither is materialised. Another dtype,
  head dim or a window over 7^3 raises; there is no fallback.

What bounds the kernel: at head dim 16 a window's q, k, v are 33 KB a head
for 7.5 MFLOP, so bytes bound it against the peaks (FLOPs over bytes ~180,
under the H100's ~295); the 343^2 exponentials a window and head, which no
peak counts, are likely its real limit (PERF.md §6, row 10).

Counters: ``window_attention.launches`` counts the operator's calls on
either device, ``.launches_cuda`` the kernel's launches (one a call on a
card, counted where it launches), ``.tokens`` the window tokens the calls
processed and ``.padded_tokens`` those of them that are padding.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from . import _build, library

MASK_VALUE = -100.0     # MONAI's compute_mask
HEAD_DIM = 16           # the kernel's head dim (one k-step of mma.sync)
MAX_WINDOW = 7          # the kernel's largest window (its table in shared memory)
LOG2E = 1.4426950408889634
PLAIN_SCORES = 1 << 24  # score elements a block of windows of the plain form holds


def window_and_shift(dims: Sequence[int], window: int, shift: int
                     ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """MONAI's ``get_window_size``: an axis no longer than ``window`` takes
    its own length as its window and no shift."""
    ws = tuple(d if d <= window else window for d in dims)
    ss = tuple(0 if d <= window else shift for d in dims)
    return ws, ss


def padded(dims: Sequence[int], window: Sequence[int]) -> Tuple[int, ...]:
    """The grid padded at the far side to whole windows."""
    return tuple(-(-d // w) * w for d, w in zip(dims, window))


def _coords(window: Sequence[int]) -> torch.Tensor:
    """(T, 3) coordinates of a window's tokens, row-major."""
    wd, wh, ww = window
    t = torch.arange(wd * wh * ww)
    return torch.stack([t // (wh * ww), (t // ww) % wh, t % ww], -1)


@functools.lru_cache(maxsize=None)
def relative_index(window: Tuple[int, int, int], wc: int) -> torch.Tensor:
    """(T, T) int64 row of the (2 wc - 1)^3 table for query i, key j."""
    c = _coords(window)
    rel = c[:, None, :] - c[None, :, :] + (wc - 1)
    r = 2 * wc - 1
    return (rel[..., 0] * r + rel[..., 1]) * r + rel[..., 2]


@functools.lru_cache(maxsize=None)
def shift_mask(grid: Tuple[int, int, int], window: Tuple[int, int, int],
               shift: Tuple[int, int, int]) -> Optional[torch.Tensor]:
    """(windows of a sample, T, T) f32 of 0 and -100 over the padded grid
    ``grid`` cut into ``window``s with ``shift``; None without a shift."""
    if not any(shift):
        return None
    regions = []
    for p, w, s in zip(grid, window, shift):
        pos = torch.arange(p)
        regions.append((pos >= p - w).long() + ((pos >= p - s) & (s > 0)).long())
    # the region of every grid voxel, then cut into windows
    reg = (regions[0][:, None, None] * 9 + regions[1][None, :, None] * 3
           + regions[2][None, None, :])
    (pd, ph, pw), (wd, wh, ww) = grid, window
    reg = reg.reshape(pd // wd, wd, ph // wh, wh, pw // ww, ww)
    reg = reg.permute(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)
    return torch.where(reg[:, :, None] == reg[:, None, :], 0.0, MASK_VALUE)


def _geometry(qkv: torch.Tensor, table: torch.Tensor, dims, window, shift):
    """(windows a sample, heads, head dim) after checking the shapes."""
    window = tuple(window)
    nw, t, c3 = qkv.shape
    heads, wc = table.shape[1], table_window(table)
    per_sample = math.prod(p // w for p, w in zip(padded(dims, window), window))
    if (len(dims) != 3 or len(window) != 3 or len(shift) != 3
            or t != math.prod(window) or c3 % (3 * heads) or nw % per_sample
            or table.shape[0] != (2 * wc - 1) ** 3 or max(window) > wc):
        raise ValueError(f"window_attention: qkv {tuple(qkv.shape)}, table "
                         f"{tuple(table.shape)}, dims {tuple(dims)}, window "
                         f"{window} do not fit")
    return per_sample, heads, c3 // (3 * heads)


def table_window(table: torch.Tensor) -> int:
    """wc of a (2 wc - 1)^3 x heads table."""
    return (round(table.shape[0] ** (1 / 3)) + 1) // 2


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor, dims,
                           window, shift, scale: float) -> torch.Tensor:
    """The plain form: B and M materialised for a block of windows, f32
    math, the output in ``qkv.dtype``."""
    per_sample, heads, hd = _geometry(qkv, table, dims, window, shift)
    nw, t, _ = qkv.shape
    window = tuple(window)
    bias = table.float()[relative_index(window, table_window(table)).to(
        table.device).reshape(-1)].reshape(t, t, heads).permute(2, 0, 1)
    mask = shift_mask(padded(dims, window), window, tuple(shift))
    mask = None if mask is None else mask.to(qkv.device)
    out = torch.empty((nw, t, heads * hd), dtype=qkv.dtype, device=qkv.device)
    step = max(1, PLAIN_SCORES // (heads * t * t))
    for a in range(0, nw, step):
        b = min(nw, a + step)
        q, k, v = qkv[a:b].float().reshape(b - a, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        s = (q @ k.transpose(-2, -1)) * scale + bias
        if mask is not None:
            s = s + mask[torch.arange(a, b, device=qkv.device) % per_sample][:, None]
        o = torch.softmax(s, dim=-1) @ v
        out[a:b] = o.transpose(1, 2).reshape(b - a, t, heads * hd).to(qkv.dtype)
    return out


_SIG = {"window_attention_bf16": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13
         + [ctypes.c_float, ctypes.c_void_p]}


def _lib() -> ctypes.CDLL:
    return _build.load_library("window_attention", ["window_attention.cu"], _SIG)


def window_attention_kernel(qkv: torch.Tensor, table: torch.Tensor, dims,
                            window, shift, scale: float) -> torch.Tensor:
    """The operator's CUDA implementation: ``csrc/window_attention.cu`` on
    a bf16 ``qkv`` of head dim 16, on the current stream (module
    docstring)."""
    per_sample, heads, hd = _geometry(qkv, table, dims, window, shift)
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"window_attention: no kernel for {qkv.dtype} (bf16 only)")
    if hd != HEAD_DIM:
        raise ValueError(f"window_attention: no kernel for head dim {hd} "
                         f"({HEAD_DIM} only)")
    wc = table_window(table)
    if wc > MAX_WINDOW:
        raise ValueError(f"window_attention: no kernel for a window of {wc} "
                         f"(at most {MAX_WINDOW})")
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 16:
        raise ValueError("window_attention: qkv must be 16-byte aligned")
    # each head's column contiguous and in the log2 domain of the kernel's ex2
    table_t = (table.to(device=qkv.device, dtype=torch.float32) * LOG2E).t().contiguous()
    nw, t, _ = qkv.shape
    out = torch.empty((nw, t, heads * hd), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = _lib().window_attention_bf16(
            qkv.data_ptr(), table_t.data_ptr(), out.data_ptr(), nw, t, *window,
            *padded(dims, window), *shift, wc, heads, float(scale) * LOG2E, stream)
    _build.check(rc, "window_attention (window_attention.cu)")
    _build.count_launch(window_attention, "launches_cuda")
    return out


def _fake(qkv, table, dims, window, shift, scale):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3))


# brats_torch::window_attention: the attention of every window and head
window_attention_op = library.define_op(
    "window_attention",
    "(Tensor qkv, Tensor table, int[] dims, int[] window, int[] shift, "
    "float scale) -> Tensor",
    window_attention_plain, window_attention_kernel, _fake)


def window_attention(qkv: torch.Tensor, table: torch.Tensor, dims, window,
                     shift, scale: float) -> torch.Tensor:
    """(windows, T, C) attention of ``qkv`` (windows, T, 3C) over windows of
    the grid ``dims`` with ``window`` and ``shift`` (module docstring);
    counts the call and its tokens."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"window_attention: no kernel for device {qkv.device}")
    per_sample = _geometry(qkv, table, dims, window, shift)[0]
    tokens = qkv.shape[0] * qkv.shape[1]
    with _build._count_lock:
        window_attention.launches += 1
        window_attention.tokens += tokens
        window_attention.padded_tokens += (
            tokens - qkv.shape[0] // per_sample * math.prod(dims))
    return window_attention_op(qkv, table, list(dims), list(window), list(shift),
                               float(scale))


window_attention.launches = 0
window_attention.launches_cuda = 0
window_attention.tokens = 0
window_attention.padded_tokens = 0
