"""Winograd F(2x2x2, 3x3x3) conv3d (reference:
``brats2019_tpu/ops/pallas_winograd.py`` conv3d_winograd): the second
backend of the 3^3 SAME conv seam (``ops/conv.py`` ``set_backend``).

``conv3d_winograd(x, w)`` takes NDHWC ``x`` (N, D, H, W, Ci) with even D, H,
W and a DHWIO kernel ``w`` (3, 3, 3, Ci, Co), and returns (N, D, H, W, Co) in
``x.dtype``:

* on a CPU tensor, the plain version :func:`conv3d_winograd_plain`: the same
  decomposition step by step in f32 (U = (G x G x G) g, V = B^T d B on the
  unfolded 4^3 tiles, 64 per-point matmuls, A^T);
* on a CUDA tensor, the hand-written kernel ``csrc/winograd3d.cu`` (bf16 in,
  V made in f32 and rounded to bf16 once, f32 accumulation, bf16 out), or an
  error. There is no fallback, and odd D/H/W raise as in the reference.

The weight transform runs outside the kernel in the reference (an XLA
einsum) and here (a torch einsum); its bf16, zero-padded result is cached
per weight tensor and version, so a served model transforms each kernel
once. ``conv3d_winograd.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading
import weakref

import torch
import torch.nn.functional as F

from . import _build

# F(2,3) matrices (Lavin & Gray 2016), exact in binary floating point
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))

_SIG = {
    "winograd3d_ndhwc_bf16": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
}
# the kernel's channel chunk and Co block: U is zero-padded to multiples
_CI_PAD, _CO_PAD = 32, 64

_u_cache: dict = {}
_u_lock = threading.Lock()
_g_cache: dict = {}


def _lib() -> ctypes.CDLL:
    return _build.load_library("winograd3d", ["winograd3d.cu"], _SIG)


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


def padded_u(w: torch.Tensor) -> torch.Tensor:
    """The kernel's weight operand: ``transform_weights(w)`` in bf16,
    zero-padded to (64, Ci up to 32k, Co up to 64k). Cached per weight tensor
    (weakly) and version counter, under a lock, so the threads of a serving
    process share one transform per kernel."""
    version = None if w.is_inference() else w._version
    key = id(w)
    with _u_lock:
        ent = _u_cache.get(key)
        if (ent is not None and ent[0]() is w and ent[1] == version
                and ent[2] == w.data_ptr()):
            return ent[3]
    ci, co = w.shape[3], w.shape[4]
    cip = -(-ci // _CI_PAD) * _CI_PAD
    cop = -(-co // _CO_PAD) * _CO_PAD
    with torch.no_grad():
        u = torch.zeros((64, cip, cop), dtype=torch.bfloat16, device=w.device)
        u[:, :ci, :co] = transform_weights(w.detach()).to(torch.bfloat16)
    with _u_lock:
        for k in [k for k, e in _u_cache.items() if e[0]() is None]:
            del _u_cache[k]
        _u_cache[key] = (weakref.ref(w), version, w.data_ptr(), u)
    return u


def conv3d_winograd_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch csrc/winograd3d.cu on CUDA bf16 tensors."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError("conv3d_winograd kernel takes bf16 input and weight, "
                        f"got {x.dtype}, {w.dtype}")
    _check_shapes(x, w)
    if w.device != x.device:
        raise ValueError("conv3d_winograd: x and w on different devices")
    n, d, h, wd, ci = x.shape
    co = w.shape[4]
    x = x.contiguous()
    u = padded_u(w)
    y = torch.empty((n, d, h, wd, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().winograd3d_ndhwc_bf16(
            x.data_ptr(), u.data_ptr(), y.data_ptr(), n, d, h, wd, ci, co,
            u.shape[1], u.shape[2], stream,
        )
    _build.check(rc, "conv3d_winograd")
    _build.count_launch(conv3d_winograd)
    return y


def conv3d_winograd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version on a CPU tensor, the kernel on a CUDA tensor.
    Forward only, as the reference (which has no VJP); under autograd use
    ``ops.conv.conv3d`` with ``set_backend("winograd")``."""
    if x.device.type == "cpu":
        return conv3d_winograd_plain(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3d_winograd: no kernel for device {x.device}")
    return conv3d_winograd_kernel(x, w)


conv3d_winograd.launches = 0
