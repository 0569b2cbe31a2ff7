"""The 3^3 SAME conv seam (reference: ``brats2019_tpu/ops/pallas_conv.py``
conv3d_pallas and the flax/XLA conv of ``models/blocks.py:35-43``).

``conv3d(x, w)`` takes NDHWC ``x`` (N, D, H, W, Ci) and a DHWIO kernel
``w`` (3, 3, 3, Ci, Co), and returns (N, D, H, W, Co) in ``x.dtype``:

* on a CPU tensor, the plain version :func:`conv3d_plain` (f32 math);
* on a CUDA tensor, the hand-written kernel ``csrc/conv3d.cu`` (bf16 in,
  f32 accumulation, bf16 out), or an error. There is no fallback.

It is an ``autograd.Function``. ``conv3d_pallas`` has no VJP in the JAX
package (its gradient was XLA's), so the port builds one:

* dgrad: for a SAME stride-1 3^3 conv the input gradient is exactly the
  same conv of the output gradient with the spatially flipped,
  Ci<->Co-transposed weight (:func:`dgrad_weight`). It runs through
  :func:`conv3d` itself, so on CUDA it is the hand-written kernel and counts
  in ``conv3d.launches``; it is skipped where the input needs no grad (the
  stem's input).
* wgrad: plain torch (``aten.convolution_backward`` with only the weight
  mask), as the JAX package computed it outside any Pallas kernel. On CUDA
  it runs on the bf16 operands (cuDNN, f32 accumulation) with TF32 off and
  deterministic algorithms; on the CPU in f32.

``conv3d.launches`` counts kernel launches.

Two kernels sit behind the seam (the pattern of the reference's
``ops/norm.py`` ``set_backend``): ``"direct"`` (``csrc/conv3d.cu``, the
default) and ``"winograd"`` (``ops/winograd.py``, ``csrc/winograd3d.cu``; even
D, H, W only, launches counted in ``conv3d_winograd.launches``). The backward
is shared: dgrad goes through whichever backend is set, wgrad is plain torch.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, winograd

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
}


def _lib() -> ctypes.CDLL:
    return _build.load_library("conv3d", ["conv3d.cu"], _SIG)


def conv3d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3^3 conv in f32 on x's values, cast back to x.dtype."""
    xc = x.float().permute(0, 4, 1, 2, 3)            # NCDHW view of NDHWC
    wc = w.float().permute(4, 3, 0, 1, 2)            # DHWIO -> OIDHW
    y = F.conv3d(xc, wc, padding=1)
    return y.permute(0, 2, 3, 4, 1).contiguous().to(x.dtype)


def conv3d_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch csrc/conv3d.cu on CUDA bf16 tensors."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(
            f"conv3d kernel takes bf16 input and weight, got {x.dtype}, {w.dtype}"
        )
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"conv3d: bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    n, d, h, wd, ci = x.shape
    if w.shape[3] != ci:
        raise ValueError(f"conv3d: x has {ci} channels, w expects {w.shape[3]}")
    if w.device != x.device:
        raise ValueError("conv3d: x and w on different devices")
    if x.numel() == 0:
        raise ValueError("conv3d: empty input")
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


def _conv3d_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if _backend == "winograd":
        return winograd.conv3d_winograd(x, w)
    if x.device.type == "cpu":
        return conv3d_plain(x, w)
    return conv3d_kernel(x, w)


def dgrad_weight(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Ci, Co) -> (3, 3, 3, Co, Ci): w_t[t, co, ci] = w[2-t, ci, co]."""
    return w.flip(0, 1, 2).transpose(3, 4).contiguous()


def conv3d_wgrad(x: torch.Tensor, gy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dL/dw (DHWIO, w.dtype) of the SAME 3^3 conv for input x and output
    gradient gy (both NDHWC)."""
    on_cpu = x.device.type == "cpu"
    xc = (x.float() if on_cpu else x).permute(0, 4, 1, 2, 3)
    gc = (gy.float() if on_cpu else gy).permute(0, 4, 1, 2, 3)
    wc = (w.float() if on_cpu else w).permute(4, 3, 0, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        _, dw, _ = torch.ops.aten.convolution_backward(
            gc, xc, wc, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False,
            [0, 0, 0], 1, [False, True, False],
        )
    return dw.permute(2, 3, 4, 1, 0).to(w.dtype)


class _Conv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv3d_fwd(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _conv3d_fwd(gy, dgrad_weight(w))
        if ctx.needs_input_grad[1]:
            dw = conv3d_wgrad(x, gy, w)
        return dx, dw


def conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"conv3d: no kernel for device {x.device}")
    return _Conv3d.apply(x, w)


conv3d.launches = 0
