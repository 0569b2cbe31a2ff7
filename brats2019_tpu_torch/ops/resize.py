"""Trilinear resizes for NDHWC volumes (reference:
``brats2019_tpu/ops/resize.py`` and ``ops/pallas_resize.py``).

* :func:`downsample2x` — exact 2x down, the 2^3 average pool.
* :func:`upsample2x` — exact 2x trilinear up: half-pixel taps (0.25, 0.75)
  with replicate-clamped edges.

Both run their plain version on a CPU tensor and the Triton kernels of
``ops/triton_resize.py`` on a CUDA bf16 tensor (or raise); ``.launches``
counts kernel launches.

* :func:`resize_trilinear` — arbitrary target shape, plain torch on every
  device, as the JAX package runs it outside any Pallas kernel. It is
  ``jax.image.resize(method="trilinear")``, which ANTIALIASES when it
  shrinks: the canvas -> coarse-grid resize is a separable 4-tap
  (1,3,3,1)/8 filter with edge rows renormalised to (3,3,1)/7, not
  ``F.interpolate``'s 2-tap average. The per-axis weight matrices are
  built in numpy f32 exactly as jax builds them and applied by einsum.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


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


# ----------------------------------------------------------------- kernels --

def _check5d(x: torch.Tensor, what: str) -> None:
    if x.dim() != 5:
        raise ValueError(f"{what}: expected NDHWC, got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16, not {x.dtype}")


def downsample2x_kernel(x: torch.Tensor) -> torch.Tensor:
    _check5d(x, "downsample2x")
    from . import triton_resize

    n, d, h, w, c = x.shape
    if min(d, h, w) < 2:
        raise ValueError(f"downsample2x: spatial dims < 2 in {tuple(x.shape)}")
    x = x.contiguous()
    y = torch.empty((n, d // 2, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        triton_resize.launch_down(x, y)
    downsample2x.launches += 1
    return y


def upsample2x_kernel(x: torch.Tensor) -> torch.Tensor:
    _check5d(x, "upsample2x")
    from . import triton_resize

    n, d, h, w, c = x.shape
    x = x.contiguous()
    y = torch.empty((n, 2 * d, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        triton_resize.launch_up(x, y)
    upsample2x.launches += 1
    return y


def downsample2x(x: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, D/2, H/2, W/2, C): 2^3 average pool."""
    if x.device.type == "cpu":
        return downsample2x_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"downsample2x: no kernel for device {x.device}")
    return downsample2x_kernel(x)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, 2D, 2H, 2W, C): 2x trilinear, half-pixel."""
    if x.device.type == "cpu":
        return upsample2x_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"upsample2x: no kernel for device {x.device}")
    return upsample2x_kernel(x)


downsample2x.launches = 0
upsample2x.launches = 0


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
        wmat = torch.from_numpy(linear_weight_matrix(n_in, n_out)).to(y.device)
        out = letters[:ax] + "z" + letters[ax + 1:]
        y = torch.einsum(f"{letters},{letters[ax]}z->{out}", y, wmat)
    return y.contiguous().to(x.dtype)
