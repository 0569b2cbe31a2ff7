"""Fused InstanceNorm3d + activation seam (reference:
``brats2019_tpu/ops/norm.py`` instance_norm_act, whose default jnp path is
:49-67, and ``ops/pallas_norm.py`` instance_norm_act_pallas).

NDHWC; statistics per (n, c) over the spatial axes, in f32, biased variance,
``eps`` inside the rsqrt; the output keeps ``x.dtype``.

* CPU tensor: the plain version :func:`instance_norm_act_plain`.
* CUDA tensor: the Triton kernels of ``ops/triton_norm.py`` (bf16, the
  compute dtype of the path), or an error. There is no fallback.

Activations: relu, leaky_relu (slope 0.01), none.

``instance_norm_act.launches`` counts kernel launches (one per call).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

ACTIVATIONS = ("relu", "leaky_relu", "none")


def _act(y: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(y)
    if activation == "leaky_relu":
        return F.leaky_relu(y, 0.01)
    if activation == "none":
        return y
    raise ValueError(f"unknown activation {activation!r}; one of {ACTIVATIONS}")


def instance_norm_act_plain(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    eps: float = 1e-5,
    activation: str = "relu",
) -> torch.Tensor:
    red = tuple(range(1, x.dim() - 1))
    xf = x.float()
    mu = xf.mean(red, keepdim=True)
    var = (xf - mu).square().mean(red, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return _act(y, activation).to(x.dtype)


def instance_norm_act_kernel(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    eps: float = 1e-5,
    activation: str = "relu",
) -> torch.Tensor:
    """Launch the Triton kernels on a CUDA NDHWC bf16 tensor."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; one of {ACTIVATIONS}")
    if x.dim() != 5:
        raise ValueError(f"instance_norm_act: expected NDHWC, got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"instance_norm_act kernel takes bf16, not {x.dtype}")
    from . import triton_norm

    n, d, h, w, c = x.shape
    x3 = x.contiguous().view(n, d * h * w, c)
    gamma = (torch.ones(c, device=x.device) if scale is None else scale)
    beta = (torch.zeros(c, device=x.device) if bias is None else bias)
    gamma = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    beta = beta.to(device=x.device, dtype=torch.float32).contiguous()
    y3 = torch.empty_like(x3)
    with torch.cuda.device(x.device):
        triton_norm.launch(x3, y3, gamma, beta, float(eps), activation)
    instance_norm_act.launches += 1
    return y3.view(n, d, h, w, c)


def instance_norm_act(
    x: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
    activation: str = "relu",
) -> torch.Tensor:
    """Fused InstanceNorm3d + activation. NDHWC; stats per (N, C)."""
    if x.device.type == "cpu":
        return instance_norm_act_plain(
            x, scale, bias, eps=eps, activation=activation
        )
    if x.device.type != "cuda":
        raise RuntimeError(f"instance_norm_act: no kernel for device {x.device}")
    return instance_norm_act_kernel(x, scale, bias, eps=eps, activation=activation)


instance_norm_act.launches = 0
