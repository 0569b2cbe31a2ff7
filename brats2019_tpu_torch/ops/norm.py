"""Fused InstanceNorm3d + activation seam (reference:
``brats2019_tpu/ops/norm.py`` instance_norm_act, whose default jnp path is
:49-67, and ``ops/pallas_norm.py`` instance_norm_act_pallas with its VJP
``_in_act_fwd``/``_in_act_bwd`` :324-337).

NDHWC; statistics per (n, c) over the spatial axes, in f32, biased variance,
``eps`` inside the rsqrt; the output keeps ``x.dtype``.

* CPU tensor: the plain versions :func:`instance_norm_act_plain` and
  :func:`instance_norm_act_bwd_plain`.
* CUDA tensor: the Triton kernels of ``ops/triton_norm.py`` (bf16, the
  compute dtype of the path), or an error. There is no fallback.

``partials``: the f32 (3, N, P, C) per-box (count, mean, centred M2) of x
that the conv before the norm computed in its epilogue (``ops/conv.py``
``conv3d(..., stats=True)``). Given them, the forward skips its statistics
pass: it merges them (:func:`merge_partials_plain` on the CPU, the Triton
merge on CUDA) and applies, reading x once.

:func:`instance_norm_act` is an ``autograd.Function``: the forward saves x,
gamma, beta and the f32 (N, C) mean/rstd; the backward returns dx in
``x.dtype`` and dgamma, dbeta in f32, summed over n. act' is taken at
y_pre = xhat * gamma + beta with ``y_pre > 0`` (leaky: 0.01 at exactly 0),
as ``pallas_norm._act_grad`` (:118-123).

Activations: relu, leaky_relu (slope 0.01), none.

``instance_norm_act.launches`` and ``instance_norm_act_bwd.launches`` count
kernel launches (one per call); ``instance_norm_act.launches_partials`` those
of them that took the conv's partials.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

ACTIVATIONS = ("relu", "leaky_relu", "none")


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


def _check_kernel_input(x: torch.Tensor, activation: str) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; one of {ACTIVATIONS}")
    if x.dim() != 5:
        raise ValueError(f"instance_norm_act: expected NDHWC, got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"instance_norm_act kernel takes bf16, not {x.dtype}")


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
    """Launch the Triton forward on a CUDA NDHWC bf16 tensor: (y, the f32
    (N, C) mean, rstd); from the conv's ``partials`` when given (merge and
    apply), else statistics, finalize and apply."""
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
    _build.count_launch(instance_norm_act, "launches",
                        *(() if partials is None else ("launches_partials",)))
    return y3.view(n, d, h, w, c), mean, rstd


def instance_norm_act_bwd_kernel(x, g, gamma, beta, mean, rstd,
                                 activation: str = "relu"):
    """Launch the Triton backward on CUDA NDHWC bf16 x and g."""
    _check_kernel_input(x, activation)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"instance_norm_act_bwd: g {tuple(g.shape)} {g.dtype} "
                         f"vs x {tuple(x.shape)} {x.dtype}")
    from . import triton_norm

    n, d, h, w, c = x.shape
    x3 = x.contiguous().view(n, d * h * w, c)
    g3 = g.contiguous().view(n, d * h * w, c)
    dx3 = torch.empty_like(x3)
    f32 = lambda t: t.to(device=x.device, dtype=torch.float32).contiguous()
    with torch.cuda.device(x.device):
        dgamma, dbeta = triton_norm.launch_bwd(
            x3, g3, dx3, f32(mean), f32(rstd), f32(gamma), f32(beta), activation
        )
    _build.count_launch(instance_norm_act_bwd)
    return dx3.view(n, d, h, w, c), dgamma, dbeta


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


class _InstanceNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, activation, partials):
        if x.device.type == "cuda":
            y, mean, rstd = instance_norm_act_kernel(
                x, scale, bias, eps=eps, activation=activation,
                partials=partials)
        elif partials is None:
            y, mean, rstd = _plain_stats(x, scale, bias, eps, activation)
        else:
            _check_partials(partials, x)
            mean, rstd = merge_partials_plain(partials, eps)
            y = _plain_apply(x, mean, rstd, scale, bias, activation)
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
instance_norm_act_bwd.launches = 0
