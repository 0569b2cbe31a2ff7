"""3D conv building blocks (reference: ``brats2019_tpu/models/blocks.py``).

NDHWC activations; parameters are f32 and named as the JAX package's
flax variables (``Conv_0.kernel`` DHWIO, ``in_scale``, ``in_bias``), so the
weight bridge (``utils/weights.py``) is a rename. The compute dtype casts
the conv input and kernel, as flax's ``nn.Conv(dtype=...)`` does. When the
f32 kernel takes a gradient, the cast runs inside the autograd graph on
every forward, as it does in a traced program (``torch.export``, where the
kernel is an input); otherwise (eval, ``torch.inference_mode``) a cached
copy in the compute dtype is used, re-cast whenever the kernel has changed
(an optimizer step, a load, a move to another device).
"""

from __future__ import annotations

import threading

import torch
from torch import nn

from ..ops import conv3d, instance_norm_act


# guards every cached compute-dtype copy (Conv3x3's kernel, the Swin UNETR's
# linears): a serving process has prep and post threads beside the thread
# that runs the forward
_cast_lock = threading.Lock()


def cached_cast(owner: nn.Module, attr: str, params, make):
    """``make()``, the compute-dtype copy of ``params``, kept as
    ``owner.<attr>`` and made again once a parameter has changed: the key is
    each parameter's version counter (None for one made under
    ``torch.inference_mode``, which has none and cannot be updated outside
    it), storage and device, kept as ``owner._cast_key``."""
    key = tuple((None if p.is_inference() else p._version, p.data_ptr(), p.device)
                for p in params)
    with _cast_lock:
        if owner._cast_key != key or getattr(owner, attr) is None:
            with torch.no_grad():
                setattr(owner, attr, make())
            owner._cast_key = key
        return getattr(owner, attr)


class Conv3x3(nn.Module):
    """SAME 3^3 conv, no bias; ``kernel`` is DHWIO (3, 3, 3, Ci, Co) f32,
    ``kernel_c`` its cached copy in the compute dtype (not saved), keyed on
    the kernel's version counter, storage and device."""

    def __init__(self, in_features: int, features: int,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, 3, in_features, features))
        self.compute_dtype = compute_dtype
        self.register_buffer("kernel_c", None, persistent=False)
        self._cast_key = None
        self.register_load_state_dict_post_hook(Conv3x3._on_load)

    @staticmethod
    def _on_load(module: "Conv3x3", _incompatible_keys) -> None:
        module.cached_kernel()

    def cached_kernel(self) -> torch.Tensor:
        return cached_cast(self, "kernel_c", (self.kernel,),
                           lambda: self.kernel.detach().to(self.compute_dtype))

    def forward(self, x: torch.Tensor, stats: bool = False):
        """y, or with ``stats`` (y, the InstanceNorm partials of y or None):
        ``ops.conv3d``."""
        if torch.compiler.is_compiling() or (
                torch.is_grad_enabled() and self.kernel.requires_grad):
            # traced (an export: the kernel is a program input) or taking a
            # gradient: the cast is part of the program
            w = self.kernel.to(self.compute_dtype)
        else:
            w = self.cached_kernel()
        return conv3d(x.to(self.compute_dtype), w, stats=stats)


class ConvNormAct(nn.Module):
    """conv3x3x3 -> fused InstanceNorm+activation; the norm takes its
    statistics from the conv's epilogue where the conv's route gives them."""

    def __init__(self, in_features: int, features: int,
                 activation: str = "relu",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv3x3(in_features, features, compute_dtype)
        self.in_scale = nn.Parameter(torch.ones(features))
        self.in_bias = nn.Parameter(torch.zeros(features))
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, partials = self.Conv_0(x, stats=True)
        return instance_norm_act(
            y, self.in_scale, self.in_bias, activation=self.activation,
            partials=partials,
        )


class DoubleConv(nn.Module):
    """{conv -> IN+act} x2 — the level block."""

    def __init__(self, in_features: int, features: int,
                 activation: str = "relu",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(in_features, features, activation,
                                         compute_dtype)
        self.ConvNormAct_1 = ConvNormAct(features, features, activation,
                                         compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvNormAct_1(self.ConvNormAct_0(x))
