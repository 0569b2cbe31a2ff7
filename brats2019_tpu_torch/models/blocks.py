"""3D conv building blocks (reference: ``brats2019_tpu/models/blocks.py``).

NDHWC activations; parameters are f32 and named as the JAX package's
flax variables (``Conv_0.kernel`` DHWIO, ``in_scale``, ``in_bias``), so the
weight bridge (``utils/weights.py``) is a rename. The compute dtype casts
the conv input and kernel, as flax's ``nn.Conv(dtype=...)`` does; the kernel
is cast once, when it is loaded, not on every forward.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import conv3d, instance_norm_act


class Conv3x3(nn.Module):
    """SAME 3^3 conv, no bias; ``kernel`` is DHWIO (3, 3, 3, Ci, Co) f32,
    ``kernel_c`` its copy in the compute dtype (not saved; refreshed on every
    ``load_state_dict``)."""

    def __init__(self, in_features: int, features: int,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(3, 3, 3, in_features, features))
        self.compute_dtype = compute_dtype
        self.register_buffer("kernel_c", self.kernel.detach().to(compute_dtype),
                             persistent=False)
        self.register_load_state_dict_post_hook(Conv3x3._cast_kernel)

    @staticmethod
    def _cast_kernel(module: "Conv3x3", _incompatible_keys) -> None:
        module.kernel_c = module.kernel.detach().to(module.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d(x.to(self.compute_dtype), self.kernel_c)


class ConvNormAct(nn.Module):
    """conv3x3x3 -> fused InstanceNorm+activation."""

    def __init__(self, in_features: int, features: int,
                 activation: str = "relu",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv3x3(in_features, features, compute_dtype)
        self.in_scale = nn.Parameter(torch.ones(features))
        self.in_bias = nn.Parameter(torch.zeros(features))
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm_act(
            self.Conv_0(x), self.in_scale, self.in_bias,
            activation=self.activation,
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
