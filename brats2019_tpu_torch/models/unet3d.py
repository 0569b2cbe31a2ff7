"""3D U-Net encoder-decoder (reference: ``brats2019_tpu/models/unet3d.py``).

NDHWC throughout. Average-pool down, half-pixel trilinear up, skip concat,
an f32 1x1x1 head with bias; with ``stem_downsample=r>1`` the input is
space-to-depth'd by r before the first conv and the head's K*r^3 channels
are depth-to-space'd back (``subpixel=False`` returns them before that, for
the low-res TTA reduce). The casts sit where the JAX module has them: the
input to the compute dtype (:104), the skip concat (:135), the f32 head
(:148-154). The up and the skip concat are one op, ``ops.upsample2x_concat``
(the kernel writes the up half into the concat buffer).

Deep supervision (:132-145, 157-158): a config with ``deep_supervision``
has an f32 1x1x1 head ``aux_head_<lvl>`` after the decoder block of every
level > 0; ``forward(x, deep_outputs=True)`` then returns ``(logits,
[aux logits of the decoder levels, deepest first])``. ``remat_levels``
(:109-116): the ``DoubleConv`` blocks of the first N levels (encoder and
decoder) run under ``torch.utils.checkpoint`` (non-reentrant) when a
gradient is being recorded, so what their ops save for the backward is
rebuilt by running them again in the backward, not held; the module names
stay ``DoubleConv_<i>``, so checkpoints of any ``remat_levels`` are
interchangeable.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.presets import UNetConfig
from ..ops import downsample2x, upsample2x_concat
from .blocks import DoubleConv


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, D/r, H/r, W/r, C*r^3), channel order
    ((rd*r + rh)*r + rw)*C + c, as in the JAX package."""
    n, d, h, w, c = x.shape
    x = x.reshape(n, d // r, r, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(n, d // r, h // r, w // r, c * r * r * r)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, D, H, W, C*r^3) -> (N, D*r, H*r, W*r, C); inverse of the above."""
    n, d, h, w, c2 = x.shape
    c = c2 // (r * r * r)
    x = x.reshape(n, d, h, w, r, r, r, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(n, d * r, h * r, w * r, c)


class Conv1x1(nn.Module):
    """f32 1x1x1 conv with bias; ``kernel`` is (1, 1, 1, Ci, Co)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(1, 1, 1, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.reshape(self.kernel.shape[3], self.kernel.shape[4])
        return torch.matmul(x.float(), k.float()) + self.bias.float()


class UNet3D(nn.Module):
    """Returns logits (N, D, H, W, K) in f32. Blocks are named
    ``DoubleConv_<i>`` in the JAX package's creation order (encoder levels,
    then decoder levels from the bottom up, each followed by its
    ``aux_head_<lvl>`` under deep supervision)."""

    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        cfg = self.config = config
        dt = cfg.dtype
        r = cfg.stem_downsample
        c = cfg.in_channels * r ** 3
        i = 0
        for lvl in range(cfg.levels):
            self.add_module(f"DoubleConv_{i}", DoubleConv(
                c, cfg.feats(lvl), cfg.activation, dt))
            c = cfg.feats(lvl)
            i += 1
        for lvl in reversed(range(cfg.levels - 1)):
            self.add_module(f"DoubleConv_{i}", DoubleConv(
                c + cfg.feats(lvl), cfg.feats(lvl), cfg.activation, dt))
            c = cfg.feats(lvl)
            i += 1
            if cfg.deep_supervision and lvl > 0:
                self.add_module(f"aux_head_{lvl}", Conv1x1(c, cfg.num_classes))
        self.head = Conv1x1(c, cfg.num_classes * r ** 3)

    def _block(self, i: int, lvl: int, x: torch.Tensor) -> torch.Tensor:
        block = getattr(self, f"DoubleConv_{i}")
        if lvl < self.config.remat_levels and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False)
        return block(x)

    def forward(self, x: torch.Tensor, subpixel: bool = True,
                deep_outputs: bool = False):
        cfg = self.config
        dt = cfg.dtype
        x = x.to(dt)
        r = cfg.stem_downsample
        if r > 1:
            x = space_to_depth(x, r)
        deep = cfg.deep_supervision and deep_outputs
        i = 0
        skips = []
        for lvl in range(cfg.levels):
            x = self._block(i, lvl, x)
            i += 1
            if lvl < cfg.levels - 1:
                skips.append(x)
                x = downsample2x(x)
        aux_logits = []
        for lvl in reversed(range(cfg.levels - 1)):
            x = upsample2x_concat(x, skips[lvl].to(dt))
            x = self._block(i, lvl, x)
            i += 1
            if deep and lvl > 0:
                aux_logits.append(getattr(self, f"aux_head_{lvl}")(x))
        logits = self.head(x)
        if r > 1 and subpixel:
            logits = depth_to_space(logits, r)
        if deep:
            return logits, aux_logits
        return logits
