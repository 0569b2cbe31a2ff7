"""The Swin UNETR (Hatamizadeh et al., "Swin UNETR: Swin Transformers for
Semantic Segmentation of Brain Tumors in MRI Images", arXiv:2201.01266;
module and layer names those of MONAI's ``SwinUNETR``).

NDHWC throughout; (N, D, H, W, C_in) -> f32 logits (N, D, H, W, K) at full
resolution. With C = ``feature_size`` (48):

* encoder (``swinViT``): the patch embed, a 2^3 stride-2 conv with bias
  (a space-to-depth by 2, then a linear); four stages s = 1..4 of
  ``depths[s]`` Swin blocks at C 2^(s-1) channels and ``num_heads[s]``
  heads, each stage then a patch merging (the 2^3 neighbours concatenated in
  space-to-depth order, LayerNorm, a linear to twice the channels without
  bias). A Swin block: ``x + proj(WA(LN1(x)))``, then ``x + W2 GELU(W1
  LN2(x))`` (exact GELU, MLP ratio 4); WA is the window attention of
  ``ops/window_attention.py`` over 7^3 windows of the LN1 output zero-padded
  to whole windows, every second block rolled by -3 first (MONAI's
  ``get_window_size``: an axis no longer than the window takes its length as
  the window and no shift). The five hidden states handed to the decoder
  are the patch embed's and each stage's output, passed through a LayerNorm
  without affine (``normalize``);
* decoder: residual blocks ``Res(ci -> co)`` = conv3^3 -> IN -> LeakyReLU
  (0.01) -> conv3^3 -> IN, plus the residual (``IN(conv1^3(x))`` where ci
  != co, else x), then LeakyReLU (IN without affine, eps 1e-5; convs without
  bias); up blocks = a 2^3 stride-2 transposed conv without bias (a linear
  to 8 co, then a depth-to-space by 2), the skip concatenated after it,
  then ``Res(2 co -> co)``; ``enc0 = encoder1(x)`` at full resolution,
  ``encoder2..4`` on the first three hidden states, ``encoder10`` on the
  last, the five up blocks back to full resolution, and an f32 1^3 head
  with bias.

Precision (``compute_dtype`` bf16): the linears, convs and the attention
take bf16 operands with f32 accumulation; the residual stream of the
encoder, the LayerNorms and the softmax are f32. The 3^3 convs are
``ops.conv3d`` (``models/blocks.py``'s ``Conv3x3``) and their IN is
``ops.instance_norm_act`` from the conv's statistics epilogue where its
route has one, with scale 1 and bias 0 as constants; the linears, the
LayerNorms, GELU, the partition and roll around the attention, the
patch embed and merging and the transposed convs are ATen calls.

Parameters are f32 in the flat export naming of
``perfbench/reference/swin_unetr.py`` ``param_shapes`` (``kernel`` matrices
(in, out), conv kernels DHWIO, LayerNorm ``scale`` and ``bias``); every
matrix is used through a compute-dtype copy, cached and re-cast as
``Conv3x3``'s kernel is.

Spans (``utils/profile.py``): ``swin.encoder`` and ``swin.decoder``, with
device edges, around the two halves of each forward.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.swin_unetr import SwinUNETRConfig
from ..ops import instance_norm_act, window_attention
from ..ops.window_attention import padded, window_and_shift
from ..utils import profile
from .blocks import Conv3x3, cached_cast
from .unet3d import Conv1x1, depth_to_space, space_to_depth

EPS = 1e-5
SLOPE = 0.01


class Linear(nn.Module):
    """``x @ M + bias`` in the compute dtype, M the (in, out) matrix that
    :meth:`matrix` makes of ``kernel`` (here ``kernel`` itself). The f32
    parameters are cast on every forward while a gradient is taken or a
    program is traced, else a copy is kept (not saved) until a parameter
    has changed (its version, storage or device), as ``Conv3x3``'s kernel."""

    def __init__(self, shape: Sequence[int], bias: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.zeros(tuple(shape)))
        self.bias = nn.Parameter(torch.zeros(shape[-1])) if bias else None
        self._cast, self._cast_key = None, None

    def matrix(self) -> torch.Tensor:
        return self.kernel

    def _make(self):
        dt = self.compute_dtype
        return (self.matrix().t().to(dt).contiguous(),
                None if self.bias is None else self.bias.to(dt))

    def cast(self):
        params = list(self.parameters(recurse=False))
        if torch.compiler.is_compiling() or (
                torch.is_grad_enabled() and any(p.requires_grad for p in params)):
            return self._make()
        return cached_cast(self, "_cast", params, self._make)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.compute_dtype), *self.cast())


class PatchEmbed(Linear):
    """The 2^3 stride-2 conv with bias, ``kernel`` DHWIO (2, 2, 2, Ci, C):
    a space-to-depth by 2, then a linear."""

    def matrix(self) -> torch.Tensor:
        return self.kernel.reshape(-1, self.kernel.shape[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(space_to_depth(x, self.kernel.shape[0]))


class UpConv(Linear):
    """The 2^3 stride-2 transposed conv without bias, ``kernel`` (2, 2, 2,
    Ci, Co): a linear to 8 Co in (kd, kh, kw, co) order, then a
    depth-to-space by 2."""

    def matrix(self) -> torch.Tensor:
        k = self.kernel
        return k.permute(3, 0, 1, 2, 4).reshape(k.shape[3], -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depth_to_space(super().forward(x), 2)


class Pointwise(Linear):
    """The residual's 1^3 conv without bias, ``kernel`` (1, 1, 1, Ci, Co)."""

    def matrix(self) -> torch.Tensor:
        return self.kernel.reshape(self.kernel.shape[3], self.kernel.shape[4])


class LayerNorm(nn.Module):
    """LayerNorm over channels in f32 (eps 1e-5), with ``scale`` and
    ``bias``; f32 out."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale, self.bias, EPS)


def partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """(N, D, H, W, C) -> (N * windows, wd * wh * ww, C), windows row-major
    per sample (MONAI's ``window_partition``)."""
    n, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.reshape(n, d // wd, wd, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, c)


def reverse(x: torch.Tensor, window: Sequence[int], grid: Sequence[int]) -> torch.Tensor:
    """The inverse of :func:`partition` onto ``grid`` (N, D, H, W)."""
    n, d, h, w = grid
    wd, wh, ww = window
    x = x.reshape(n, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(n, d, h, w, -1)


class WindowAttention(nn.Module):
    """``proj(WA(qkv(windows)))``; ``relative_position_bias_table``
    ((2 w - 1)^3, heads) f32."""

    def __init__(self, c: int, heads: int, window: int, compute_dtype: torch.dtype):
        super().__init__()
        self.scale = (c // heads) ** -0.5
        self.qkv = Linear((c, 3 * c), True, compute_dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, heads))
        self.proj = Linear((c, c), True, compute_dtype)

    def forward(self, windows, dims, window, shift) -> torch.Tensor:
        a = window_attention(self.qkv(windows), self.relative_position_bias_table,
                             dims, window, shift, self.scale)
        return self.proj(a)


class Mlp(nn.Module):
    def __init__(self, c: int, hidden: int, compute_dtype: torch.dtype):
        super().__init__()
        self.linear1 = Linear((c, hidden), True, compute_dtype)
        self.linear2 = Linear((hidden, c), True, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x)))


class SwinBlock(nn.Module):
    """One Swin block on the f32 residual stream (N, D, H, W, C)."""

    def __init__(self, cfg: SwinUNETRConfig, c: int, heads: int, shifted: bool):
        super().__init__()
        dt = cfg.dtype
        self.window, self.shift = cfg.window_size, cfg.window_size // 2 if shifted else 0
        self.norm1 = LayerNorm(c)
        self.attn = WindowAttention(c, heads, cfg.window_size, dt)
        self.norm2 = LayerNorm(c)
        self.mlp = Mlp(c, cfg.mlp_ratio * c, dt)
        self.compute_dtype = dt

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, d, h, w, _ = x.shape
        ws, ss = window_and_shift((d, h, w), self.window, self.shift)
        grid = padded((d, h, w), ws)
        y = self.norm1(x).to(self.compute_dtype)
        y = F.pad(y, (0, 0, 0, grid[2] - w, 0, grid[1] - h, 0, grid[0] - d))
        if any(ss):
            y = torch.roll(y, tuple(-s for s in ss), (1, 2, 3))
        y = reverse(self.attn(partition(y, ws), (d, h, w), ws, ss), ws, (n,) + grid)
        if any(ss):
            y = torch.roll(y, ss, (1, 2, 3))
        x = x + y[:, :d, :h, :w]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """(N, D, H, W, C) -> (N, D/2, H/2, W/2, 2C): the 2^3 neighbours in
    space-to-depth order, LayerNorm, a linear without bias; f32 out (the
    input's axes are even: ``SwinUNETR`` takes multiples of 32)."""

    def __init__(self, c: int, compute_dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(8 * c)
        self.reduction = Linear((8 * c, 2 * c), False, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduction(self.norm(space_to_depth(x, 2))).float()


class Stage(nn.Module):
    """MONAI's ``BasicLayer``: ``blocks_<i>``, then ``downsample``."""

    def __init__(self, cfg: SwinUNETRConfig, stage: int):
        super().__init__()
        c, heads = cfg.dim(stage), cfg.num_heads[stage]
        self.depth = cfg.depths[stage]
        for i in range(self.depth):
            self.add_module(f"blocks_{i}", SwinBlock(cfg, c, heads, i % 2 == 1))
        self.downsample = PatchMerging(c, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x)
        return self.downsample(x)


class SwinTransformer(nn.Module):
    """The encoder: the five hidden states (f32)."""

    def __init__(self, cfg: SwinUNETRConfig):
        super().__init__()
        self.normalize = cfg.normalize
        p = cfg.patch_size
        self.patch_embed = PatchEmbed((p, p, p, cfg.in_channels, cfg.feature_size), True,
                                      cfg.dtype)
        self.stages = len(cfg.depths)
        for s in range(self.stages):
            self.add_module(f"layers{s + 1}", Stage(cfg, s))

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), eps=EPS) if self.normalize else x

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.patch_embed(x).float()
        hidden = [self._out(x)]
        for s in range(self.stages):
            x = getattr(self, f"layers{s + 1}")(x)
            hidden.append(self._out(x))
        return hidden


class ResBlock(nn.Module):
    """MONAI's ``UnetResBlock`` (module docstring); ``conv3`` only where
    ci != co."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv3x3(cin, cout, compute_dtype)
        self.conv2 = Conv3x3(cout, cout, compute_dtype)
        self.conv3 = (Pointwise((1, 1, 1, cin, cout), False, compute_dtype)
                      if cin != cout else None)
        # the IN's scale and bias: constants, not parameters
        self.register_buffer("one", torch.ones(cout), persistent=False)
        self.register_buffer("zero", torch.zeros(cout), persistent=False)

    def _norm(self, y, partials=None, activation="none"):
        return instance_norm_act(y, self.one, self.zero, eps=EPS,
                                 activation=activation, partials=partials)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._norm(*self.conv1(x, stats=True), activation="leaky_relu")
        y = self._norm(*self.conv2(y, stats=True))
        r = x if self.conv3 is None else self._norm(self.conv3(x))
        return F.leaky_relu(y + r, SLOPE)


class UpBlock(nn.Module):
    """MONAI's ``UnetrUpBlock``: ``transp_conv``, the skip, ``conv_block``."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__()
        self.transp_conv = UpConv((2, 2, 2, cin, cout), False, compute_dtype)
        self.conv_block = ResBlock(2 * cout, cout, compute_dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], -1))


class SwinUNETR(nn.Module):
    """(N, D, H, W, C_in) -> f32 logits (N, D, H, W, K); D, H, W multiples
    of 32."""

    def __init__(self, config: SwinUNETRConfig = SwinUNETRConfig()):
        super().__init__()
        cfg = self.config = config
        if cfg.patch_size != 2 or len(cfg.depths) != 4 or len(cfg.num_heads) != 4:
            raise ValueError("SwinUNETR: patch size 2 and four stages only")
        dt, fs = cfg.dtype, cfg.feature_size
        self.swinViT = SwinTransformer(cfg)
        self.encoder1 = ResBlock(cfg.in_channels, fs, dt)
        self.encoder2 = ResBlock(fs, fs, dt)
        self.encoder3 = ResBlock(2 * fs, 2 * fs, dt)
        self.encoder4 = ResBlock(4 * fs, 4 * fs, dt)
        self.encoder10 = ResBlock(16 * fs, 16 * fs, dt)
        for i, (ci, co) in zip((5, 4, 3, 2, 1), ((16, 8), (8, 4), (4, 2), (2, 1), (1, 1))):
            self.add_module(f"decoder{i}", UpBlock(ci * fs, co * fs, dt))
        self.out = Conv1x1(fs, cfg.num_classes)

    @property
    def min_spatial(self) -> int:
        return 2 * 2 ** len(self.config.depths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if any(s % self.min_spatial for s in x.shape[1:4]):
            raise ValueError(f"SwinUNETR: spatial dims {tuple(x.shape[1:4])} are not "
                             f"multiples of {self.min_spatial}")
        dt = self.config.dtype
        x = x.to(dt)
        with profile.span("swin.encoder", device_edges=True):
            hs = [h.to(dt) for h in self.swinViT(x)]
        with profile.span("swin.decoder", device_edges=True):
            enc = [self.encoder1(x), self.encoder2(hs[0]), self.encoder3(hs[1]),
                   self.encoder4(hs[2])]
            y = self.decoder5(self.encoder10(hs[4]), hs[3])
            for i, skip in zip((4, 3, 2, 1), reversed(enc)):
                y = getattr(self, f"decoder{i}")(y, skip)
            return self.out(y)

