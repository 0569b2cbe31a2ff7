"""The 3D U-Net in plain PyTorch, float32: the benchmark's reference.

It follows the published architecture (a 3D U-Net, Cicek et al. 2016, with
InstanceNorm and ReLU as in Isensee et al. 2018, and the cascade of Jiang et
al., arXiv:1810.04008) as the configurations under ``perfbench/configs`` size
it: ``levels`` encoder levels of two 3x3x3 conv -> InstanceNorm -> ReLU
blocks, features ``min(base * 2**level, max)``, 2x average-pool down, 2x
trilinear up (half-pixel centres, edges clamped), the skip concatenated after
the up, a 1x1x1 head with bias, and with ``stem_downsample`` r > 1 a
space-to-depth of the input by r and a depth-to-space of the head's K*r^3
channels. Activations are (N, D, H, W, C) at the interface and NCDHW inside.

Parameters are a flat dict in the export naming (``params/DoubleConv_<i>/
ConvNormAct_<j>/Conv_0/kernel`` as DHWIO, ``in_scale``, ``in_bias``,
``head/kernel`` (1, 1, 1, Ci, Co), ``head/bias``). :func:`param_shapes` lists
them from a configuration alone, so the benchmark makes the weights without
asking the program. :func:`program_flops` is the frozen yardstick's count of
a volume's predict program.

``quant`` (a :class:`Quant`) rounds every conv's input and weight, and in a
backward every conv's output gradient, to a lower precision: the control of
the comparison that decides ``correct``. It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import yardstick

EPS_IN = 1e-5


def feats(cfg: dict, level: int) -> int:
    return min(cfg["base_features"] * 2 ** level, cfg["max_features"])


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Flat parameter names and shapes of the U-Net ``cfg``, in the order
    the export format lists them."""
    if cfg.get("deep_supervision"):
        raise ValueError("the reference has no deep-supervision heads")
    r = cfg["stem_downsample"]
    out: Dict[str, Tuple[int, ...]] = {}

    def double(i: int, ci: int, co: int) -> None:
        for j, c_in in enumerate((ci, co)):
            p = f"params/DoubleConv_{i}/ConvNormAct_{j}/"
            out[p + "Conv_0/kernel"] = (3, 3, 3, c_in, co)
            out[p + "in_scale"] = (co,)
            out[p + "in_bias"] = (co,)

    c, i = cfg["in_channels"] * r ** 3, 0
    for lvl in range(cfg["levels"]):
        double(i, c, feats(cfg, lvl))
        c, i = feats(cfg, lvl), i + 1
    for lvl in reversed(range(cfg["levels"] - 1)):
        double(i, c + feats(cfg, lvl), feats(cfg, lvl))
        c, i = feats(cfg, lvl), i + 1
    out["params/head/kernel"] = (1, 1, 1, c, cfg["num_classes"] * r ** 3)
    out["params/head/bias"] = (cfg["num_classes"] * r ** 3,)
    return out


def program_flops(exp: dict) -> float:
    """The conv FLOPs of one volume's predict program (``exp``: the
    configuration file's ``experiment``)."""
    return yardstick.predict_program_flops(exp)


@contextlib.contextmanager
def full_precision():
    """float32 matmuls and convolutions without TF32 (a card's default for
    cuDNN convolutions is TF32, a lower precision)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------ lower precision --

class _RoundGrad(torch.autograd.Function):
    """Identity forward; rounds the incoming gradient (the backward GEMM's
    operand) to ``dtype`` with a per-tensor scale."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x

    @staticmethod
    def backward(ctx, g):
        return round_scaled(g, ctx.dtype), None


def round_scaled(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (a float8 type) after scaling its largest
    magnitude to the type's largest finite value, then scaled back, in f32:
    the per-tensor scaling an fp8 GEMM uses."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale)


class Quant:
    """Round conv operands: inputs and weights to ``fwd`` (e4m3), output
    gradients to ``bwd`` (e5m2). The rounding of the forward operands passes
    the gradient straight through."""

    def __init__(self, fwd=torch.float8_e4m3fn, bwd=torch.float8_e5m2):
        self.fwd, self.bwd = fwd, bwd

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        q = round_scaled(x, self.fwd)
        return x + (q - x).detach() if x.requires_grad else q

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return _RoundGrad.apply(y, self.bwd) if y.requires_grad else y


# ------------------------------------------------------------------ forward --

def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, D, H, W, C) -> (N, D/r, H/r, W/r, C*r^3), channel order
    ((rd*r + rh)*r + rw)*C + c."""
    n, d, h, w, c = x.shape
    x = x.reshape(n, d // r, r, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(n, d // r, h // r, w // r,
                                                     c * r ** 3)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    n, d, h, w, c2 = x.shape
    c = c2 // r ** 3
    x = x.reshape(n, d, h, w, r, r, r, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(n, d * r, h * r, w * r, c)


def _conv_norm_relu(x, params, prefix, quant: Optional[Quant]):
    w = params[prefix + "Conv_0/kernel"].permute(4, 3, 0, 1, 2)   # OIDHW
    if quant is not None:
        x, w = quant.operand(x), quant.operand(w)
    y = F.conv3d(x, w, padding=1)
    if quant is not None:
        y = quant.output(y)
    y = F.instance_norm(y, weight=params[prefix + "in_scale"],
                        bias=params[prefix + "in_bias"], eps=EPS_IN)
    return F.relu(y)


def forward(params: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
            quant: Optional[Quant] = None) -> torch.Tensor:
    """(N, D, H, W, C_in) f32 -> logits (N, D, H, W, K) f32 at full
    resolution, without TF32."""
    with full_precision():
        return _forward(params, cfg, x, quant)


def _forward(params, cfg, x, quant):
    if cfg.get("activation", "relu") != "relu":
        raise ValueError("the reference implements ReLU only")
    r = cfg["stem_downsample"]
    x = x.float()
    if r > 1:
        x = space_to_depth(x, r)
    x = x.permute(0, 4, 1, 2, 3)
    i, skips = 0, []

    def block(x, i):
        for j in range(2):
            x = _conv_norm_relu(x, params, f"params/DoubleConv_{i}/ConvNormAct_{j}/",
                                quant)
        return x

    for lvl in range(cfg["levels"]):
        x = block(x, i)
        i += 1
        if lvl < cfg["levels"] - 1:
            skips.append(x)
            x = F.avg_pool3d(x, 2)
    for lvl in reversed(range(cfg["levels"] - 1)):
        up = F.interpolate(x, scale_factor=2, mode="trilinear", align_corners=False)
        x = block(torch.cat([up, skips[lvl]], dim=1), i)
        i += 1
    k = params["params/head/kernel"]
    k = k.reshape(k.shape[3], k.shape[4])
    logits = torch.einsum("ncdhw,ck->ndhwk", x, k) + params["params/head/bias"]
    return depth_to_space(logits, r) if r > 1 else logits

