"""The Swin UNETR in plain PyTorch, float32: the benchmark's reference for a
configuration whose ``network`` section names ``swin_unetr``.

It follows Hatamizadeh et al., "Swin UNETR: Swin Transformers for Semantic
Segmentation of Brain Tumors in MRI Images" (arXiv:2201.01266, BraTS 2021)
as MONAI's ``SwinUNETR`` builds it, written out here from its layer
equations (NDHWC at the interface):

* encoder: a 2^3 stride-2 conv with bias (the patch embed); four stages of
  Swin blocks, ``x + proj(WA(LN1(x)))`` then ``x + W2 GELU(W1 LN2(x))``,
  each stage ending in a patch merging (the 2^3 neighbours concatenated in
  (d, h, w)-offset order, MONAI's ``mergingv2`` order; LayerNorm; a linear
  to 2C without bias); WA is multi-head self-attention inside 7^3 windows
  of the LN1 output zero-padded at the far side, every second block rolled
  by -3 first, ``softmax(q k^T / sqrt(d) + B + M) v``: B from the
  relative-position table by MONAI's ``relative_position_index``, M MONAI's
  ``compute_mask`` (0 or -100 between the regions of the rolled grid); an
  axis no longer than the window takes its length as its window and no
  shift (``get_window_size``). The hidden states (the patch embed's and each
  stage's output) pass a LayerNorm without affine;
* decoder: MONAI's ``UnetResBlock`` (conv3^3, IN, LeakyReLU 0.01, conv3^3,
  IN, plus the residual, 1^3 conv + IN where the channels change, then
  LeakyReLU; IN without affine), ``UnetrUpBlock`` (a 2^3 stride-2
  transposed conv without bias, the skip concatenated after it, a residual
  block) and a 1^3 head with bias.

Where a clamped window (an axis shorter than 7, never at 128^3) indexes the
table, the tokens' own offsets in that window give the row; MONAI slices
the 7^3 window's index there instead.

Parameters are a flat dict in the export naming that :func:`param_shapes`
lists (``params/swinViT/layers<s>/blocks_<i>/attn/qkv/kernel`` (in, out),
conv kernels DHWIO, LayerNorm ``scale`` and ``bias``). ``quant`` (a
:class:`unet.Quant`) rounds the operands of every conv and linear: the
control of the comparison that decides ``correct``. The attention runs a
block of windows at a time, so a 128^3 forward fits. It imports nothing of
the program.

:func:`program_flops` counts a volume's predict program (tiles x flips x
the forward's conv, linear and attention FLOPs, the attention on the padded
windows); :func:`window_attention_terms` the least bytes and FLOPs of one
call of the program's ``brats_torch::window_attention`` operator.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import yardstick
from . import unet
from .unet import Quant

EPS = 1e-5
SCORES = 1 << 25     # score elements a block of windows holds


def _dims(cfg: dict):
    fs = cfg["feature_size"]
    return [fs * 2 ** s for s in range(len(cfg["depths"]))]


def _check(cfg: dict) -> None:
    if cfg["patch_size"] != 2 or len(cfg["depths"]) != 4 or len(cfg["num_heads"]) != 4:
        raise ValueError("the reference implements patch size 2 and four stages")


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Flat parameter names and shapes of the Swin UNETR ``cfg``."""
    _check(cfg)
    fs, cin, k = cfg["feature_size"], cfg["in_channels"], cfg["num_classes"]
    table = (2 * cfg["window_size"] - 1) ** 3
    hidden = cfg["mlp_ratio"]
    out: Dict[str, Tuple[int, ...]] = {
        "params/swinViT/patch_embed/kernel": (2, 2, 2, cin, fs),
        "params/swinViT/patch_embed/bias": (fs,)}
    for s, (c, heads) in enumerate(zip(_dims(cfg), cfg["num_heads"]), 1):
        pre = f"params/swinViT/layers{s}/"
        for i in range(cfg["depths"][s - 1]):
            b = f"{pre}blocks_{i}/"
            out.update({
                b + "norm1/scale": (c,), b + "norm1/bias": (c,),
                b + "attn/relative_position_bias_table": (table, heads),
                b + "attn/qkv/kernel": (c, 3 * c), b + "attn/qkv/bias": (3 * c,),
                b + "attn/proj/kernel": (c, c), b + "attn/proj/bias": (c,),
                b + "norm2/scale": (c,), b + "norm2/bias": (c,),
                b + "mlp/linear1/kernel": (c, hidden * c),
                b + "mlp/linear1/bias": (hidden * c,),
                b + "mlp/linear2/kernel": (hidden * c, c), b + "mlp/linear2/bias": (c,)})
        out.update({pre + "downsample/norm/scale": (8 * c,),
                    pre + "downsample/norm/bias": (8 * c,),
                    pre + "downsample/reduction/kernel": (8 * c, 2 * c)})

    def res(name: str, ci: int, co: int) -> None:
        out[f"params/{name}/conv1/kernel"] = (3, 3, 3, ci, co)
        out[f"params/{name}/conv2/kernel"] = (3, 3, 3, co, co)
        if ci != co:
            out[f"params/{name}/conv3/kernel"] = (1, 1, 1, ci, co)

    for name, ci, co in _encoders(cfg):
        res(name, ci, co)
    for name, ci, co in _decoders(cfg):
        out[f"params/{name}/transp_conv/kernel"] = (2, 2, 2, ci, co)
        res(f"{name}/conv_block", 2 * co, co)
    out["params/out/kernel"] = (1, 1, 1, fs, k)
    out["params/out/bias"] = (k,)
    return out


def _encoders(cfg):
    fs = cfg["feature_size"]
    return [("encoder1", cfg["in_channels"], fs), ("encoder2", fs, fs),
            ("encoder3", 2 * fs, 2 * fs), ("encoder4", 4 * fs, 4 * fs),
            ("encoder10", 16 * fs, 16 * fs)]


def _decoders(cfg):
    fs = cfg["feature_size"]
    return [("decoder5", 16 * fs, 8 * fs), ("decoder4", 8 * fs, 4 * fs),
            ("decoder3", 4 * fs, 2 * fs), ("decoder2", 2 * fs, fs),
            ("decoder1", fs, fs)]


# ---------------------------------------------------------------- windows --

def get_window_size(size, window: int, shift: int):
    """MONAI's ``get_window_size``."""
    ws, ss = [window] * 3, [shift] * 3
    for i, s in enumerate(size):
        if s <= window:
            ws[i], ss[i] = s, 0
    return tuple(ws), tuple(ss)


def window_partition(x: torch.Tensor, ws) -> torch.Tensor:
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows: torch.Tensor, ws, dims) -> torch.Tensor:
    b, d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def relative_position_index(ws, wc: int) -> torch.Tensor:
    """MONAI's construction for a window ``ws`` and a (2 wc - 1)^3 table."""
    coords = torch.stack(torch.meshgrid(*(torch.arange(n) for n in ws), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel += wc - 1
    rel[:, :, 0] *= (2 * wc - 1) * (2 * wc - 1)
    rel[:, :, 1] *= 2 * wc - 1
    return rel.sum(-1)


def compute_mask(dims, ws, ss, device) -> torch.Tensor:
    """MONAI's ``compute_mask``: (windows, T, T) of 0 and -100."""
    d, h, w = dims
    img = torch.zeros((1, d, h, w, 1), device=device)
    cnt = 0
    cuts = [(slice(-n), slice(-n, -s), slice(-s, None)) for n, s in zip(ws, ss)]
    for a in cuts[0]:
        for b in cuts[1]:
            for c in cuts[2]:
                img[:, a, b, c, :] = cnt
                cnt += 1
    m = window_partition(img, ws).squeeze(-1)
    m = m.unsqueeze(1) - m.unsqueeze(2)
    return m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)


# ------------------------------------------------------------------ layers --

def _linear(x, k, b, quant: Optional[Quant]):
    if quant is not None:
        x, k = quant.operand(x), quant.operand(k)
    y = x @ k
    return y if b is None else y + b


def _layer_norm(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[name + "/scale"], p[name + "/bias"], EPS)


def _attention(x, p, b, heads, ws, ss, wc, quant):
    """WA over ``x`` (N, Dp, Hp, Wp, C), padded and rolled: (windows, T, C)."""
    n, dp, hp, wp, c = x.shape
    hd = c // heads
    windows = window_partition(x, ws)
    nw, t, _ = windows.shape
    qkv = _linear(windows, p[b + "attn/qkv/kernel"], p[b + "attn/qkv/bias"], quant)
    table = p[b + "attn/relative_position_bias_table"]
    bias = table[relative_position_index(ws, wc).to(x.device).reshape(-1)]
    bias = bias.reshape(t, t, heads).permute(2, 0, 1)
    mask = compute_mask((dp, hp, wp), ws, ss, x.device) if any(ss) else None
    per = nw // n
    out = torch.empty(nw, t, c, device=x.device)
    step = max(1, SCORES // (heads * t * t))
    for a in range(0, nw, step):
        e = min(nw, a + step)
        q, k, v = qkv[a:e].reshape(e - a, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        s = (q * hd ** -0.5) @ k.transpose(-2, -1) + bias
        if mask is not None:
            s = s + mask[torch.arange(a, e, device=x.device) % per].unsqueeze(1)
        o = torch.softmax(s, dim=-1) @ v
        out[a:e] = o.transpose(1, 2).reshape(e - a, t, c)
    return _linear(out, p[b + "attn/proj/kernel"], p[b + "attn/proj/bias"], quant)


def _block(x, p, b, heads, wc, shift, quant):
    n, d, h, w, _ = x.shape
    ws, ss = get_window_size((d, h, w), wc, shift)
    y = _layer_norm(x, p, b + "norm1")
    pads = [(n_ - s % n_) % n_ for s, n_ in zip((d, h, w), ws)]
    y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    dims = (n,) + tuple(y.shape[1:4])
    if any(ss):
        y = torch.roll(y, shifts=tuple(-s for s in ss), dims=(1, 2, 3))
    y = window_reverse(_attention(y, p, b, heads, ws, ss, wc, quant), ws, dims)
    if any(ss):
        y = torch.roll(y, shifts=ss, dims=(1, 2, 3))
    x = x + y[:, :d, :h, :w]
    y = _linear(_layer_norm(x, p, b + "norm2"), p[b + "mlp/linear1/kernel"],
                p[b + "mlp/linear1/bias"], quant)
    return x + _linear(F.gelu(y), p[b + "mlp/linear2/kernel"], p[b + "mlp/linear2/bias"],
                       quant)


def _merge(x, p, pre, quant):
    n, d, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    x = torch.cat([x[:, i::2, j::2, k::2, :]
                   for i, j, k in itertools.product(range(2), range(2), range(2))], -1)
    x = _layer_norm(x, p, pre + "downsample/norm")
    return _linear(x, p[pre + "downsample/reduction/kernel"], None, quant)


def _conv(x, k, quant, stride=1, padding=0, transposed=False):
    """NCDHW ``x``, DHWIO ``k``."""
    if quant is not None:
        x, k = quant.operand(x), quant.operand(k)
    if transposed:
        return F.conv_transpose3d(x, k.permute(3, 4, 0, 1, 2), stride=stride)
    return F.conv3d(x, k.permute(4, 3, 0, 1, 2), stride=stride, padding=padding)


def _inorm(y):
    """InstanceNorm without affine over NCDHW's spatial axes, biased variance
    (``F.instance_norm`` refuses a single voxel, which a 32^3 tile's deepest
    state has)."""
    mu = y.mean((2, 3, 4), keepdim=True)
    var = (y - mu).square().mean((2, 3, 4), keepdim=True)
    return (y - mu) * torch.rsqrt(var + EPS)


def _res(x, p, name, quant):
    inorm = _inorm
    y = F.leaky_relu(inorm(_conv(x, p[f"params/{name}/conv1/kernel"], quant, padding=1)),
                     0.01)
    y = inorm(_conv(y, p[f"params/{name}/conv2/kernel"], quant, padding=1))
    k3 = p.get(f"params/{name}/conv3/kernel")
    r = x if k3 is None else inorm(_conv(x, k3, quant))
    return F.leaky_relu(y + r, 0.01)


def forward(params: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor,
            quant: Optional[Quant] = None) -> torch.Tensor:
    """(N, D, H, W, C_in) f32 -> logits (N, D, H, W, K) f32, without TF32."""
    with unet.full_precision():
        return _forward(params, cfg, x.float(), quant)


def _forward(p, cfg, x, quant):
    _check(cfg)
    wc = cfg["window_size"]
    cn = lambda t: t.permute(0, 4, 1, 2, 3)        # NDHWC -> NCDHW
    hn = lambda t: t.permute(0, 2, 3, 4, 1)        # NCDHW -> NDHWC
    out = lambda t: F.layer_norm(t, (t.shape[-1],), eps=EPS) if cfg["normalize"] else t
    h = hn(_conv(cn(x), p["params/swinViT/patch_embed/kernel"], quant, stride=2)
           + p["params/swinViT/patch_embed/bias"][:, None, None, None])
    hidden = [out(h)]
    for s, heads in enumerate(cfg["num_heads"], 1):
        pre = f"params/swinViT/layers{s}/"
        for i in range(cfg["depths"][s - 1]):
            h = _block(h, p, f"{pre}blocks_{i}/", heads, wc, wc // 2 if i % 2 else 0, quant)
        h = _merge(h, p, pre, quant)
        hidden.append(out(h))
    hs = [cn(t) for t in hidden]
    enc = [_res(cn(x), p, "encoder1", quant)] + [
        _res(t, p, name, quant) for t, (name, _, _) in zip(hs[:3], _encoders(cfg)[1:4])]
    y = _res(hs[4], p, "encoder10", quant)
    for (name, _, _), skip in zip(_decoders(cfg), [hs[3]] + enc[::-1][:4]):
        up = _conv(y, p[f"params/{name}/transp_conv/kernel"], quant, stride=2,
                   transposed=True)
        y = _res(torch.cat([up, skip], 1), p, f"{name}/conv_block", quant)
    k = p["params/out/kernel"]
    return (torch.einsum("ncdhw,ck->ndhwk", y, k.reshape(k.shape[3], k.shape[4]))
            + p["params/out/bias"])


# ----------------------------------------------------------------- counts --

def forward_flops(cfg: dict, spatial) -> float:
    """FLOPs of one forward over a tile of ``spatial``: 2 per multiply-add
    of every conv, linear and attention product (the attention on the
    padded windows); norms, softmax and elementwise terms left out."""
    _check(cfg)
    vox = lambda sp: math.prod(sp)
    fs, wc = cfg["feature_size"], cfg["window_size"]
    total = 0.0
    sp = [s // 2 for s in spatial]
    total += 2.0 * vox(sp) * 8 * cfg["in_channels"] * fs            # patch embed
    for s, (c, heads) in enumerate(zip(_dims(cfg), cfg["num_heads"])):
        for i in range(cfg["depths"][s]):
            ws, _ = get_window_size(sp, wc, 0)
            grid = [-(-n // w) * w for n, w in zip(sp, ws)]
            t, windows = math.prod(ws), math.prod(g // w for g, w in zip(grid, ws))
            total += 2.0 * vox(grid) * c * 3 * c                        # qkv (padded)
            total += 4.0 * windows * heads * t * t * (c // heads)       # q k^T, a v
            total += 2.0 * vox(grid) * c * c                            # proj (padded)
            total += 2.0 * 2 * vox(sp) * c * cfg["mlp_ratio"] * c       # the MLP
        sp = [-(-n // 2) for n in sp]
        total += 2.0 * vox(sp) * 8 * c * 2 * c                          # merging

    def conv(spatial_, ci, co, k=3):
        return 2.0 * vox(spatial_) * ci * co * k ** 3

    def res(spatial_, ci, co):
        return conv(spatial_, ci, co) + conv(spatial_, co, co) + (
            conv(spatial_, ci, co, 1) if ci != co else 0.0)

    level = lambda lvl: [n // 2 ** lvl for n in spatial]
    for (_, ci, co), lvl in zip(_encoders(cfg), (0, 1, 2, 3, 5)):
        total += res(level(lvl), ci, co)
    for (_, ci, co), lvl in zip(_decoders(cfg), (4, 3, 2, 1, 0)):
        total += 2.0 * vox(level(lvl + 1)) * ci * 8 * co + res(level(lvl), 2 * co, co)
    return total + 2.0 * vox(spatial) * fs * cfg["num_classes"]


def program_flops(exp: dict) -> float:
    """One volume's predict program (``exp``: the configuration file's
    ``experiment``): the sweep's tiles x the flips x :func:`forward_flops`
    of a tile (plus the coarse U-Net when cascading)."""
    inf = exp["infer"]
    total, sweep = 0.0, list(inf["canvas"])
    if inf["cascade"] and exp.get("coarse_unet"):
        total += yardstick.unet_forward_flops(exp["coarse_unet"], inf["coarse_shape"])
        sweep = [min(r, c) for r, c in zip(inf["roi_shape"], sweep)]
    flips = 8 if inf["tta_flips"] else 1
    return total + (yardstick._tiles(sweep, inf["tile"], inf["overlap"]) * flips
                    * forward_flops(exp["unet"], inf["tile"]))


def window_attention_terms(shapes) -> Tuple[float, float]:
    """(bytes, FLOPs) of one ``brats_torch::window_attention`` call from
    its input shapes: qkv (windows, T, 3C) bf16 and the table (rows, heads)
    f32 read, the (windows, T, C) bf16 output written; 4 windows heads T^2
    head-dim FLOPs (q k^T and a v)."""
    (nw, t, c3), (rows, heads) = shapes[0], shapes[1]
    c = c3 // 3
    nbytes = 2.0 * nw * t * c3 + 4.0 * rows * heads + 2.0 * nw * t * c
    return nbytes, 4.0 * nw * heads * t * t * (c // heads)
