"""The benchmark's yardstick, frozen: operation counts, bytes and the card's
peaks. Later changes to the program do not move it.

* :func:`unet_forward_flops`, :func:`predict_program_flops`,
  :func:`train_step_flops`: the convolutions' multiply-accumulates (2 FLOPs
  each) of the U-Net, of the whole-volume predict program (the coarse
  forward when cascading, then the fine forward on every tile of the sweep
  for each of the 8 flips) and of a training step (3x the forward, per
  patch); the norm, resize and softmax terms are left out;
* :func:`conv_terms`: the least bytes and operations of a direct 3x3x3 conv
  call in bf16 (every input and weight element read once, every output
  written once);
* the NVIDIA H100 SXM's published dense peaks (bf16 tensor cores, memory).
"""

from __future__ import annotations

import math

PEAK_BF16 = 989e12    # FLOP/s, dense, without sparsity (at 700 W)
PEAK_BW = 3.35e12     # bytes/s of HBM3


def feats(net: dict, level: int) -> int:
    return min(net["base_features"] * 2 ** level, net["max_features"])


def _conv(out_spatial, c_in: int, c_out: int, k: int = 3) -> float:
    return 2.0 * math.prod(out_spatial) * c_in * c_out * k ** 3


def unet_forward_flops(net: dict, spatial) -> float:
    r = net["stem_downsample"]
    sp = [s // r for s in spatial]
    c_in = net["in_channels"] * r ** 3
    total, enc = 0.0, []
    for lvl in range(net["levels"]):
        f = feats(net, lvl)
        total += _conv(sp, c_in, f) + _conv(sp, f, f)
        enc.append(f)
        c_in = f
        if lvl < net["levels"] - 1:
            sp = [s // 2 for s in sp]
    for lvl in reversed(range(net["levels"] - 1)):
        sp = [s * 2 for s in sp]
        f = feats(net, lvl)
        total += _conv(sp, c_in + enc[lvl], f) + _conv(sp, f, f)
        c_in = f
    return total + _conv(sp, c_in, net["num_classes"] * r ** 3, k=1)


def _tiles(shape, tile, overlap: float) -> int:
    n = 1
    for s, t in zip(shape, tile):
        if t >= s:
            continue
        stride = max(1, int(round(t * (1.0 - overlap))))
        steps = int(math.ceil((s - t) / stride)) + 1
        n *= len({int(round(v)) for v in (i * (s - t) / (steps - 1)
                                          for i in range(steps))})
    return n


def predict_program_flops(exp: dict) -> float:
    inf = exp["infer"]
    canvas = inf["canvas"]
    total = 0.0
    if inf["cascade"] and exp.get("coarse_unet"):
        total += unet_forward_flops(exp["coarse_unet"], inf["coarse_shape"])
        sweep = [min(r, c) for r, c in zip(inf["roi_shape"], canvas)]
    else:
        sweep = list(canvas)
    flips = 8 if inf["tta_flips"] else 1
    return total + (_tiles(sweep, inf["tile"], inf["overlap"]) * flips
                    * unet_forward_flops(exp["unet"], inf["tile"]))


def train_step_flops(net: dict, train: dict) -> float:
    return (3.0 * unet_forward_flops(net, train["patch"])
            * train["batch_per_device"] * max(train["grad_accum_steps"], 1))


def conv_terms(shape, itemsize: int = 2):
    """(bytes, FLOPs) of a direct 3x3x3 conv over (N, D, H, W, Ci) with Co
    outputs: ``shape`` = (N, D, H, W, Ci, Co)."""
    n, d, h, w, ci, co = shape
    m = n * d * h * w
    return itemsize * (m * ci + 27 * ci * co + m * co), 2.0 * 27 * ci * co * m


def conv_bound_s(shape) -> float:
    """The least time of the call: the larger of its bytes over the memory
    rate and its operations over the bf16 peak."""
    nbytes, flops = conv_terms(shape)
    return max(nbytes / PEAK_BW, flops / PEAK_BF16)

