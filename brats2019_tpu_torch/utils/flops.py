"""Analytic FLOPs of the U-Net and MFU on a CUDA card (reference:
``brats2019_tpu/utils/flops.py``, :19-82).

Counts multiply-accumulates in the 3D convolutions (2 FLOPs per MAC); the
norm/resize/softmax terms are omitted (their cost is bandwidth). A train
step is forward + backward ~= 3x forward.

The peak table is keyed on ``torch.cuda.get_device_name`` (NVIDIA's data
sheets, dense bf16 without sparsity). An unknown name gives no MFU rather
than a guess.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..configs.presets import ExperimentConfig, TrainConfig, UNetConfig
from ..infer.tiling import tile_origins


def _conv_flops(out_spatial, c_in: int, c_out: int, k: int = 3) -> float:
    vox = 1.0
    for s in out_spatial:
        vox *= s
    return 2.0 * vox * c_in * c_out * (k ** 3)


def unet_forward_flops(cfg: UNetConfig, spatial: Tuple[int, int, int]) -> float:
    """FLOPs of one UNet3D forward on an input of the given spatial shape
    (per sample; multiply by batch)."""
    r = cfg.stem_downsample
    sp = tuple(s // r for s in spatial)
    c_in = cfg.in_channels * r ** 3
    total = 0.0
    enc_feats = []
    for lvl in range(cfg.levels):
        f = cfg.feats(lvl)
        total += _conv_flops(sp, c_in, f) + _conv_flops(sp, f, f)
        enc_feats.append(f)
        c_in = f
        if lvl < cfg.levels - 1:
            sp = tuple(s // 2 for s in sp)
    for lvl in reversed(range(cfg.levels - 1)):
        sp = tuple(s * 2 for s in sp)
        f = cfg.feats(lvl)
        total += _conv_flops(sp, c_in + enc_feats[lvl], f) + _conv_flops(sp, f, f)
        c_in = f
    total += _conv_flops(sp, c_in, cfg.num_classes * r ** 3, k=1)
    return total


def predict_program_flops(exp: ExperimentConfig,
                          canvas: Tuple[int, int, int]) -> float:
    """FLOPs of the whole-volume predict program (reference :56-75): the
    coarse forward on the coarse grid when cascading, plus the fine forward
    on every tile of the sweep (the ROI, or the canvas without a cascade;
    ``infer/tiling.py`` grid) for each TTA flip."""
    total = 0.0
    if exp.infer.cascade and exp.coarse_unet is not None:
        total += unet_forward_flops(exp.coarse_unet, tuple(exp.infer.coarse_shape))
        sweep = tuple(min(r, c) for r, c in zip(exp.infer.roi_shape, canvas))
    else:
        sweep = tuple(canvas)
    n_tiles = len(tile_origins(sweep, tuple(exp.infer.tile), exp.infer.overlap))
    n_flips = 8 if exp.infer.tta_flips else 1
    total += n_tiles * n_flips * unet_forward_flops(exp.unet,
                                                    tuple(exp.infer.tile))
    return total


def train_step_flops(unet_cfg: UNetConfig, train_cfg: TrainConfig) -> float:
    """FLOPs of one train step of a stage (the stage's unet and train
    configs, as ``train.loop.stage_config`` gives them): 3x forward at the
    stage's patch x batch x accum."""
    fwd = unet_forward_flops(unet_cfg, tuple(train_cfg.patch))
    k = max(train_cfg.grad_accum_steps, 1)
    return 3.0 * fwd * train_cfg.batch_per_device * k


# Dense bf16 TFLOP/s by CUDA device name, "NVIDIA " prefix dropped.
PEAK_BF16_TFLOPS = {
    "H100 80GB HBM3": 989.0,   # H100 SXM5
    "H100 PCIe": 756.0,
}


def peak_tflops_for(device_name: str) -> Optional[float]:
    name = device_name.strip()
    if name.startswith("NVIDIA "):
        name = name[len("NVIDIA "):]
    return PEAK_BF16_TFLOPS.get(name)


def mfu(flops: float, seconds: float, device_name: str) -> Optional[float]:
    """Model FLOPs utilization in [0, 1], or None for an unknown device."""
    peak = peak_tflops_for(device_name)
    if peak is None or seconds <= 0:
        return None
    return flops / (seconds * peak * 1e12)
