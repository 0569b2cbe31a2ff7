"""Frozen config dataclasses and the presets, field for field as in
``brats2019_tpu/configs/presets.py`` (tests/test_torch_configs.py pins every
field of every preset to the JAX package's).

``UNetConfig`` is copied from ``brats2019_tpu/models/unet3d.py`` because the
JAX module imports flax; its ``dtype`` here is a torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    num_classes: int = 4
    levels: int = 4                  # number of encoder levels incl. top
    base_features: int = 16
    max_features: int = 256
    activation: str = "relu"
    compute_dtype: str = "bfloat16"  # "bfloat16" | "float32"
    # space-to-depth by this factor before the first conv (and the sub-pixel
    # head after the last); 1 = plain full-resolution stem
    stem_downsample: int = 1
    deep_supervision: bool = False
    remat_levels: int = 0

    def feats(self, level: int) -> int:
        return min(self.base_features * (2 ** level), self.max_features)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def min_spatial(self) -> int:
        """Input spatial dims must be divisible by this."""
        return self.stem_downsample * 2 ** (self.levels - 1)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    patch: Tuple[int, int, int] = (128, 128, 128)
    coarse_patch: Tuple[int, int, int] = (64, 64, 64)
    pool_shape: Tuple[int, int, int] = (160, 224, 160)
    pool_cases_per_device: int = 4
    batch_per_device: int = 1
    fg_prob: float = 0.5
    grad_accum_steps: int = 1
    augment: bool = True
    intensity_scale: float = 0.1
    intensity_shift: float = 0.1
    rot90_axial: bool = False
    gamma_range: float = 0.0
    pool_refresh_every: int = 8
    prep_cache_dir: Optional[str] = None
    train_downsample: int = 1
    steps: int = 60000
    lr: float = 3e-4
    end_lr_frac: float = 0.01
    warmup_steps: int = 1000
    weight_decay: float = 1e-5
    grad_clip: float = 1.0
    ema_decay: float = 0.0
    dice_weight: float = 1.0
    ce_weight: float = 1.0
    region_weight: float = 0.0
    deep_supervision_weight: float = 0.5
    seed: int = 0
    log_every: int = 50
    eval_every: int = 1000
    checkpoint_every: int = 1000
    keep_checkpoints: int = 3
    debug_checks: bool = False


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    # static padded canvas every case is fitted to (None -> train.pool_shape)
    canvas: Optional[Tuple[int, int, int]] = (192, 224, 160)
    tile: Tuple[int, int, int] = (128, 128, 128)
    overlap: float = 0.5
    blend: str = "gaussian"
    gaussian_sigma_frac: float = 0.125
    tta_flips: bool = True           # 8-way flip TTA
    tta_precision: str = "bfloat16"  # flip/prob storage dtype, or "float32"
    min_component_voxels: int = 16
    et_min_voxels: int = 32
    postproc: str = "host"
    cascade: bool = True
    coarse_shape: Tuple[int, int, int] = (96, 112, 80)
    roi_shape: Tuple[int, int, int] = (128, 128, 128)
    compute_dtype: str = "bfloat16"
    # host->device payload: the brain-bbox crop rounded up to this bucket,
    # embedded into the zero canvas on the device (0 = ship the canvas)
    transfer_bucket: int = 16
    transfer_dtype: str = "bfloat16"
    serving_depth: int = 2
    prep_cache_dir: Optional[str] = None
    payload_memo_volumes: int = 8
    batch_volumes: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "default"
    unet: UNetConfig = UNetConfig()
    coarse_unet: Optional[UNetConfig] = None   # cascade stage 1 (None = no cascade)
    train: TrainConfig = TrainConfig()
    infer: InferenceConfig = InferenceConfig()
    workdir: str = "runs/default"


_FULL_UNET = UNetConfig(
    levels=4, base_features=64, max_features=320, stem_downsample=2
)
_COARSE_UNET = UNetConfig(
    levels=3, base_features=48, max_features=192, stem_downsample=2
)
_PARITY_UNET = UNetConfig(levels=5, base_features=24, max_features=256)

PRESETS = {
    "unit": ExperimentConfig(
        name="unit",
        unet=UNetConfig(levels=2, base_features=4, max_features=8,
                        compute_dtype="float32"),
        coarse_unet=None,
        train=TrainConfig(
            patch=(16, 16, 16),
            pool_shape=(32, 32, 32),
            pool_cases_per_device=1,
            batch_per_device=1,
            steps=4,
            warmup_steps=0,
            log_every=1,
            eval_every=0,
            checkpoint_every=0,
            pool_refresh_every=2,
        ),
        infer=InferenceConfig(
            canvas=None, tile=(16, 16, 16), tta_flips=False, cascade=False,
            compute_dtype="float32",
        ),
        workdir="runs/unit",
    ),
    "smoke": ExperimentConfig(
        name="smoke",
        unet=UNetConfig(levels=3, base_features=8, max_features=32,
                        compute_dtype="float32"),
        coarse_unet=None,
        train=TrainConfig(
            patch=(64, 64, 64),
            pool_shape=(96, 96, 80),
            pool_cases_per_device=1,
            steps=1,
            warmup_steps=0,
            log_every=1,
            eval_every=0,
            checkpoint_every=0,
        ),
        infer=InferenceConfig(
            canvas=None, tile=(64, 64, 64), tta_flips=False, cascade=False,
            compute_dtype="float32",
        ),
        workdir="runs/smoke",
    ),
    "single_chip": ExperimentConfig(
        name="single_chip",
        unet=_FULL_UNET,
        coarse_unet=None,
        train=TrainConfig(),
        infer=InferenceConfig(cascade=False),
        workdir="runs/single_chip",
    ),
    # the flagship: coarse localization -> fine 128^3 ROI with 8-flip TTA
    "cascade": ExperimentConfig(
        name="cascade",
        unet=_FULL_UNET,
        coarse_unet=_COARSE_UNET,
        train=TrainConfig(),
        infer=InferenceConfig(cascade=True),
        workdir="runs/cascade",
    ),
    "inference": ExperimentConfig(
        name="inference",
        unet=_FULL_UNET,
        coarse_unet=_COARSE_UNET,
        infer=InferenceConfig(cascade=True, tta_flips=True),
        workdir="runs/inference",
    ),
    "reference_parity": ExperimentConfig(
        name="reference_parity",
        unet=_PARITY_UNET,
        coarse_unet=None,
        train=TrainConfig(),
        infer=InferenceConfig(cascade=False),
        workdir="runs/reference_parity",
    ),
    "dp_v4_32": ExperimentConfig(
        name="dp_v4_32",
        unet=_FULL_UNET,
        coarse_unet=_COARSE_UNET,
        train=TrainConfig(batch_per_device=1, pool_cases_per_device=2),
        infer=InferenceConfig(cascade=True),
        workdir="runs/dp_v4_32",
    ),
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"Unknown preset '{name}'. Have: {sorted(PRESETS)}")
    return PRESETS[name]
