"""The Swin UNETR's configuration (Hatamizadeh et al., arXiv:2201.01266,
BraTS 2021; the layer names of MONAI's ``SwinUNETR``).

It is not a preset: ``configs/presets.py`` holds the JAX package's presets
field for field, and the JAX package has no such network. A configuration
file names this class (``perfbench/configs/swin_unetr.json``), and
``utils/weights.py`` ``build_network`` builds ``models/swin_unetr.py``'s
``SwinUNETR`` from it. Its defaults are the published settings.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SwinUNETRConfig:
    in_channels: int = 4
    num_classes: int = 4
    feature_size: int = 48
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 2
    mlp_ratio: int = 4
    # the hidden states handed to the decoder pass a LayerNorm without affine
    normalize: bool = True
    compute_dtype: str = "bfloat16"  # "bfloat16" | "float32"

    @property
    def stem_downsample(self) -> int:
        """Full-resolution logits: ``models/cascade.py`` ``make_predict_fn``
        takes the monolithic sweep."""
        return 1

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def dim(self, stage: int) -> int:
        """Channels of the tokens at encoder stage ``stage`` (0-based)."""
        return self.feature_size * 2 ** stage
