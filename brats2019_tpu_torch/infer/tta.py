"""8-way flip test-time augmentation (reference: ``brats2019_tpu/infer/tta.py``).

The 8 variants are stacked into one batch of 8 so one forward serves them
all. The flip set and its order (identity first) are part of the spec: they
fix the f32 averaging order.
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence, Tuple

import torch

FLIPS: Tuple[Tuple[bool, bool, bool], ...] = tuple(
    itertools.product((False, True), repeat=3)
)


def store_dtype(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision == "bfloat16" else torch.float32


def flip_volume(x: torch.Tensor, flags: Sequence[bool]) -> torch.Tensor:
    """Flip spatial axes 0..2 of (X, Y, Z, C) where flags are set."""
    axes = [ax for ax, f in enumerate(flags) if f]
    return torch.flip(x, axes) if axes else x


def tta_stack(tile: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """The 8 flip variants of one tile, stacked into a batch of 8."""
    tile = tile.to(store_dtype(precision))
    return torch.stack([flip_volume(tile, f) for f in FLIPS])


def tta_reduce(probs: torch.Tensor) -> torch.Tensor:
    """Un-flip the per-variant probability maps and average (f32 acc)."""
    acc = torch.zeros(probs.shape[1:], dtype=torch.float32, device=probs.device)
    for i, f in enumerate(FLIPS):
        acc = acc + flip_volume(probs[i], f).float()
    return acc * (1.0 / len(FLIPS))


def tta_probs(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    tile: torch.Tensor,
    enabled: bool = True,
    precision: str = "float32",
) -> torch.Tensor:
    """Mean softmax probabilities over the 8 flip variants of one (X, Y, Z, C)
    tile (:29-55). ``apply_fn(batch (N,X,Y,Z,C)) -> logits (N,X,Y,Z,K)``.
    Disabled: the f32 softmax of one forward pass. Otherwise the 8-flip
    stack in one forward, softmax in f32, stored in the TTA dtype, unflipped
    and averaged in FLIPS order with f32 accumulation."""
    if not enabled:
        return torch.softmax(apply_fn(tile[None])[0].float(), dim=-1)
    probs = torch.softmax(apply_fn(tta_stack(tile, precision)).float(), dim=-1)
    return tta_reduce(probs.to(store_dtype(precision)))
