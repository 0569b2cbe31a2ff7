"""Train-time augmentation on the device: flips, axial rot90, intensity
jitter, gamma (reference: ``brats2019_tpu/data/augment.py``).

Two layers: :func:`draw_augment` takes every random number from an explicit
``torch.Generator`` into an :class:`AugmentDraw`; :func:`apply_augment`
(and the ``apply_*`` pieces) are deterministic given it, so the tests can
feed them the JAX package's draws. Background (exact zeros) stays zero.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AugmentDraw:
    flips: Tuple[bool, bool, bool]   # random_flips' bernoulli bits
    rot_k: int                       # random_rot90_axial's k in [0, 4)
    scale: torch.Tensor              # (C,) f32, intensity_jitter
    shift: torch.Tensor              # (C,) f32
    gamma: Optional[torch.Tensor]    # (C,) f32, gamma_jitter (None: off)


def draw_augment(gen: torch.Generator, channels: int, scale_range: float = 0.1,
                 shift_range: float = 0.1, gamma_range: float = 0.0) -> AugmentDraw:
    flips = tuple(bool(b) for b in (torch.rand(3, generator=gen) < 0.5))
    rot_k = int(torch.randint(0, 4, (), generator=gen))
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(channels, generator=gen)
    scale = 1.0 + u(-scale_range, scale_range)
    shift = u(-shift_range, shift_range)
    gamma = None
    if gamma_range > 0:
        hi = math.log(1.0 + gamma_range)
        gamma = torch.exp(u(-hi, hi))
    return AugmentDraw(flips, rot_k, scale, shift, gamma)


def apply_flips(image, seg, flips):
    axes = [ax for ax in range(3) if flips[ax]]
    if axes:
        image, seg = torch.flip(image, axes), torch.flip(seg, axes)
    return image, seg


def _rot(x: torch.Tensor, k: int) -> torch.Tensor:
    """``random_rot90_axial``'s rotations r1, r2, r3 of the (0, 1) plane."""
    if k == 1:
        return torch.flip(x.transpose(0, 1), (0,))
    if k == 2:
        return torch.flip(x, (0, 1))
    if k == 3:
        return torch.flip(x.transpose(0, 1), (1,))
    return x


def apply_rot90_axial(image, seg, k: int):
    if image.shape[0] != image.shape[1]:
        raise ValueError(f"rot90 needs a square plane, got {tuple(image.shape)}")
    return _rot(image, k), _rot(seg, k)


def apply_intensity(image: torch.Tensor, scale, shift) -> torch.Tensor:
    """image * scale + shift per channel in f32 where image != 0."""
    dev = image.device
    y = image.float() * scale.to(dev) + shift.to(dev)
    return torch.where(image != 0, y, 0.0).to(image.dtype)


def apply_gamma(image: torch.Tensor, gamma) -> torch.Tensor:
    """Per-channel gamma on the min-max-normalised patch, rescaled back."""
    x = image.float()
    lo = x.amin(dim=(0, 1, 2))
    span = x.amax(dim=(0, 1, 2)) - lo + 1e-6
    xn = torch.clamp((x - lo) / span, 0.0, 1.0)
    xg = xn ** gamma.to(image.device) * span + lo
    return torch.where(image != 0, xg, 0.0).to(image.dtype)


def apply_augment(image, seg, draw: AugmentDraw, rot90: bool = False):
    """Flips (+ axial rot90), then intensity jitter (+ gamma)."""
    image, seg = apply_flips(image, seg, draw.flips)
    if rot90:
        image, seg = apply_rot90_axial(image, seg, draw.rot_k)
    image = apply_intensity(image, draw.scale, draw.shift)
    if draw.gamma is not None:
        image = apply_gamma(image, draw.gamma)
    return image, seg
