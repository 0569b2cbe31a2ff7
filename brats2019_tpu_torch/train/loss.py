"""Soft Dice (+ cross-entropy) segmentation loss (reference:
``brats2019_tpu/train/loss.py``, :17-143). All reductions in f32.

Mean soft Dice over the non-background classes plus cross-entropy, an
optional region (WT/TC/ET) Dice term and the deep-supervision aux term.
:func:`segmentation_loss_lowres` scores the pre-depth-to-space head output
against block-reshaped labels: the same value as the full-resolution form.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _onehot(labels: torch.Tensor, k: int) -> torch.Tensor:
    return F.one_hot(labels.long(), k).to(torch.float32)


def soft_dice_loss(
    logits: torch.Tensor,          # (N, ..., K)
    labels: torch.Tensor,          # (N, ...) int
    *,
    include_background: bool = False,
    eps: float = 1e-5,
) -> torch.Tensor:
    k = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = _onehot(labels, k)
    red = tuple(range(1, logits.dim() - 1))
    inter = (probs * onehot).sum(red)                   # (N, K)
    denom = (probs + onehot).sum(red)                   # (N, K)
    dice = (2.0 * inter + eps) / (denom + eps)
    if not include_background:
        dice = dice[:, 1:]
    return 1.0 - dice.mean()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = _onehot(labels, logits.shape[-1])
    return -(onehot * logp).sum(-1).mean()


# BraTS evaluation regions over internal classes (train/metrics.py)
_REGION_CLASSES = ((1, 2, 3), (1, 3), (3,))  # WT, TC, ET


def region_soft_dice_loss(
    logits: torch.Tensor, labels: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Soft Dice on the WT/TC/ET region probabilities (sums of class
    softmax)."""
    probs = torch.softmax(logits.float(), dim=-1)
    red = tuple(range(1, logits.dim() - 1))
    total = 0.0
    for classes in _REGION_CLASSES:
        p = sum(probs[..., c] for c in classes)
        g = sum((labels == c).to(torch.float32) for c in classes)
        inter = (p * g).sum(red)
        denom = (p + g).sum(red)
        total = total + (1.0 - ((2 * inter + eps) / (denom + eps)).mean())
    return total / len(_REGION_CLASSES)


def blockify_labels(labels: torch.Tensor, r: int) -> torch.Tensor:
    """(N, D, H, W) int labels -> (N, D/r, H/r, W/r, r, r, r): the channel
    structure of the pre-depth-to-space head output."""
    n, d, h, w = labels.shape
    x = labels.reshape(n, d // r, r, h // r, r, w // r, r)
    return x.permute(0, 1, 3, 5, 2, 4, 6)


def segmentation_loss_lowres(
    logits_lr: torch.Tensor,   # (N, D/r, H/r, W/r, K*r^3) pre-d2s head output
    labels: torch.Tensor,      # (N, D, H, W) int
    r: int,
    **kwargs,
) -> Tuple[torch.Tensor, dict]:
    """:func:`segmentation_loss` on the pre-depth-to-space head output:
    logits reshaped to (N, d, h, w, r, r, r, K), labels block-reshaped.
    Deep-supervision aux logits are not supported here."""
    n, d, h, w, kr3 = logits_lr.shape
    k = kr3 // (r ** 3)
    lb = logits_lr.reshape(n, d, h, w, r, r, r, k)
    return segmentation_loss(lb, blockify_labels(labels, r), **kwargs)


def _downsample_labels(labels: torch.Tensor, factor: int) -> torch.Tensor:
    """Stride-subsample integer labels (center offset), per aux-head scale."""
    o = factor // 2
    return labels[:, o::factor, o::factor, o::factor]


def segmentation_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    dice_weight: float = 1.0,
    ce_weight: float = 1.0,
    region_weight: float = 0.0,
    aux_logits: Optional[Sequence[torch.Tensor]] = None,
    aux_weight: float = 0.5,
) -> Tuple[torch.Tensor, dict]:
    """Dice(+CE) loss with optional region-Dice term and deep supervision:
    each aux head is scored against stride-subsampled labels with weights
    aux_weight^depth, normalised by their sum."""
    d = soft_dice_loss(logits, labels)
    ce = cross_entropy_loss(logits, labels)
    loss = dice_weight * d + ce_weight * ce
    aux = {"dice_loss": d, "ce_loss": ce}
    if region_weight > 0.0:
        rd = region_soft_dice_loss(logits, labels)
        loss = loss + region_weight * rd
        aux["region_dice_loss"] = rd
    if aux_logits:
        ordered = sorted(aux_logits, key=lambda al: -al.shape[1])
        w_total = 1.0
        acc = loss
        w = 1.0
        for al in ordered:
            factor = labels.shape[1] // al.shape[1]
            yl = _downsample_labels(labels, factor)
            w = w * aux_weight
            al_loss = (dice_weight * soft_dice_loss(al, yl)
                       + ce_weight * cross_entropy_loss(al, yl))
            acc = acc + w * al_loss
            w_total += w
        loss = acc / w_total
    aux["loss"] = loss
    return loss, aux
