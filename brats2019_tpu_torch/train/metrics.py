"""BraTS region Dice on internal labels {0,1,2,3} (copy of the NumPy part of
``brats2019_tpu/train/metrics.py``, :17-47; the original imports jax).

Regions: WT = {1, 2, 3}, TC = {1, 3}, ET = {3}.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

REGIONS = {
    "WT": (1, 2, 3),
    "TC": (1, 3),
    "ET": (3,),
}


def _region_mask(labels, classes, xp):
    m = xp.zeros(labels.shape, dtype=bool)
    for c in classes:
        m = m | (labels == c)
    return m


def _binary_dice(pred, gt, xp):
    inter = xp.sum(pred & gt)
    denom = xp.sum(pred) + xp.sum(gt)
    # empty-vs-empty counts as perfect (BraTS online evaluator convention)
    return 1.0 if denom == 0 else float(2.0 * inter / denom)


def region_dice_np(pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    out = {}
    for name, classes in REGIONS.items():
        p = _region_mask(pred, classes, np)
        g = _region_mask(gt, classes, np)
        out[name] = _binary_dice(p, g, np)
    return out
