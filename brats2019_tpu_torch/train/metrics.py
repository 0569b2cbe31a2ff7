"""BraTS region metrics on internal labels {0,1,2,3} (copy of the NumPy part of
``brats2019_tpu/train/metrics.py``, :17-47 and :65-143; the original imports
jax): Dice, Hausdorff95 and sensitivity / specificity per region, on the
host (NumPy and scipy).

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


def _surface(mask: np.ndarray) -> np.ndarray:
    """Boundary voxels: mask minus its 1-step erosion (6-connectivity)."""
    from scipy import ndimage

    return mask & ~ndimage.binary_erosion(mask, border_value=0)


def hd95_np(
    pred: np.ndarray, gt: np.ndarray, spacing=(1.0, 1.0, 1.0)
) -> float:
    """Symmetric 95th-percentile surface distance between two binary masks.

    Conventions (BraTS online evaluator [B]): both masks empty -> 0.0
    (perfect); exactly one empty -> ``inf`` (callers substitute the volume
    diagonal as the penalty — that is where the evaluator's well-known
    373.13 mm figure for an empty 240x240x155 prediction comes from).

    The EDT runs on the padded union bounding box of both masks, which is
    exact (every surface voxel of either mask lies inside the box) and
    keeps host cost proportional to the tumor, not the volume.
    """
    from scipy import ndimage

    pred = np.asarray(pred, dtype=bool)
    gt = np.asarray(gt, dtype=bool)
    p_any, g_any = bool(pred.any()), bool(gt.any())
    if not p_any and not g_any:
        return 0.0
    if not p_any or not g_any:
        return float("inf")
    union = pred | gt
    lo, hi = [], []
    for ax in range(union.ndim):
        nz = np.any(
            union, axis=tuple(a for a in range(union.ndim) if a != ax)
        ).nonzero()[0]
        lo.append(max(int(nz[0]) - 1, 0))
        hi.append(min(int(nz[-1]) + 2, union.shape[ax]))
    sl = tuple(slice(l, h) for l, h in zip(lo, hi))
    ps, gs = _surface(pred[sl]), _surface(gt[sl])
    d_pg = ndimage.distance_transform_edt(~gs, sampling=spacing)[ps]
    d_gp = ndimage.distance_transform_edt(~ps, sampling=spacing)[gs]
    return float(max(np.percentile(d_pg, 95), np.percentile(d_gp, 95)))


def region_hd95_np(
    pred: np.ndarray, gt: np.ndarray, spacing=(1.0, 1.0, 1.0)
) -> Dict[str, float]:
    """HD95 per BraTS region (WT/TC/ET) on internal labels {0,1,2,3}."""
    out = {}
    for name, classes in REGIONS.items():
        p = _region_mask(pred, classes, np)
        g = _region_mask(gt, classes, np)
        out[name] = hd95_np(p, g, spacing)
    return out


def region_sens_spec_np(
    pred: np.ndarray, gt: np.ndarray
) -> Dict[str, float]:
    """Per-region sensitivity (TP/P) and specificity (TN/N) — the remaining
    two metrics of the BraTS online evaluator's report [B]. Empty-region
    conventions mirror Dice: no positive ground truth -> sensitivity 1.0;
    no negative ground truth -> specificity 1.0.

    Returns ``{"Sens_WT": ..., "Spec_WT": ..., ...}``.
    """
    out = {}
    n_vox = int(np.prod(gt.shape))
    for name, classes in REGIONS.items():
        p = _region_mask(pred, classes, np)
        g = _region_mask(gt, classes, np)
        tp = int(np.sum(p & g))
        pos = int(np.sum(g))
        tn = int(np.sum(~p & ~g))
        neg = n_vox - pos
        out[f"Sens_{name}"] = 1.0 if pos == 0 else tp / pos
        out[f"Spec_{name}"] = 1.0 if neg == 0 else tn / neg
    return out
