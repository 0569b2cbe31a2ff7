"""Synthetic BraTS cases (copy of the v1 generator of
``brats2019_tpu/data/synthetic.py``).

4 modalities of an ellipsoidal brain on a zero background, with a tumor of
three nested ellipsoids: edema (class 2) > NCR (1) > ET (3 internal).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..utils.nifti import write_nifti
from .constants import MODALITIES, VOLUME_SHAPE, internal_to_disk

# BraTS-like affine: 1mm isotropic, LPS-ish offset
_DEFAULT_AFFINE = np.array(
    [
        [-1.0, 0.0, 0.0, 0.0],
        [0.0, -1.0, 0.0, 239.0],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


def _ellipsoid_mask(shape, center, radii) -> np.ndarray:
    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
    acc = np.zeros(shape, dtype=np.float64)
    for g, c, r in zip(grids, center, radii):
        acc = acc + ((g - c) / max(r, 1e-6)) ** 2
    return acc <= 1.0


def make_case_arrays(
    seed: int = 0, shape: Tuple[int, int, int] = VOLUME_SHAPE
) -> Tuple[np.ndarray, np.ndarray]:
    """``(image (X,Y,Z,4) float32, seg (X,Y,Z) uint8 internal labels)``."""
    rng = np.random.default_rng(seed)
    X, Y, Z = shape
    brain_center = (X / 2 + rng.uniform(-5, 5), Y / 2 + rng.uniform(-5, 5), Z / 2)
    brain_radii = (X * 0.35, Y * 0.4, Z * 0.42)
    brain = _ellipsoid_mask(shape, brain_center, brain_radii)

    image = np.zeros(shape + (4,), dtype=np.float32)
    for c in range(4):
        base = rng.uniform(200, 800)
        tex = rng.normal(0.0, base * 0.05, size=shape).astype(np.float32)
        # smooth gradient so modalities differ spatially
        gx = np.linspace(0, 1, X, dtype=np.float32)[:, None, None]
        gy = np.linspace(0, 1, Y, dtype=np.float32)[None, :, None]
        vol = base * (0.8 + 0.2 * (gx * (c % 2) + gy * ((c + 1) % 2))) + tex
        image[..., c] = np.where(brain, vol, 0.0).astype(np.float32)

    seg = np.zeros(shape, dtype=np.uint8)
    t_center = tuple(
        bc + rng.uniform(-0.15, 0.15) * br for bc, br in zip(brain_center, brain_radii)
    )
    r_ed = tuple(max(4.0, 0.30 * r) for r in brain_radii)
    r_ncr = tuple(0.6 * r for r in r_ed)
    r_et = tuple(0.35 * r for r in r_ed)
    ed = _ellipsoid_mask(shape, t_center, r_ed) & brain
    ncr = _ellipsoid_mask(shape, t_center, r_ncr) & brain
    et = _ellipsoid_mask(shape, t_center, r_et) & brain
    seg[ed] = 2
    seg[ncr] = 1
    seg[et] = 3
    # tumor intensity contrast
    for c, m, delta in ((0, ncr, -0.35), (1, et, 0.6), (2, ed, 0.45), (3, ed, 0.5)):
        img_c = image[..., c]
        img_c[m] = img_c[m] * (1.0 + delta)
    return image, seg


def write_case(case_dir: str, seed: int = 0,
               shape: Tuple[int, int, int] = VOLUME_SHAPE) -> str:
    """Write a synthetic case, with its ``_seg``, as a BraTS-layout
    directory of ``.nii.gz`` files; returns case_dir."""
    os.makedirs(case_dir, exist_ok=True)
    base = os.path.basename(os.path.normpath(case_dir))
    image, seg = make_case_arrays(seed=seed, shape=shape)
    for i, m in enumerate(MODALITIES):
        write_nifti(os.path.join(case_dir, f"{base}_{m}.nii.gz"),
                    image[..., i].astype(np.int16), affine=_DEFAULT_AFFINE)
    write_nifti(os.path.join(case_dir, f"{base}_seg.nii.gz"),
                internal_to_disk(seg).astype(np.uint8), affine=_DEFAULT_AFFINE)
    return case_dir


def write_dataset(root: str, n_cases: int, shape=VOLUME_SHAPE, seed0: int = 0):
    """Write ``n_cases`` synthetic cases under ``root``; returns case dirs."""
    dirs = []
    for i in range(n_cases):
        d = os.path.join(root, f"BraTS19_SYN_{i:03d}_1")
        write_case(d, seed=seed0 + i, shape=shape)
        dirs.append(d)
    return dirs
