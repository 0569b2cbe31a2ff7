"""Synthetic BraTS cases (copy of the two generators of
``brats2019_tpu/data/synthetic.py``).

v1 (``make_case_arrays``): 4 modalities of an ellipsoidal brain on a zero
background, with a tumor of three nested ellipsoids: edema (class 2) > NCR
(1) > ET (3 internal).

v2, "hard" (``make_hard_case_arrays``, with ``_smooth_field``, ``_blob_rho``
and ``_blob_mask``): irregular multi-component tumors, a low-contrast ET rim
(absent in a quarter of the cases), bias fields and distractor spots; the
accuracy benchmark's cases (``tests/test_accuracy_benchmark.py``).
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


def _smooth_field(
    rng: np.random.Generator,
    shape: Tuple[int, int, int],
    grid: int = 5,
    lo: float = -1.0,
    hi: float = 1.0,
) -> np.ndarray:
    """Low-frequency random field in [lo, hi]: a coarse uniform grid
    trilinearly upsampled to ``shape`` (the standard bias-field /
    irregular-boundary building block)."""
    from scipy.ndimage import zoom

    coarse = rng.uniform(lo, hi, size=(grid, grid, grid))
    factors = [max(s / grid, 1.0) for s in shape]
    f = zoom(coarse, factors, order=1, mode="nearest")
    out = np.zeros(shape, np.float32)
    sl = tuple(slice(0, min(a, b)) for a, b in zip(shape, f.shape))
    out[sl] = f[sl]
    for ax, (want, have) in enumerate(zip(shape, f.shape)):
        if have < want:  # zoom rounding undershoot: edge-extend
            idx = [slice(None)] * 3
            idx[ax] = slice(have, want)
            src = [slice(None)] * 3
            src[ax] = slice(have - 1, have)
            out[tuple(idx)] = out[tuple(src)]
    return out


def _blob_rho(
    rng: np.random.Generator,
    shape: Tuple[int, int, int],
    center,
    radii,
    irregularity: float = 0.35,
) -> np.ndarray:
    """Irregular radial coordinate of a lumpy blob: the normalized
    ellipsoid distance perturbed by ONE low-frequency noise field.
    ``rho <= 1`` is the blob; inner thresholds (``rho <= 0.55``) carve
    nested structures whose shells are guaranteed non-degenerate because
    every level set shares the same perturbation."""
    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
    dist = np.zeros(shape, dtype=np.float64)
    for g, c, r in zip(grids, center, radii):
        dist = dist + ((g - c) / max(r, 1e-6)) ** 2
    noise = _smooth_field(rng, shape, grid=6, lo=-1.0, hi=1.0)
    return np.sqrt(dist) + irregularity * noise


def _blob_mask(
    rng: np.random.Generator,
    shape: Tuple[int, int, int],
    center,
    radii,
    irregularity: float = 0.35,
) -> np.ndarray:
    """Irregular blob: ``_blob_rho <= 1`` (lumpy, not analytically
    smooth)."""
    return _blob_rho(rng, shape, center, radii, irregularity) <= 1.0


def make_hard_case_arrays(
    seed: int = 0,
    shape: Tuple[int, int, int] = VOLUME_SHAPE,
    empty_et_prob: float = 0.25,
) -> Tuple[np.ndarray, np.ndarray]:
    """Generator v2 — the discriminating benchmark.

    The v1 nested-ellipsoid cases saturate the flagship at Dice ~0.998,
    so TTA/ensembling/EMA/postprocessing could only ever be tested for
    exactness, never for benefit. v2 produces cases in a paper-like
    difficulty regime:

    * 1-3 irregular tumor components (lumpy boundaries from low-frequency
      noise, not analytic ellipsoids), the secondary ones small;
    * a LOW-contrast ET rim (thin shell, +~0.18 T1ce vs v1's +0.6) whose
      contrast is further modulated by a smooth field — ET is genuinely
      hard, and ``empty_et_prob`` of cases have NO ET at all (the classic
      BraTS empty-ET postprocessing regime that ``et_min_voxels`` exists
      for);
    * multiplicative smooth bias fields (0.75-1.25) per modality plus
      heavier texture noise, so intensity alone is unreliable;
    * 2-4 small bright non-tumor distractor spots (ET-like T1ce
      brightening) that tempt false-positive components — connected-
      component filtering has something real to remove.

    Returns the same contract as ``make_case_arrays``.
    """
    rng = np.random.default_rng(seed)
    X, Y, Z = shape
    brain_center = (
        X / 2 + rng.uniform(-5, 5), Y / 2 + rng.uniform(-5, 5), Z / 2,
    )
    brain_radii = (X * 0.35, Y * 0.4, Z * 0.42)
    brain = _ellipsoid_mask(shape, brain_center, brain_radii)

    image = np.zeros(shape + (4,), dtype=np.float32)
    for c in range(4):
        base = rng.uniform(200, 800)
        tex = rng.normal(0.0, base * 0.12, size=shape).astype(np.float32)
        gx = np.linspace(0, 1, X, dtype=np.float32)[:, None, None]
        gy = np.linspace(0, 1, Y, dtype=np.float32)[None, :, None]
        vol = base * (0.8 + 0.2 * (gx * (c % 2) + gy * ((c + 1) % 2))) + tex
        bias = 1.0 + 0.25 * _smooth_field(rng, shape, grid=4)
        image[..., c] = np.where(brain, vol * bias, 0.0).astype(np.float32)

    seg = np.zeros(shape, dtype=np.uint8)
    has_et = rng.uniform() >= empty_et_prob
    n_comp = int(rng.integers(1, 4))
    # contrast modulation: tumor deltas vary 0.5-1.5x across space
    mod = (1.0 + 0.5 * _smooth_field(rng, shape, grid=4)).astype(np.float32)

    def _boost(c: int, m: np.ndarray, delta: float) -> None:
        img_c = image[..., c]
        img_c[m] = img_c[m] * (1.0 + delta * mod[m])

    for comp in range(n_comp):
        frac = 0.26 if comp == 0 else rng.uniform(0.08, 0.14)
        t_center = tuple(
            bc + rng.uniform(-0.35, 0.35) * br
            for bc, br in zip(brain_center, brain_radii)
        )
        r_ed = tuple(max(3.0, frac * r) for r in brain_radii)
        rho = _blob_rho(rng, shape, t_center, r_ed)
        ed = (rho <= 1.0) & brain
        if not ed.any():
            continue
        seg[ed] = 2
        _boost(2, ed, 0.30)  # t2
        _boost(3, ed, 0.35)  # flair
        # inner structure only in the primary component (secondaries are
        # pure-ED satellites, like small foci); nested level sets of ONE
        # rho field, so the ET shell is a real shell whenever ED exists
        if comp == 0:
            ncr = (rho <= 0.55) & brain
            seg[ncr] = 1
            _boost(0, ncr, -0.25)  # t1 hypointense core
            if has_et:
                # enhancing rim around the core, LOW t1ce contrast
                # (+0.30 modulated 0.5-1.5x, vs v1's flat +0.6 — hard but
                # learnable; calibrated so a small net predicts SOME ET)
                rim = (rho > 0.50) & (rho <= 0.90) & brain
                seg[rim] = 3
                _boost(1, rim, 0.30)

    # distractor spots: bright non-tumor foci (false-positive bait)
    for _ in range(int(rng.integers(2, 5))):
        c_spot = tuple(
            bc + rng.uniform(-0.6, 0.6) * br
            for bc, br in zip(brain_center, brain_radii)
        )
        r_spot = (rng.uniform(2.0, 4.0),) * 3
        spot = _ellipsoid_mask(shape, c_spot, r_spot) & brain & (seg == 0)
        _boost(1, spot, 0.22)
        _boost(3, spot, 0.30)
    return image, seg


def write_case(case_dir: str, seed: int = 0,
               shape: Tuple[int, int, int] = VOLUME_SHAPE,
               hard: bool = False) -> str:
    """Write a synthetic case, with its ``_seg``, as a BraTS-layout
    directory of ``.nii.gz`` files; returns case_dir. ``hard=True`` uses
    generator v2 (``make_hard_case_arrays``)."""
    os.makedirs(case_dir, exist_ok=True)
    base = os.path.basename(os.path.normpath(case_dir))
    if hard:
        image, seg = make_hard_case_arrays(seed=seed, shape=shape)
    else:
        image, seg = make_case_arrays(seed=seed, shape=shape)
    for i, m in enumerate(MODALITIES):
        write_nifti(os.path.join(case_dir, f"{base}_{m}.nii.gz"),
                    image[..., i].astype(np.int16), affine=_DEFAULT_AFFINE)
    write_nifti(os.path.join(case_dir, f"{base}_seg.nii.gz"),
                internal_to_disk(seg).astype(np.uint8), affine=_DEFAULT_AFFINE)
    return case_dir


def write_dataset(root: str, n_cases: int, shape=VOLUME_SHAPE, seed0: int = 0,
                  hard: bool = False):
    """Write ``n_cases`` synthetic cases under ``root``; returns case dirs.
    ``hard=True`` writes generator-v2 cases."""
    dirs = []
    for i in range(n_cases):
        d = os.path.join(root, f"BraTS19_SYN_{i:03d}_1")
        write_case(d, seed=seed0 + i, shape=shape, hard=hard)
        dirs.append(d)
    return dirs
