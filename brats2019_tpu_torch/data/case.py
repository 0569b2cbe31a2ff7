"""BraTS case directories (copy of ``brats2019_tpu/data/case.py``).

A case directory ``BraTS19_XXX_1/`` holds ``BraTS19_XXX_1_{t1,t1ce,t2,flair}
.nii[.gz]`` (and ``_seg`` for training cases). ``load_case`` stacks the four
modalities channel-last -> (X, Y, Z, 4) float32; with ``load_seg`` it also
reads the labels as internal classes {0,1,2,3}. The modalities come from the
native threaded decoder (``utils/nifti_fast.py``) when it is available, with
its per-volume stats and fused brain bbox as ``Case.meta``, else from the
NumPy reader (``meta`` None).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from ..utils.nifti import NiftiHeader, read_nifti
from .constants import MODALITIES, disk_to_internal


@dataclasses.dataclass
class Case:
    """One loaded BraTS case."""

    name: str
    image: np.ndarray                 # (X, Y, Z, 4) float32, raw intensities
    header: NiftiHeader               # header of the first modality (for write-back)
    seg: Optional[np.ndarray] = None  # (X, Y, Z) uint8 internal labels, or None
    # the native decoder's byproducts (per-modality nonzero mean/std, union
    # brain bbox ``bbox_lo``/``bbox_hi``); None from the NumPy reader
    meta: Optional[dict] = None


def modality_paths(case_dir: str) -> List[str]:
    base = os.path.basename(os.path.normpath(case_dir))
    paths = []
    for m in MODALITIES:
        for ext in (".nii.gz", ".nii"):
            p = os.path.join(case_dir, f"{base}_{m}{ext}")
            if os.path.exists(p):
                paths.append(p)
                break
        else:
            raise FileNotFoundError(f"Missing modality '{m}' in {case_dir}")
    return paths


def seg_path(case_dir: str) -> Optional[str]:
    base = os.path.basename(os.path.normpath(case_dir))
    for ext in (".nii.gz", ".nii"):
        p = os.path.join(case_dir, f"{base}_seg{ext}")
        if os.path.exists(p):
            return p
    return None


def is_case_dir(path: str) -> bool:
    try:
        modality_paths(path)
        return True
    except (FileNotFoundError, NotADirectoryError):
        return False


def discover_cases(root: str) -> List[str]:
    """BraTS case directories at ``root``: root itself, or its children in
    sorted order. A missing or non-directory path yields []."""
    if not os.path.isdir(root):
        return []
    if is_case_dir(root):
        return [root]
    out = []
    for entry in sorted(os.listdir(root)):
        p = os.path.join(root, entry)
        if os.path.isdir(p) and is_case_dir(p):
            out.append(p)
    return out


def kfold_split(cases, folds: int, fold: int):
    """Deterministic K-fold split over an ordered case list: fold ``fold``
    (round-robin on the given order) is validation, the rest train.
    Returns ``(train_dirs, val_dirs)``."""
    if folds < 2:
        raise ValueError(f"folds must be >= 2, got {folds}")
    if not 0 <= fold < folds:
        raise ValueError(f"fold must be in [0, {folds}), got {fold}")
    val = [c for i, c in enumerate(cases) if i % folds == fold]
    train = [c for i, c in enumerate(cases) if i % folds != fold]
    return (train or list(cases)), val


def load_case(case_dir: str, *, load_seg: bool = False,
              backend: str = "auto") -> Case:
    """Load the 4 modalities of a case directory (and, with ``load_seg``,
    its labels when present). The header is the t1 modality's, used to
    write the prediction with a matching affine.

    ``backend`` (:104-125 of the reference): ``"auto"`` takes the native
    decoder when it is available and decodes the case, else the NumPy
    reader; ``"native"`` raises when the decoder is unavailable or fails on
    the case; ``"python"`` always reads with NumPy."""
    if backend not in ("auto", "python", "native"):
        raise ValueError(f"load_case backend must be auto|python|native, "
                         f"got {backend!r}")
    paths = modality_paths(case_dir)
    image, header, meta = None, None, None
    if backend in ("auto", "native"):
        from ..utils import nifti_fast
        from ..utils.nifti import read_header

        res = nifti_fast.load_volumes_fast(paths) if nifti_fast.available() else None
        if res is not None:
            image, meta = res
            header = read_header(paths[0])
        elif backend == "native":
            raise RuntimeError(
                "native loader requested but unavailable"
                + (f" ({nifti_fast.build_error})" if nifti_fast.build_error
                   else f" or it failed on {case_dir}"))
    if image is None:
        vols = []
        for p in paths:
            arr, hdr = read_nifti(p, dtype=np.float32)
            if header is None:
                header = hdr
            if vols and arr.shape != vols[0].shape:
                raise ValueError(f"Inconsistent modality shapes in {case_dir}")
            vols.append(arr)
        image = np.stack(vols, axis=-1)
    seg = None
    sp = seg_path(case_dir) if load_seg else None
    if sp is not None:
        seg_arr, _ = read_nifti(sp, apply_scaling=False)
        seg = disk_to_internal(seg_arr).astype(np.uint8)
    return Case(
        name=os.path.basename(os.path.normpath(case_dir)),
        image=image,
        header=header,
        seg=seg,
        meta=meta,
    )
