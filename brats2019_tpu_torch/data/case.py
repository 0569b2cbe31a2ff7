"""BraTS case directories (copy of the NumPy path of
``brats2019_tpu/data/case.py``).

A case directory ``BraTS19_XXX_1/`` holds ``BraTS19_XXX_1_{t1,t1ce,t2,flair}
.nii[.gz]``. ``load_case`` stacks the four modalities channel-last ->
(X, Y, Z, 4) float32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np

from ..utils.nifti import NiftiHeader, read_nifti
from .constants import MODALITIES


@dataclasses.dataclass
class Case:
    """One loaded BraTS case."""

    name: str
    image: np.ndarray                 # (X, Y, Z, 4) float32, raw intensities
    header: NiftiHeader               # header of the first modality (for write-back)


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


def load_case(case_dir: str) -> Case:
    """Load the 4 modalities of a case directory. The header is the t1
    modality's, used to write the prediction with a matching affine."""
    vols, header = [], None
    for p in modality_paths(case_dir):
        arr, hdr = read_nifti(p, dtype=np.float32)
        if header is None:
            header = hdr
        if vols and arr.shape != vols[0].shape:
            raise ValueError(f"Inconsistent modality shapes in {case_dir}")
        vols.append(arr)
    return Case(
        name=os.path.basename(os.path.normpath(case_dir)),
        image=np.stack(vols, axis=-1),
        header=header,
    )
