"""Voxelwise uncertainty maps in the QU-BraTS format (copy of
``brats2019_tpu/infer/uncertainty.py``): per-region maps in [0, 100], 0 =
certain.

Computed from the same mean class-probability canvas the labels are
argmaxed from (``Predictor``/``EnsemblePredictor`` ``predict_probs_arrays``:
the TTA mean, optionally also a checkpoint-ensemble mean): for each BraTS
region (WT/TC/ET; ``train/metrics.py`` region definitions on internal
classes) the region probability is the sum of its class channels and the
uncertainty is its binary entropy normalised to [0, 100]. NumPy on the host:
the probability canvas has already left the device.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

# region name (QU-BraTS file suffix) -> internal class channels
# (train/metrics.py: WT = {1,2,3}, TC = {1,3}, ET = {3})
REGION_CHANNELS = {
    "whole": (1, 2, 3),
    "core": (1, 3),
    "enhance": (3,),
}


def region_uncertainty_maps(probs: np.ndarray) -> dict:
    """(X, Y, Z, C) mean class probabilities -> three (X, Y, Z) uint8 maps
    {"whole", "core", "enhance"} in [0, 100]: the binary entropy of each
    region's probability (0 at p∈{0,1}, 100 at p=0.5)."""
    out = {}
    for name, chans in REGION_CHANNELS.items():
        p = probs[..., list(chans)].sum(-1, dtype=np.float32)
        p = np.clip(p, 1e-7, 1.0 - 1e-7)
        h = -(p * np.log2(p) + (1.0 - p) * np.log2(1.0 - p))
        out[name] = np.rint(h * 100.0).astype(np.uint8)
    return out


def predict_uncertainty_dir(
    predictor, case_dir: str, output_dir: Optional[str] = None
) -> list:
    """Run ``predictor.predict_probs_arrays`` (works for Predictor and
    EnsemblePredictor alike) on a case directory and write the three
    QU-BraTS maps as ``<case>_unc_{whole,core,enhance}.nii.gz`` with the
    input header/affine. Returns the written paths. The native decoder's
    ``meta`` rides along, so the brain bbox is the one it fused."""
    from ..data.case import load_case
    from ..utils.nifti import write_nifti

    case = load_case(case_dir, load_seg=False)
    probs, _ = predictor.predict_probs_arrays(case.image, meta=case.meta)
    maps = region_uncertainty_maps(probs)
    outs = []
    for name, u in maps.items():
        out = os.path.join(
            output_dir or case_dir, f"{case.name}_unc_{name}.nii.gz"
        )
        write_nifti(out, u, like=case.header)
        outs.append(out)
    return outs
