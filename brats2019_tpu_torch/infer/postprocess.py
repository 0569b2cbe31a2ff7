"""Label cleanup (copy of the scipy backend of
``brats2019_tpu/infer/postprocess.py``; ``postprocess_labels(backend=
"device")`` takes the small-component filter from
``ops/connected_components.py`` instead, as the reference's).

1. drop foreground components (26-connectivity) smaller than
   ``min_component_voxels``;
2. relabel a total ET volume below ``et_min_voxels`` as NCR.
"""

from __future__ import annotations

import numpy as np

_STRUCT26 = np.ones((3, 3, 3), dtype=bool)


def filter_small_components_np(labels: np.ndarray, min_voxels: int) -> np.ndarray:
    """Zero connected foreground components smaller than ``min_voxels``,
    labelling only the foreground's bounding box."""
    if min_voxels <= 1:
        return labels
    from scipy import ndimage

    fg = labels > 0
    if not fg.any():
        return labels
    sl = tuple(
        slice(int(idx.min()), int(idx.max()) + 1)
        for idx in (np.where(fg.any(axis=(1, 2)))[0],
                    np.where(fg.any(axis=(0, 2)))[0],
                    np.where(fg.any(axis=(0, 1)))[0])
    )
    comp, n = ndimage.label(labels[sl] > 0, structure=_STRUCT26)
    if n == 0:
        return labels
    sizes = np.bincount(comp.ravel())
    kill = np.zeros(n + 1, dtype=bool)
    kill[1:] = sizes[1:] < min_voxels
    out = labels.copy()
    region = out[sl]
    region[kill[comp]] = 0
    out[sl] = region
    return out


def suppress_tiny_et_np(labels: np.ndarray, et_min_voxels: int) -> np.ndarray:
    """Relabel ET (internal class 3) as NCR (class 1) when its total volume
    is below ``et_min_voxels``."""
    if et_min_voxels <= 0:
        return labels
    et = labels == 3
    if 0 < et.sum() < et_min_voxels:
        out = labels.copy()
        out[et] = 1
        return out
    return labels


def postprocess_labels(
    labels: np.ndarray,
    *,
    min_component_voxels: int = 16,
    et_min_voxels: int = 32,
    backend: str = "scipy",
    device="cuda",
) -> np.ndarray:
    """Full label cleanup on internal labels {0..3}: the small-component
    filter in host scipy (``backend="scipy"``) or by the device connected
    components (``backend="device"``, on ``device``: the card unless the
    caller asks for the CPU), as the reference's ``backend=`` (:74-89)."""
    if backend == "device":
        from ..ops.connected_components import filter_small_components_device

        labels = filter_small_components_device(labels, min_component_voxels,
                                                device)
    else:
        labels = filter_small_components_np(labels, min_component_voxels)
    return suppress_tiny_et_np(labels, et_min_voxels)
