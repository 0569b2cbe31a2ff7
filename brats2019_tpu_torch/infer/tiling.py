"""Sliding-window inference (reference: ``brats2019_tpu/infer/tiling.py``).

The tile grid is static: computed on the host from the (static, padded)
canvas shape. :func:`tile_origins` and :func:`blend_weight` are NumPy copies
of the reference's, pinned byte for byte by ``tests/test_torch_host.py``.
:func:`sliding_window_probs` is a loop over those host origins: each tile is
a slice with Python ints, its weighted probabilities are accumulated into f32
canvases in origin order, and the weights are normalised once at the end.
Nothing in the loop reads a device value on the host.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch


def tile_origins(
    vol_shape: Sequence[int],
    tile: Sequence[int],
    overlap: float = 0.5,
) -> np.ndarray:
    """Static tile-origin grid (N, 3) covering ``vol_shape``.

    Origins are evenly spaced with stride <= tile*(1-overlap) and always
    include a final tile flush with the volume edge (standard BraTS
    sliding-window convention).
    """
    axes = []
    for s, t in zip(vol_shape, tile):
        if t >= s:
            axes.append(np.array([0], dtype=np.int32))
            continue
        stride = max(1, int(round(t * (1.0 - overlap))))
        n = int(np.ceil((s - t) / stride)) + 1
        pos = np.round(np.linspace(0, s - t, n)).astype(np.int32)
        axes.append(np.unique(pos))
    grid = np.stack(
        [g.ravel() for g in np.meshgrid(*axes, indexing="ij")], axis=-1
    )
    return grid.astype(np.int32)


def blend_weight(
    tile: Sequence[int], mode: str = "gaussian", sigma_frac: float = 0.125
) -> np.ndarray:
    """Per-voxel blending weight (X, Y, Z, 1).

    "gaussian": separable Gaussian centered in the tile (importance
    weighting); "softmax": uniform weights == plain probability averaging.
    """
    if mode == "softmax":
        return np.ones(tuple(tile) + (1,), dtype=np.float32)
    ws = []
    for t in tile:
        x = np.arange(t, dtype=np.float64) - (t - 1) / 2.0
        sigma = max(t * sigma_frac, 1.0)
        ws.append(np.exp(-0.5 * (x / sigma) ** 2))
    w = ws[0][:, None, None] * ws[1][None, :, None] * ws[2][None, None, :]
    w = (w / w.max()).astype(np.float32)
    # floor keeps edge voxels numerically meaningful after normalization
    return np.maximum(w, 1e-3)[..., None]


def sliding_window_probs(
    tile_probs_fn: Callable[[torch.Tensor], torch.Tensor],
    vol: torch.Tensor,                   # (X, Y, Z, C)
    origins: np.ndarray,                 # (N, 3) static, host ints
    tile: Tuple[int, int, int],
    weight: torch.Tensor,                # (tx, ty, tz, 1) f32 on vol's device
    num_classes: int,
) -> torch.Tensor:
    """Weighted-blend class probabilities over a static tile sweep (:71-104).

    ``tile_probs_fn(tile (X,Y,Z,C)) -> probs (X,Y,Z,K)``. Returns the
    normalised f32 probabilities (X, Y, Z, K)."""
    X, Y, Z = vol.shape[:3]
    canvas = torch.zeros((X, Y, Z, num_classes), dtype=torch.float32,
                         device=vol.device)
    wsum = torch.zeros((X, Y, Z, 1), dtype=torch.float32, device=vol.device)
    tx, ty, tz = tile
    for o0, o1, o2 in np.asarray(origins).tolist():
        sl = (slice(o0, o0 + tx), slice(o1, o1 + ty), slice(o2, o2 + tz))
        canvas[sl] += tile_probs_fn(vol[sl]) * weight
        wsum[sl] += weight
    return canvas / torch.clamp(wsum, min=1e-8)
