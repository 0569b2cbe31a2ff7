"""Random 3D patch sampling from the device-resident pool (reference:
``brats2019_tpu/data/sampling.py``).

Two layers, so that the draws and the slicing can be held apart:

* :func:`draw_patch` takes every random number from an explicit
  ``torch.Generator`` (on the host) into a :class:`PatchDraw`;
* :func:`patch_origin` and :func:`slice_patch` are deterministic: the origin
  of a draw (uniform, or centered on a jittered foreground voxel, as
  ``_random_origin`` :50-73), then a slice of the pool's image/seg.

``jax.random`` gives other numbers than torch for the same seed; the tests
feed the JAX draws to the deterministic layer.

:func:`checked_sample_batch` is the ``--debug-checks`` sampler (:133-162):
the JAX package's checkify bound on the foreground table becomes an
explicit check that raises ValueError on the same condition.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

FG_TABLE_SIZE = 4096  # fixed-size foreground coordinate table per case


def build_fg_table_np(seg: np.ndarray, size: int = FG_TABLE_SIZE) -> np.ndarray:
    """Host: sample ``size`` foreground voxel coords (with replacement).

    Returns (size, 3) int32; falls back to the volume center when the case has
    no foreground, keeping the device-side sampler branch-free.
    """
    coords = np.argwhere(seg > 0)
    if coords.shape[0] == 0:
        center = np.array(seg.shape, dtype=np.int64) // 2
        coords = center[None, :]
    rng = np.random.default_rng(coords.shape[0])
    idx = rng.integers(0, coords.shape[0], size=size)
    return coords[idx].astype(np.int32)


@dataclasses.dataclass(frozen=True)
class PatchDraw:
    """The random numbers of one patch origin (``_random_origin``'s
    uniform, bernoulli, row and jitter draws)."""

    uniform: Tuple[int, int, int]
    take_fg: bool
    row: int
    jitter: Tuple[int, int, int]


def _maxs(vol_shape, patch) -> Tuple[int, ...]:
    return tuple(max(v - p, 0) for v, p in zip(vol_shape, patch))


def draw_patch(
    gen: torch.Generator,
    vol_shape: Sequence[int],
    patch: Sequence[int],
    n_fg_rows: int,
    fg_prob: float,
) -> PatchDraw:
    maxs = _maxs(vol_shape, patch)
    ri = lambda lo, hi: int(torch.randint(lo, hi, (), generator=gen))
    uniform = tuple(ri(0, m + 1) for m in maxs)
    take_fg = bool(torch.rand((), generator=gen) < fg_prob)
    row = ri(0, n_fg_rows)
    jitter = tuple(ri(-(p // 4), p // 4 + 1) for p in patch)
    return PatchDraw(uniform, take_fg, row, jitter)


def patch_origin(
    draw: PatchDraw,
    vol_shape: Sequence[int],
    patch: Sequence[int],
    fg_table: Optional[np.ndarray],
    fg_prob: float,
) -> Tuple[int, int, int]:
    """Uniform origin, or one centered on fg voxel ``fg_table[row]`` shifted
    by the jitter, clipped into the volume, when ``take_fg``."""
    if fg_table is None or fg_prob <= 0.0 or not draw.take_fg:
        return tuple(int(u) for u in draw.uniform)
    center = fg_table[draw.row]
    return tuple(
        int(min(max(int(c) - p // 2 + j, 0), m))
        for c, p, j, m in zip(center, patch, draw.jitter, _maxs(vol_shape, patch))
    )


def slice_patch(image: torch.Tensor, seg: torch.Tensor,
                origin: Sequence[int], patch: Sequence[int]):
    """(X, Y, Z, C) image and (X, Y, Z) seg -> the patch at ``origin``."""
    sl = tuple(slice(o, o + p) for o, p in zip(origin, patch))
    return image[sl], seg[sl]


def check_patch_fits(patch, vol_shape, seg_shape) -> None:
    for ax, (p, v) in enumerate(zip(patch, vol_shape)):
        if p > v:
            raise ValueError(f"patch {tuple(patch)} exceeds volume "
                             f"{tuple(vol_shape)} on axis {ax}")
    if tuple(seg_shape[:3]) != tuple(vol_shape):
        raise ValueError(f"seg shape {tuple(seg_shape)} != image spatial "
                         f"{tuple(vol_shape)}")


def sample_patch_impl(
    gen: torch.Generator,
    image: torch.Tensor,          # (X, Y, Z, C)
    seg: torch.Tensor,            # (X, Y, Z) int
    patch: Sequence[int],
    fg_table: Optional[np.ndarray] = None,   # (T, 3) int32 on the host
    fg_prob: float = 0.5,
):
    """Draw an origin from ``gen`` and slice the patch."""
    vol_shape = tuple(image.shape[:3])
    check_patch_fits(patch, vol_shape, seg.shape)
    n_rows = fg_table.shape[0] if fg_table is not None else 1
    draw = draw_patch(gen, vol_shape, patch, n_rows, fg_prob)
    origin = patch_origin(draw, vol_shape, patch, fg_table, fg_prob)
    return slice_patch(image, seg, origin, patch)


def checked_sample_batch(
    gen: torch.Generator,
    image: torch.Tensor,
    seg: torch.Tensor,
    patch: Sequence[int],
    batch: int,
    fg_table: Optional[np.ndarray] = None,
    fg_prob: float = 0.5,
):
    """``batch`` patches as :func:`sample_patch_impl` draws them, after the
    bounds checks: a patch larger than the volume and a foreground table
    with a coordinate outside it (the JAX package's checkify bound, :92-100)
    raise ValueError instead of clamping."""
    vol_shape = tuple(image.shape[:3])
    check_patch_fits(patch, vol_shape, seg.shape)
    if fg_table is not None:
        table = np.asarray(fg_table)
        if not bool(np.all((table >= 0) & (table < np.asarray(vol_shape)[None, :]))):
            raise ValueError(
                "fg table coordinate out of volume bounds (mis-sized table?)")
    imgs, segs = zip(*(sample_patch_impl(gen, image, seg, patch, fg_table,
                                         fg_prob) for _ in range(batch)))
    return torch.stack(imgs), torch.stack(segs)
