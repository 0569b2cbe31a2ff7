"""Two-stage coarse-to-fine cascade, split single-tile path (reference:
``brats2019_tpu/models/cascade.py``).

The flagship predict program runs as two stages:

* :meth:`SplitCascade.stage_roi` (:341): z-score -> antialiased resize to the
  coarse grid -> coarse U-Net -> argmax -> tumor-bbox center -> clamped ROI
  slice -> 8-flip stack;
* :meth:`SplitCascade.stage_finish` (:362): fine U-Net at batch 8 up to the
  pre-depth-to-space head -> low-res TTA reduce (groupwise softmax in f32,
  stored in the TTA dtype, unflips including the r-block axes, f32 mean in
  FLIPS order, argmax) -> depth-to-space of the labels. With stem 1 the
  full-resolution reduce is used instead.

``stage_roi`` never waits for the card: the ROI start stays a device tensor
and the region is gathered with it (:func:`crop_region`); the constants it
needs on the device are built at the first call on each device.

With ``postproc="device"`` (``serve``'s default) the connected-component
filter and the tiny-ET relabel run on the ROI labels inside
``stage_finish`` (:247-251, :422-441; ``ops/connected_components.py``), so
the host only pastes, un-crops and writes.

The monolithic path and the staged multi-tile sweep are not ported yet
(ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..configs.presets import InferenceConfig
from ..data.preprocess import centered_crop_start, mask_bbox_center, zscore
from ..infer.tta import FLIPS, store_dtype, tta_reduce, tta_stack
from ..ops.connected_components import postprocess_device
from ..ops.resize import resize_trilinear
from .unet3d import UNet3D


def coarse_locate(
    coarse: UNet3D,
    image: torch.Tensor,
    cfg: InferenceConfig,
    canvas: Tuple[int, int, int],
    roi: Tuple[int, int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage-1 localization on the z-scored (X, Y, Z, C) canvas (:29-56).
    Returns (region (roi + (C,)), start (3,) int32)."""
    coarse_in = resize_trilinear(image, cfg.coarse_shape)
    logits_c = coarse(coarse_in[None])[0]
    tumor = torch.argmax(logits_c, dim=-1) > 0
    center_c = mask_bbox_center(tumor)
    scale = _grid_scale(tuple(canvas), tuple(cfg.coarse_shape), image.device)
    # truncating cast, as the reference's .astype(int32) (:52)
    center = (center_c.float() * scale).to(torch.int32)
    start = centered_crop_start(center, roi, canvas)
    return crop_region(image, start, roi), start


@functools.lru_cache(maxsize=64)
def _grid_scale(canvas, coarse_shape, device) -> torch.Tensor:
    """Canvas / coarse-grid ratio per axis, f32, built once per device (the
    host-to-device copy that builds it waits for the card)."""
    with torch.inference_mode(False):
        return torch.tensor([c / s for c, s in zip(canvas, coarse_shape)],
                            dtype=torch.float32, device=device)


def crop_region(image: torch.Tensor, start: torch.Tensor,
                roi: Tuple[int, int, int]) -> torch.Tensor:
    """``image[sx:sx+roi[0], sy:sy+roi[1], sz:sz+roi[2]]`` for a device
    ``start``, gathered on the device as the reference's
    ``jax.lax.dynamic_slice`` (:54-55): index tensors built from ``start``, so
    the host never reads it."""
    region = image
    for ax, r in enumerate(roi):
        idx = torch.arange(r, device=image.device) + start[ax].long()
        region = region.index_select(ax, idx)
    return region


def lowres_mean_probs(
    logits_lr: torch.Tensor, stem: int, num_classes: int, store_dt: torch.dtype
) -> torch.Tensor:
    """(8, d, h, w, K*r^3) pre-d2s logits -> (d, h, w, r, r, r, K) f32 mean
    probabilities over the flips (:206-227). A full-res flip is a low-res
    flip plus a flip of the matching r-block axis."""
    b, d, h, w, _ = logits_lr.shape
    r = stem
    g = logits_lr.reshape(b, d, h, w, r, r, r, num_classes)
    p = torch.softmax(g.float(), dim=-1).to(store_dt)
    acc = torch.zeros(p.shape[1:], dtype=torch.float32, device=p.device)
    for i, f in enumerate(FLIPS):
        q = p[i]
        axes = [ax for ax, flag in enumerate(f) if flag]
        axes += [ax + 3 for ax, flag in enumerate(f) if flag]
        if axes:
            q = torch.flip(q, axes)
        acc = acc + q.float()
    return acc * (1.0 / len(FLIPS))


def labels_from_blocks(blk: torch.Tensor, stem: int) -> torch.Tensor:
    """(d, h, w, r, r, r) block labels -> (d*r, h*r, w*r) (:229-234)."""
    r = stem
    d, h, w = blk.shape[:3]
    return blk.permute(0, 3, 1, 4, 2, 5).reshape(d * r, h * r, w * r)


class SplitCascade:
    """The flagship split program: ``stage_roi`` then ``stage_finish``.
    Calling it runs both and returns ``(labels_roi uint8, start int32)``."""

    def __init__(
        self,
        fine: UNet3D,
        coarse: UNet3D,
        cfg: InferenceConfig,
        canvas: Tuple[int, int, int],
        num_classes: int = 4,
    ):
        self.fine, self.coarse, self.cfg = fine, coarse, cfg
        self.canvas = tuple(canvas)
        self.num_classes = num_classes
        self.stem = fine.config.stem_downsample
        self.roi = tuple(min(r, c) for r, c in zip(cfg.roi_shape, canvas))
        self.store_dt = store_dtype(cfg.tta_precision)

    def stage_roi(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z-score + coarse localization + ROI slice + flip stack."""
        image = zscore(image.float())
        region, start = coarse_locate(
            self.coarse, image, self.cfg, self.canvas, self.roi
        )
        return tta_stack(region, self.cfg.tta_precision), start

    def stage_finish(
        self, tiles: torch.Tensor, start: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fine forward at batch 8 + TTA reduce -> ROI labels (uint8)."""
        if self.stem > 1:
            logits = self.fine(tiles, subpixel=False)
            probs = lowres_mean_probs(
                logits, self.stem, self.num_classes, self.store_dt
            )
            blk = torch.argmax(probs, dim=-1).to(torch.uint8)
            labels = labels_from_blocks(blk, self.stem)
        else:
            probs8 = torch.softmax(self.fine(tiles).float(), dim=-1)
            probs = tta_reduce(probs8.to(self.store_dt))
            labels = torch.argmax(probs, dim=-1).to(torch.uint8)
        if self.cfg.postproc == "device":
            labels = postprocess_device(
                labels, self.cfg.min_component_voxels, self.cfg.et_min_voxels
            )
        return labels, start

    def __call__(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        tiles, start = self.stage_roi(image)
        return self.stage_finish(tiles, start)


def make_predict_fn(
    fine: UNet3D,
    cfg: InferenceConfig,
    canvas: Tuple[int, int, int],
    num_classes: int = 4,
    coarse: UNet3D = None,
) -> SplitCascade:
    """The port of ``make_predict_fn`` (:73) for its split single-tile
    path; other configurations raise NotImplementedError."""
    roi = tuple(min(r, c) for r, c in zip(cfg.roi_shape, canvas))
    if not (cfg.cascade and coarse is not None and cfg.tta_flips
            and roi == tuple(cfg.tile)):
        raise NotImplementedError(
            "only the split single-tile cascade with 8-flip TTA is ported "
            "(cascade on, a coarse model, tta_flips, roi == tile); the "
            "monolithic and staged sweep paths are ROADMAP queue 1 item 7"
        )
    return SplitCascade(fine, coarse, cfg, canvas, num_classes)
