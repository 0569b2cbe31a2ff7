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
  full-resolution reduce is used instead;
* :meth:`SplitCascade.stage_finish_pair` (:373): two volumes' flip stacks
  through one fine forward at batch 16, each half reduced as above (volume
  pairing, ``infer/predictor.py``).

``stage_roi`` never waits for the card: the ROI start stays a device tensor
and the region is gathered with it (:func:`crop_region`); the constants it
needs on the device are built at the first call on each device.

With ``postproc="device"`` (``serve``'s default) the connected-component
filter and the tiny-ET relabel run on the ROI labels inside
``stage_finish`` (:247-251, :422-441; ``ops/connected_components.py``), so
the host only pastes, un-crops and writes.

:func:`make_predict_fn` chooses among three programs with the reference's
own predicates (:119-122, :187-200): the split single-tile cascade above;
:class:`StagedSweep` (:254-337), the multi-tile TTA sweep for a whole canvas
or an ROI larger than one tile, which stacks the flips of every tile and then
runs, per tile, the fine forward at batch 8 up to the pre-depth-to-space
head and the low-res TTA reduce, blended into a low-res block canvas; and
:class:`Monolithic` (:135-168), z-score -> coarse ROI when cascading ->
blended sliding window of ``tta_probs`` -> argmax, for everything else (no
TTA, stem 1 with several tiles). Each is called with the (X, Y, Z, C) canvas
and returns ``(labels_roi uint8, start int32)``; without a cascade the ROI
is the whole canvas and start is zeros.

Each also has ``probs(image) -> (probs_roi f32 (rx, ry, rz, K), start)``, the
counterpart of the reference's ``fn.probs_fn`` (:201, :338, :418): the mean
probabilities the labels are argmaxed from, before any postprocessing
(``stage_finish_probs`` :390-402 through :func:`probs_from_blocks` or the
full-resolution ``tta_reduce``; ``stage_sweep_probs`` :322-323;
``predict_probs_monolithic`` :170-174). The ensemble
(``infer/ensemble.py``) averages them.

Spans (``utils/profile.py``): ``program.sweep`` around the fine forwards
and their TTA reduce (every tile of the staged sweep, the monolithic
window, the split cascade's fine stage), ``program.cc`` around the device
postprocessing (``ops/connected_components.py``: on the card the kernel
makes no host read; on the CPU the plain form's host reads are ``cc.sync``
spans).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..configs.presets import InferenceConfig
from ..data.preprocess import centered_crop_start, mask_bbox_center, zscore
from ..infer.tiling import blend_weight, sliding_window_probs, tile_origins
from ..infer.tta import FLIPS, store_dtype, tta_probs, tta_reduce, tta_stack
from ..ops.connected_components import postprocess_device
from ..ops.library import device_const
from ..ops.resize import resize_trilinear
from ..utils import profile
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


_GRID_SCALES: dict = {}


def _grid_scale(canvas, coarse_shape, device) -> torch.Tensor:
    """Canvas / coarse-grid ratio per axis, f32, built once per device
    (``ops.library.device_const``)."""
    return device_const(
        _GRID_SCALES, (canvas, coarse_shape, device),
        lambda: torch.tensor([c / s for c, s in zip(canvas, coarse_shape)],
                             dtype=torch.float32, device=device))


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


def probs_from_blocks(blk: torch.Tensor, stem: int) -> torch.Tensor:
    """(d, h, w, r, r, r, K) block probabilities -> (d*r, h*r, w*r, K)
    (:236-245): the rearrange of :func:`labels_from_blocks` with the class
    axis riding along, so ``argmax(probs_from_blocks(p)) ==
    labels_from_blocks(argmax(p))`` exactly."""
    r = stem
    d, h, w = blk.shape[:3]
    return blk.permute(0, 3, 1, 4, 2, 5, 6).reshape(
        d * r, h * r, w * r, blk.shape[-1])


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

    def _fine_logits(self, tiles: torch.Tensor) -> torch.Tensor:
        """The fine forward: up to the pre-depth-to-space head with stem > 1
        (for the low-res reduce), at full resolution with stem 1."""
        with profile.span("program.sweep"):
            return (self.fine(tiles, subpixel=False) if self.stem > 1
                    else self.fine(tiles))

    def _reduce(self, logits: torch.Tensor) -> torch.Tensor:
        """One volume's flip batch of logits -> ROI labels (uint8): the
        low-res TTA reduce (:355-360) or the full-resolution one (:346-353),
        then device postprocessing when configured."""
        if self.stem > 1:
            probs = lowres_mean_probs(
                logits, self.stem, self.num_classes, self.store_dt
            )
            blk = torch.argmax(probs, dim=-1).to(torch.uint8)
            labels = labels_from_blocks(blk, self.stem)
        else:
            probs8 = torch.softmax(logits.float(), dim=-1)
            probs = tta_reduce(probs8.to(self.store_dt))
            labels = torch.argmax(probs, dim=-1).to(torch.uint8)
        if self.cfg.postproc == "device":
            with profile.span("program.cc"):
                labels = postprocess_device(
                    labels, self.cfg.min_component_voxels, self.cfg.et_min_voxels
                )
        return labels

    def stage_finish(
        self, tiles: torch.Tensor, start: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fine forward at batch 8 + TTA reduce -> ROI labels (uint8)."""
        return self._reduce(self._fine_logits(tiles)), start

    def stage_finish_pair(
        self, tiles_a: torch.Tensor, tiles_b: torch.Tensor,
        start_a: torch.Tensor, start_b: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Two volumes' flip stacks through one fine forward at batch 16,
        each half reduced as :meth:`stage_finish` reduces it (:373-389):
        ``(labels_a, start_a, labels_b, start_b)``. The serving path's
        volume pairing (``InferenceConfig.batch_volumes`` 2)."""
        n = tiles_a.shape[0]
        logits = self._fine_logits(torch.cat([tiles_a, tiles_b]))
        return (self._reduce(logits[:n]), start_a,
                self._reduce(logits[n:]), start_b)

    def stage_finish_probs(
        self, tiles: torch.Tensor, start: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The probability sibling of :meth:`stage_finish` (:390-402): the
        same mean probabilities the labels are argmaxed from, at full
        resolution, f32, not postprocessed."""
        logits = self._fine_logits(tiles)
        if self.stem > 1:
            probs = probs_from_blocks(lowres_mean_probs(
                logits, self.stem, self.num_classes, self.store_dt), self.stem)
        else:
            probs8 = torch.softmax(logits.float(), dim=-1)
            probs = tta_reduce(probs8.to(self.store_dt))
        return probs.float(), start

    def probs(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean probabilities f32 over the ROI, start): ``stage_roi`` (the
        label path's, still without a host wait) then
        :meth:`stage_finish_probs`."""
        return self.stage_finish_probs(*self.stage_roi(image))

    def __call__(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        tiles, start = self.stage_roi(image)
        return self.stage_finish(tiles, start)


def lowres_blend_weight(
    weight_np: np.ndarray, tile: Tuple[int, int, int], stem: int
) -> np.ndarray:
    """Blend weight in low-res block form (:59-70): (tx, ty, tz, 1) ->
    (tx/r, ty/r, tz/r, r, r, r, 1), the space-to-depth rearrange of the
    full-res weight, so low-res blended accumulation is the exact permutation
    of full-res blended accumulation."""
    r = stem
    return weight_np.reshape(
        tile[0] // r, r, tile[1] // r, r, tile[2] // r, r, 1
    ).transpose(0, 2, 4, 1, 3, 5, 6)


class _Program:
    """What the monolithic and staged programs share: the configuration,
    the sweep's static origins and blend weight, the z-score and the coarse
    ROI (or the whole canvas and a zero start), and the device
    postprocessing of the labels."""

    def __init__(self, fine: UNet3D, coarse: Optional[UNet3D],
                 cfg: InferenceConfig, canvas: Tuple[int, int, int],
                 num_classes: int):
        self.fine, self.coarse, self.cfg = fine, coarse, cfg
        self.canvas = tuple(canvas)
        self.num_classes = num_classes
        self.stem = fine.config.stem_downsample
        self.tile = tuple(cfg.tile)
        self.roi = tuple(min(r, c) for r, c in zip(cfg.roi_shape, canvas))
        self.sweep_shape = self.roi if self.coarse is not None else self.canvas
        self.origins = tile_origins(self.sweep_shape, self.tile, cfg.overlap)
        self.weight_np = blend_weight(self.tile, cfg.blend,
                                      cfg.gaussian_sigma_frac)
        self.store_dt = store_dtype(cfg.tta_precision)
        self._consts: dict = {}

    def _const(self, name: str, array: np.ndarray, device) -> torch.Tensor:
        """``array`` on ``device``, copied there once
        (``ops.library.device_const``)."""
        return device_const(
            self._consts, (name, str(device)),
            lambda: torch.from_numpy(np.ascontiguousarray(array)).to(device))

    def _region(self, image: torch.Tensor):
        """z-score, then the coarse ROI when cascading, else the canvas."""
        image = zscore(image.float())
        if self.coarse is not None:
            return coarse_locate(self.coarse, image, self.cfg, self.canvas,
                                 self.roi)
        return image, torch.zeros(3, dtype=torch.int32, device=image.device)

    def _finish_one(self, labels: torch.Tensor) -> torch.Tensor:
        if self.cfg.postproc == "device":
            with profile.span("program.cc"):
                return postprocess_device(labels, self.cfg.min_component_voxels,
                                          self.cfg.et_min_voxels)
        return labels


class Monolithic(_Program):
    """The reference's monolithic ``predict`` (:135-168): z-score + (coarse
    ROI) + the blended sliding window of ``tta_probs`` + argmax (+ device
    postprocessing)."""

    def probs(self, image: torch.Tensor):
        """(mean probabilities f32 over the ROI, start): the shared core of
        the label and probability outputs (:135-155), the latter
        ``predict_probs_monolithic`` (:170-174)."""
        region, start = self._region(image)
        weight = self._const("weight", self.weight_np, region.device)
        with profile.span("program.sweep"):
            probs = sliding_window_probs(
                lambda p: tta_probs(self.fine, p, enabled=self.cfg.tta_flips,
                                    precision=self.cfg.tta_precision),
                region, self.origins, self.tile, weight, self.num_classes)
        return probs.float(), start

    def __call__(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        probs, start = self.probs(image)
        labels = torch.argmax(probs, dim=-1).to(torch.uint8)
        return self._finish_one(labels), start


class StagedSweep(_Program):
    """The staged multi-tile TTA sweep (:254-337): ``stage_sweep_stack``
    then ``stage_sweep_finish``; the convs never see a flip."""

    def stage_sweep_stack(self, image: torch.Tensor):
        """z-score (+ coarse ROI) + every origin's flip stack:
        ((T, 8, tx, ty, tz, C), start)."""
        region, start = self._region(image)
        tx, ty, tz = self.tile
        stacks = torch.stack([
            tta_stack(region[o0:o0 + tx, o1:o1 + ty, o2:o2 + tz],
                      self.cfg.tta_precision)
            for o0, o1, o2 in self.origins.tolist()
        ])
        return stacks, start

    def sweep_probs_lr(self, stacks: torch.Tensor) -> torch.Tensor:
        """Per tile, in origin order: the fine forward at batch 8 up to the
        pre-d2s head, the low-res TTA mean, blended into a low-res block
        canvas (d, h, w, r, r, r, K) of weight-normalised probabilities."""
        r, k = self.stem, self.num_classes
        tile_lr = tuple(t // r for t in self.tile)
        sweep_lr = tuple(s // r for s in self.sweep_shape)
        dev = stacks.device
        w_lr = self._const("weight_lr", lowres_blend_weight(
            self.weight_np, self.tile, r), dev)
        canvas = torch.zeros(sweep_lr + (r, r, r, k), dtype=torch.float32,
                             device=dev)
        wsum = torch.zeros(sweep_lr + (r, r, r, 1), dtype=torch.float32,
                           device=dev)
        with profile.span("program.sweep"):
            for chunk, (o0, o1, o2) in zip(stacks, (self.origins // r).tolist()):
                probs = lowres_mean_probs(self.fine(chunk, subpixel=False), r, k,
                                          self.store_dt)
                sl = (slice(o0, o0 + tile_lr[0]), slice(o1, o1 + tile_lr[1]),
                      slice(o2, o2 + tile_lr[2]))
                canvas[sl] += probs * w_lr
                wsum[sl] += w_lr
            return canvas / torch.clamp(wsum, min=1e-8)

    def stage_sweep_finish(self, stacks: torch.Tensor, start: torch.Tensor):
        blk = torch.argmax(self.sweep_probs_lr(stacks), dim=-1).to(torch.uint8)
        return self._finish_one(labels_from_blocks(blk, self.stem)), start

    def stage_sweep_probs(self, stacks: torch.Tensor, start: torch.Tensor):
        """(:322-323) The blended low-res probabilities at full
        resolution, f32."""
        return probs_from_blocks(self.sweep_probs_lr(stacks), self.stem), start

    def probs(self, image: torch.Tensor):
        """(mean probabilities f32 over the sweep, start)."""
        return self.stage_sweep_probs(*self.stage_sweep_stack(image))

    def __call__(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.stage_sweep_finish(*self.stage_sweep_stack(image))


def make_predict_fn(
    fine: UNet3D,
    cfg: InferenceConfig,
    canvas: Tuple[int, int, int],
    num_classes: int = 4,
    coarse: Optional[UNet3D] = None,
    allow_split: bool = True,
):
    """The port of ``make_predict_fn`` (:73-339): the split single-tile
    cascade, the staged sweep or the monolithic program, chosen by the
    reference's predicates (the port's fine net always has the pre-d2s
    head the reference passes as ``fine_lowres_apply``). Each is called
    with the canvas and returns ``(labels_roi uint8, start int32)``."""
    tile = tuple(cfg.tile)
    use_cascade = cfg.cascade and coarse is not None
    roi = tuple(min(r, c) for r, c in zip(cfg.roi_shape, canvas))
    sweep_shape = roi if use_cascade else tuple(canvas)
    origins = tile_origins(sweep_shape, tile, cfg.overlap)
    stem = fine.config.stem_downsample
    split_tta = (allow_split and use_cascade and cfg.tta_flips
                 and len(origins) == 1 and roi == tile)
    if split_tta:
        return SplitCascade(fine, coarse, cfg, canvas, num_classes)
    staged_sweep = (
        allow_split
        and cfg.tta_flips
        and stem > 1
        and len(origins) > 1
        and all(t % stem == 0 for t in tile)
        and all(s % stem == 0 for s in sweep_shape)
        and bool((origins % stem == 0).all())
    )
    cls = StagedSweep if staged_sweep else Monolithic
    return cls(fine, coarse if use_cascade else None, cfg, canvas, num_classes)
