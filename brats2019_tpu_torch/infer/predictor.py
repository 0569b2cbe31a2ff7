"""Whole-case prediction (reference: ``brats2019_tpu/infer/predictor.py``).

Host: NIfTI decode, brain bbox, bucketed crop + bf16 cast (:432-475). One
host->device copy of the crop, embedded into the zero canvas on the device.
Device: the split cascade (``models/cascade.py``) returns the ROI labels and
their start. Host: paste into the canvas, un-crop, scipy postprocessing
(:282-342), NIfTI write with the input header.

Cases run one after another. The reference's pipelined serving path, the
payload cache and memo, int8 transfer and volume pairing are later work
(ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..configs.presets import ExperimentConfig
from ..data.case import load_case
from ..data.constants import internal_to_disk
from ..data.preprocess import (
    BBox,
    brain_bbox_fast_np,
    crop_cast_bucket_np,
    crop_cast_fit_np,
    uncrop_from_canvas_np,
)
from ..models.cascade import make_predict_fn
from ..utils.nifti import write_nifti
from ..utils.weights import build_unet
from .postprocess import postprocess_labels


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The requested device; a CUDA request on a host without a card raises
    (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain torch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclasses.dataclass
class PredictionStats:
    load_s: float
    device_s: float
    post_s: float

    @property
    def total_s(self) -> float:
        return self.load_s + self.device_s + self.post_s


class Predictor:
    """Reusable whole-volume predictor. ``params_fine``/``params_coarse`` are
    flat export dicts or ``params.npz`` paths (``utils/weights.py``)."""

    def __init__(
        self,
        exp: ExperimentConfig,
        params_fine,
        params_coarse=None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.exp = exp
        self.device = resolve_device(device)
        if exp.infer.transfer_dtype != "bfloat16":
            raise NotImplementedError(
                "only the bf16 transfer encoding is ported; int8 is ROADMAP "
                "queue 1 item 4"
            )
        self.canvas = tuple(exp.infer.canvas or exp.train.pool_shape)
        self.fine = build_unet(exp.unet, params_fine, self.device)
        self.coarse = None
        if (exp.infer.cascade and exp.coarse_unet is not None
                and params_coarse is not None):
            self.coarse = build_unet(exp.coarse_unet, params_coarse, self.device)
        self.program = make_predict_fn(
            self.fine, exp.infer, self.canvas,
            num_classes=exp.unet.num_classes, coarse=self.coarse,
        )

    # ------------------------------------------------------------- host side --

    def _encode_host(
        self, image: np.ndarray
    ) -> Tuple[torch.Tensor, Optional[Tuple[int, int, int]], BBox]:
        """Brain bbox -> (bucketed) crop + bf16 cast: the bytes that cross
        to the device. ``dst is None`` means ``small`` is the whole canvas."""
        bbox = brain_bbox_fast_np(image)
        bucket = self.exp.infer.transfer_bucket
        if bucket:
            small, dst = crop_cast_bucket_np(image, bbox, self.canvas, bucket)
            return small, dst, bbox
        return crop_cast_fit_np(image, bbox, self.canvas), None, bbox

    def _to_device(self, small: torch.Tensor,
                   dst: Optional[Tuple[int, int, int]]) -> torch.Tensor:
        """Copy the payload to the device and embed it into the zero canvas."""
        small = small.to(self.device)
        if dst is None:
            return small
        canvas = torch.zeros(self.canvas + tuple(small.shape[3:]),
                             dtype=small.dtype, device=self.device)
        x, y, z = dst
        sx, sy, sz = small.shape[:3]
        canvas[x:x + sx, y:y + sy, z:z + sz] = small
        return canvas

    def prepare(self, image: np.ndarray):
        """Host encode + copy to the device: (canvas on the device, cropped
        shape, bbox)."""
        small, dst, bbox = self._encode_host(image)
        return self._to_device(small, dst), bbox.shape, bbox

    def _paste_roi(self, labels_r: np.ndarray, start: np.ndarray) -> np.ndarray:
        """Place the ROI labels into a zero canvas."""
        if labels_r.shape == self.canvas:
            return labels_r
        out = np.zeros(self.canvas, dtype=labels_r.dtype)
        sx, sy, sz = (int(v) for v in start)
        rx, ry, rz = labels_r.shape
        out[sx:sx + rx, sy:sy + ry, sz:sz + rz] = labels_r
        return out

    def _finish(self, labels_r: torch.Tensor, start: torch.Tensor,
                cropped_shape, bbox: BBox) -> np.ndarray:
        labels_c = self._paste_roi(labels_r.cpu().numpy(), start.cpu().numpy())
        labels = uncrop_from_canvas_np(labels_c, cropped_shape, bbox, self.canvas)
        return postprocess_labels(
            labels,
            min_component_voxels=self.exp.infer.min_component_voxels,
            et_min_voxels=self.exp.infer.et_min_voxels,
        )

    # ------------------------------------------------------------ entry points --

    def predict_device(self, canvas_img: torch.Tensor):
        """The device program on an embedded canvas: (labels_roi, start)."""
        with torch.inference_mode():
            return self.program(canvas_img)

    def predict_arrays(
        self, image: np.ndarray
    ) -> Tuple[np.ndarray, PredictionStats]:
        """image: raw (X, Y, Z, 4) float32 -> internal labels (X, Y, Z) uint8."""
        t0 = time.time()
        canvas_img, cropped_shape, bbox = self.prepare(image)
        t1 = time.time()
        labels_r, start = self.predict_device(canvas_img)
        labels_r, start = labels_r.cpu(), start.cpu()
        t2 = time.time()
        labels = self._finish(labels_r, start, cropped_shape, bbox)
        return labels, PredictionStats(t1 - t0, t2 - t1, time.time() - t2)

    def predict_dir(
        self, case_dir: str, output_path: Optional[str] = None
    ) -> Tuple[str, PredictionStats]:
        """Predict one BraTS case directory and write ``<case>_pred.nii.gz``
        (BraTS disk labels, input header) next to it or at output_path."""
        t0 = time.time()
        case = load_case(case_dir)
        stats = PredictionStats(time.time() - t0, 0.0, 0.0)
        labels, s = self.predict_arrays(case.image)
        t1 = time.time()
        if output_path is None:
            output_path = os.path.join(case_dir, f"{case.name}_pred.nii.gz")
        write_nifti(output_path, internal_to_disk(labels).astype(np.uint8),
                    like=case.header)
        stats.load_s += s.load_s
        stats.device_s = s.device_s
        stats.post_s = s.post_s + time.time() - t1
        return output_path, stats

    def predict_dirs(self, case_dirs, output_paths=None) -> list:
        """Predict several case directories in order; returns output paths."""
        if output_paths is None:
            output_paths = [None] * len(case_dirs)
        return [self.predict_dir(d, out)[0]
                for d, out in zip(case_dirs, output_paths)]
