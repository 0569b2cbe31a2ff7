"""Checkpoint ensembling at predict time (reference:
``brats2019_tpu/infer/ensemble.py`` :47-396): the teacher of the paper behind
the reference (arXiv:2002.03688) averages several trained models' class
probabilities, and this serves that ensemble.

* Each member is a ``UNet3D`` (and a coarse net when cascading) built once
  on the device, with its own predict program (``models/cascade.py``
  ``make_predict_fn``); each keeps its cached compute-dtype conv kernels. The
  reference's one compiled program with traced params is a compile-time
  concern that eager PyTorch does not have.
* The mean is of probabilities, never a vote. Each member's ROI
  probabilities (the program's ``probs``) are added into a device-resident
  f32 sum canvas at that member's own cascade ``start`` (members may
  localise different ROIs), beside an f32 coverage count. The add gathers
  and scatters through index tensors built from the device ``start``, as
  ``crop_region`` does, so no member pass waits for the host. Member order
  fixes the reduction order: the f32 sum is deterministic.
* Labels are the argmax of the raw sum (the count is a per-voxel scalar
  across classes, so it does not move the argmax; never-written voxels sum
  to zero, argmax 0 = background); the mean is sum / max(count, 1). Only the
  uint8 label canvas or the f32 mean crosses to the host, once.
* Postprocessing runs on the host (:283-300): the device connected
  components live in the label program, which the ensemble bypasses.
* Member-parallel over several cards (:201-220): member i runs on device
  i mod n of ``devices`` (default: every local card for a ``cuda`` predictor,
  else the predictor's device), the input copied once to each device, and
  ``_reduce_results`` gathers the members' ROI results to the first device
  and adds them there in member order, so the f32 sum is the one-device
  sum bitwise. On one device the members run one after another, as the
  reference's sequential path (:236-241).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs.presets import ExperimentConfig
from ..data.constants import NUM_MODALITIES, internal_to_disk
from ..models.cascade import make_predict_fn
from ..utils.nifti import write_nifti
from ..utils.weights import build_network, require_unet
from .postprocess import postprocess_labels
from .predictor import (
    PredictionStats,
    Predictor,
    _start_host_copy,
    background_fill,
    save_probs_npz,
)


class EnsemblePredictor:
    """Mean-probability ensemble over M trained members.

    ``members`` is a sequence of ``(params_fine, params_coarse)`` pairs
    (flat export dicts or ``params.npz`` paths; ``params_coarse`` may be None
    without the cascade, and a member without one reuses the primary's
    coarse net). All members share one device and the primary's host prep.
    """

    def __init__(
        self,
        exp: ExperimentConfig,
        members: Sequence[Tuple],
        device: Union[str, torch.device] = "cuda",
        devices: Optional[Sequence] = None,
    ):
        require_unet(exp.unet, "the ensemble")
        if not members:
            raise ValueError("EnsemblePredictor needs at least one member")
        pf0, pc0 = members[0]
        self._p = Predictor(exp, pf0, pc0, device=device)
        self.exp = exp
        self.device = self._p.device
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if self.device.type == "cuda" and self.device.index is None
                       else [self.device])
        self._devices = [torch.device(d) for d in devices]
        self._programs = [self._p.program] + [
            self._member_program(pf, pc, self._member_device(i))
            for i, (pf, pc) in enumerate(members[1:], start=1)]

    def _member_device(self, i: int) -> torch.device:
        """Member i's device (i mod n of ``devices``)."""
        return self._devices[i % len(self._devices)]

    def _member_program(self, params_fine, params_coarse, device):
        """A member's nets and predict program, built once on its device (a
        member without coarse params reuses the primary's coarse net, on
        its device)."""
        exp, p = self.exp, self._p
        fine = build_network(exp.unet, params_fine, device)
        coarse = p.coarse
        if coarse is not None:
            if params_coarse is not None:
                coarse = build_network(exp.coarse_unet, params_coarse, device)
            elif next(coarse.parameters()).device != torch.device(device):
                coarse = build_network(exp.coarse_unet, {
                    "params/" + k.replace(".", "/"): v.detach().cpu().numpy()
                    for k, v in coarse.state_dict().items()}, device)
        return make_predict_fn(fine, exp.infer, p.canvas,
                               num_classes=exp.unet.num_classes, coarse=coarse)

    @property
    def num_members(self) -> int:
        return len(self._programs)

    def reload_members(self, members: Sequence[Tuple]) -> None:
        """Swap the members' weights (``serve``'s SIGHUP hot reload): the
        primary's in place, the others rebuilt; the member count may
        change."""
        if not members:
            raise ValueError("reload_members needs at least one member")
        pf0, pc0 = members[0]
        self._p.reload_params(pf0, pc0)
        self._programs = [self._p.program] + [
            self._member_program(pf, pc, self._member_device(i))
            for i, (pf, pc) in enumerate(members[1:], start=1)]

    # ---------------------------------------------------------- on the device --

    def accumulate(self, canvas_img: torch.Tensor):
        """(sum, coverage count) of the members' ROI probabilities on f32
        device canvases, added in member order, not yet divided."""
        with torch.inference_mode():
            return self._reduce_results(self._accum_probs_parallel(canvas_img),
                                        canvas_img.device)

    def _accum_probs_parallel(self, canvas_img: torch.Tensor) -> list:
        """Every member's (probs_roi, start), member i on its device (the
        input copied there once a device); on CUDA the members' launches
        queue on their own cards, so they run side by side."""
        x_on = {canvas_img.device: canvas_img}
        results = []
        for i, program in enumerate(self._programs):
            dev = canvas_img.device if i == 0 else self._member_device(i)
            if dev not in x_on:
                x_on[dev] = canvas_img.to(dev)
            results.append(program.probs(x_on[dev]))
        return results

    def _reduce_results(self, results, dev):
        """The members' results gathered to ``dev`` and added there in member
        order (the same f32 sum whichever device made each)."""
        shape = self._p.canvas
        with torch.inference_mode():
            acc = torch.zeros(shape + (self.exp.unet.num_classes,),
                              dtype=torch.float32, device=dev)
            cnt = torch.zeros(shape, dtype=torch.float32, device=dev)
            for probs_r, start in results:
                probs_r, start = probs_r.to(dev), start.to(dev)
                if tuple(probs_r.shape[:3]) == shape:
                    acc += probs_r
                    cnt += 1.0
                    continue
                # the ROI's voxels, from the device start: no host wait
                ix, iy, iz = (torch.arange(r, device=dev) + start[ax].long()
                              for ax, r in enumerate(probs_r.shape[:3]))
                idx = (ix[:, None, None], iy[None, :, None], iz[None, None, :])
                acc[idx] = acc[idx] + probs_r
                cnt[idx] = cnt[idx] + 1.0
        return acc, cnt

    def labels_device(self, canvas_img: torch.Tensor) -> torch.Tensor:
        """argmax of the ensemble sum: the uint8 label canvas."""
        acc, _ = self.accumulate(canvas_img)
        return torch.argmax(acc, dim=-1).to(torch.uint8)

    def mean_device(self, canvas_img: torch.Tensor) -> torch.Tensor:
        """The per-voxel mean: sum / max(count, 1)."""
        acc, cnt = self.accumulate(canvas_img)
        return acc / torch.clamp(cnt, min=1.0)[..., None]

    @staticmethod
    def _fetch(t: torch.Tensor) -> np.ndarray:
        (host,), event = _start_host_copy(t)
        if event is not None:
            event.synchronize()
        return host.numpy()

    def warmup(self, probs: bool = False, stage: str = "all") -> float:
        """Run the ensemble's device work once on a zero canvas and fetch it
        (``serve --warmup``): ``"primary"`` the label path (every member's
        probability program, the accumulation, the argmax), ``"rest"`` the
        mean (only when ``probs``: the daemon writes probability or
        uncertainty artifacts), ``"all"`` both. Returns wall seconds."""
        if stage not in ("all", "primary", "rest"):
            raise ValueError(f"warmup stage {stage!r}")
        t0 = time.time()
        x = torch.zeros(self._p.canvas + (NUM_MODALITIES,),
                        dtype=torch.bfloat16, device=self.device)
        if stage in ("all", "primary"):
            self._fetch(self.labels_device(x))
        if stage in ("all", "rest") and probs:
            self._fetch(self.mean_device(x))
        return time.time() - t0

    # ------------------------------------------------------------ host side --

    def _postprocess(self, labels: np.ndarray) -> np.ndarray:
        inf = self.exp.infer
        return postprocess_labels(labels,
                                  min_component_voxels=inf.min_component_voxels,
                                  et_min_voxels=inf.et_min_voxels)

    def _finish_labels(self, labels_c: np.ndarray, shape, bbox) -> np.ndarray:
        from ..data.preprocess import uncrop_from_canvas_np

        labels = uncrop_from_canvas_np(labels_c, shape, bbox, self._p.canvas)
        return self._postprocess(labels)

    def _mean_probs(self, canvas_img, shape, bbox) -> np.ndarray:
        from ..data.preprocess import uncrop_from_canvas_np

        canvas_p = self._fetch(self.mean_device(canvas_img))
        probs = uncrop_from_canvas_np(canvas_p, shape, bbox, self._p.canvas)
        return background_fill(probs)

    def predict_probs_arrays(
        self, image: np.ndarray, meta: Optional[dict] = None
    ) -> Tuple[np.ndarray, PredictionStats]:
        """Ensemble-mean class probabilities (X, Y, Z, C) f32; voxels no
        member wrote get exact background one-hot."""
        t0 = time.time()
        canvas, shape, bbox = self._p.prepare(image, meta)
        t1 = time.time()
        probs = self._mean_probs(canvas, shape, bbox)
        t2 = time.time()
        return probs, PredictionStats(t1 - t0, t2 - t1, 0.0)

    def _labels_from_prepped(self, canvas_img, shape, bbox):
        t1 = time.time()
        labels_c = self._fetch(self.labels_device(canvas_img))
        t2 = time.time()
        return self._finish_labels(labels_c, shape, bbox), t2 - t1, time.time() - t2

    def predict_arrays(
        self, image: np.ndarray, meta: Optional[dict] = None
    ) -> Tuple[np.ndarray, PredictionStats]:
        """argmax of the ensemble-mean probabilities -> internal labels
        (X, Y, Z) uint8, host postprocessed."""
        t0 = time.time()
        canvas, shape, bbox = self._p.prepare(image, meta)
        t1 = time.time()
        labels, dev_s, post_s = self._labels_from_prepped(canvas, shape, bbox)
        return labels, PredictionStats(t1 - t0, dev_s, post_s)

    def predict_case(self, case) -> Tuple[np.ndarray, PredictionStats]:
        """``predict_arrays`` on a loaded case (``evaluate --ensemble``)."""
        return self.predict_arrays(case.image, meta=case.meta)

    def _prep_dir(self, case_dir: str):
        """The primary's cached case-directory prep, ready on this stream:
        (name, header, canvas, cropped shape, bbox)."""
        name, header, prepped, shape, bbox = self._p._prep_dir_to(case_dir)
        return name, header, self._p._await_canvas(*prepped), shape, bbox

    def _write(self, labels, name, header, case_dir, out) -> str:
        if out is None:
            out = os.path.join(case_dir, f"{name}_pred.nii.gz")
        write_nifti(out, internal_to_disk(labels).astype(np.uint8), like=header)
        return out

    def predict_dir(
        self, case_dir: str, output_path: Optional[str] = None
    ) -> Tuple[str, PredictionStats]:
        t0 = time.time()
        name, header, canvas, shape, bbox = self._prep_dir(case_dir)
        t1 = time.time()
        labels, dev_s, post_s = self._labels_from_prepped(canvas, shape, bbox)
        out = self._write(labels, name, header, case_dir, output_path)
        return out, PredictionStats(t1 - t0, dev_s, post_s)

    def predict_dirs(self, case_dirs, output_paths=None) -> list:
        """The multi-case path (``serve``'s batch entry point, :323-367): each
        case's members and argmax are launched ahead of the host, its label
        canvas's readback started, and at most ``serving_depth`` cases (each
        an f32 sum canvas, ~110 MB at the flagship canvas) are in flight
        before the oldest is drained (fetched, un-cropped, postprocessed,
        written). Returns the output paths."""
        if output_paths is None:
            output_paths = [None] * len(case_dirs)
        window = max(1, self.exp.infer.serving_depth)
        pending, outs = [], []

        def drain_one():
            name, header, d, fetched, shape, bbox, out = pending.pop(0)
            (labels_c,), event = fetched
            if event is not None:
                event.synchronize()
            labels = self._finish_labels(labels_c.numpy(), shape, bbox)
            outs.append(self._write(labels, name, header, d, out))

        for d, out in zip(case_dirs, output_paths):
            name, header, canvas, shape, bbox = self._prep_dir(d)
            fetched = _start_host_copy(self.labels_device(canvas))
            pending.append((name, header, d, fetched, shape, bbox, out))
            while len(pending) >= window:
                drain_one()
        while pending:
            drain_one()
        return outs

    def prefill_payload_cache(self, case_dir: str) -> bool:
        """Members share one prep: the primary's payload cache."""
        return self._p.prefill_payload_cache(case_dir)

    def probs_for_dir(self, case_dir: str):
        """The ensemble-mean probability pass for one case directory through
        the payload cache. Returns ``(name, header, probs)``."""
        name, header, canvas, shape, bbox = self._prep_dir(case_dir)
        return name, header, self._mean_probs(canvas, shape, bbox)

    def predict_probs_dir(
        self, case_dir: str, output_path: Optional[str] = None
    ) -> str:
        """Ensemble-mean probability canvas as ``<case>_probs.npz`` (the
        artifact contract of ``Predictor.predict_probs_dir``)."""
        name, _header, probs = self.probs_for_dir(case_dir)
        if output_path is None:
            output_path = os.path.join(case_dir, f"{name}_probs.npz")
        return save_probs_npz(output_path, probs)
