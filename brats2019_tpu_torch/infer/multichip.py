"""Whole-volume inference over the mesh (reference:
``brats2019_tpu/infer/multichip.py``), the three decompositions behind
``--multichip``:

* ``spatial``: ONE whole-volume forward with the volume's X axis split over
  the shards, halos for the convs and the up, the InstanceNorm statistics
  over the whole volume (``parallel/spatial_unet.py``). No TTA, no window;
  needs canvas X divisible by ``stem * 2^(levels-1) * shards``. Its parity
  reference is the unsharded whole-volume forward.
* ``sweep``: the sliding window's (tile x 8-flip) items striped over the
  shards, one ROI-sized psum (``parallel/spatial.py``
  ``distributed_tile_sweep``): the single-stage predictor's masks
  (``cascade=False``), except on ties.
* ``cascade``: the flagship program's decomposition: the coarse stage
  replicated, the fine ROI's (tile x flip) items striped, the TTA reduce in
  the low-res block form, one psum (``distributed_cascade_sweep``): the
  cascade predictor's masks, except on ties. With ``members`` (``--ensemble``)
  every member's sweep in turn, the mean-probability argmax
  (``distributed_cascade_ensemble``): the ensemble predictor's masks.

Host side as the single-device ``Predictor``: brain bbox, crop + cast +
center-fit into the canvas, un-crop, postprocessing on the host (the device
connected components live in the single-device label program). The models
are built once per distinct device of the mesh (``["cuda:0"] * N`` puts N
shards on one card: one replica serves them all).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..configs.presets import ExperimentConfig
from ..data.preprocess import (brain_bbox_fast_np, crop_cast_fit_np,
                               uncrop_from_canvas_np, zscore)
from ..parallel.mesh import MeshEnv, make_mesh
from ..utils import profile
from ..utils.weights import build_network, load_params, require_unet, state_dict_from_flat
from .postprocess import postprocess_labels
from .tiling import blend_weight, tile_origins

# the one shared inverse of crop_cast_fit_np + bbox crop (the single-device
# Predictor un-crops through the same function)
uncrop_labels = uncrop_from_canvas_np


class _Replicas:
    """A stage's ``UNet3D`` built from flat params once per device; a
    reload loads the new weights into every replica."""

    def __init__(self, cfg, params):
        self.cfg = cfg
        self.flat = load_params(params) if isinstance(params, str) else params
        self._on: Dict[torch.device, torch.nn.Module] = {}

    def on(self, dev: torch.device) -> torch.nn.Module:
        if dev not in self._on:
            # built outside inference mode (a sweep asks for a replica from
            # inside it), so a reload can load into the parameters
            with torch.inference_mode(False):
                self._on[dev] = build_network(self.cfg, self.flat, dev)
        return self._on[dev]

    def reload(self, params) -> None:
        self.flat = load_params(params) if isinstance(params, str) else params
        sd = state_dict_from_flat(self.flat)
        for m in self._on.values():
            m.load_state_dict(sd, strict=True)


class MultichipPredictor:
    """Whole-case prediction over a mesh (``mode`` spatial | sweep |
    cascade); a ``Predictor`` drop-in for the CLIs and the serving daemon."""

    def __init__(
        self,
        exp: ExperimentConfig,
        params_fine,
        mode: str = "sweep",
        env: Optional[MeshEnv] = None,
        params_coarse=None,
        members=None,
    ):
        require_unet(exp.unet, "the multichip predictor")
        if mode not in ("spatial", "sweep", "cascade"):
            raise ValueError(
                f"multichip mode must be spatial|sweep|cascade, got {mode!r}")
        if members is not None and mode != "cascade":
            raise ValueError(
                "--multichip ensemble composition is cascade-mode only "
                "(spatial/sweep are single-stage whole-canvas programs); "
                "use --multichip cascade with --ensemble")
        self.exp = exp
        self.mode = mode
        self.env = env or make_mesh()
        self.device = self.env.first
        self.canvas = tuple(exp.infer.canvas or exp.train.pool_shape)
        self.fine = _Replicas(exp.unet, params_fine)
        self.coarse = None
        self._members = None
        ucfg = exp.unet
        if mode == "cascade":
            from ..parallel.spatial import (distributed_cascade_ensemble,
                                            distributed_cascade_sweep)

            if not (exp.infer.cascade and exp.coarse_unet is not None):
                raise ValueError(
                    "--multichip cascade needs a cascade preset (coarse_unet "
                    "set and infer.cascade on); use --multichip sweep for "
                    "single-stage configs")
            if params_coarse is None:
                raise ValueError(
                    "--multichip cascade needs the trained coarse-stage "
                    "params (no coarse checkpoint found?)")
            self.coarse = _Replicas(exp.coarse_unet, params_coarse)
            if members is not None:
                self._put_members(members)
                self._ensemble = distributed_cascade_ensemble(
                    self._member_nets(), self.env, exp.infer, self.canvas,
                    ucfg.num_classes, stem=ucfg.stem_downsample)
                return
            self._cascade = distributed_cascade_sweep(
                self._nets(self.fine, self.coarse), self.env, exp.infer,
                self.canvas, ucfg.num_classes, stem=ucfg.stem_downsample)
        elif mode == "spatial":
            from ..parallel.spatial_unet import make_spatial_unet

            req = ucfg.min_spatial * self.env.n_data
            if self.canvas[0] % req:
                raise ValueError(
                    f"--multichip spatial needs canvas X ({self.canvas[0]}) "
                    f"divisible by stem*2^(levels-1)*n_devices = {req}; use "
                    f"--multichip sweep or a different device count")
            self._fwd = make_spatial_unet(self.env, self.fine.on(self.device))
        else:
            from ..parallel.spatial import distributed_tile_sweep

            tile = tuple(exp.infer.tile)
            origins = tile_origins(self.canvas, tile, exp.infer.overlap)
            weight = blend_weight(tile, exp.infer.blend,
                                  exp.infer.gaussian_sigma_frac)
            fine = self.fine

            def tile_probs(patch: torch.Tensor) -> torch.Tensor:
                logits = fine.on(patch.device)(patch[None])[0]
                return torch.softmax(logits.float(), dim=-1)

            self._sweep = distributed_tile_sweep(
                tile_probs, self.env, self.canvas, np.asarray(origins), tile,
                weight, ucfg.num_classes,
                n_flips=8 if exp.infer.tta_flips else 1)

    @staticmethod
    def _nets(fine: _Replicas, coarse: _Replicas):
        return lambda dev: (fine.on(dev), coarse.on(dev))

    def _put_members(self, members) -> None:
        """The (params_fine, params_coarse) member pairs, each a replica set;
        cascade members need a coarse stage each (``cli/common.py``
        ``load_ensemble_members`` substitutes the primary's)."""
        reps = []
        for pf, pc in members:
            if pc is None:
                raise ValueError(
                    "--multichip cascade --ensemble needs a coarse stage per "
                    "member (none found and no primary to substitute)")
            reps.append((_Replicas(self.exp.unet, pf),
                         _Replicas(self.exp.coarse_unet, pc)))
        self._members = reps

    def _member_nets(self):
        return [self._nets(f, c) for f, c in self._members]

    @property
    def num_members(self) -> int:
        """Ensemble member count (1 when not an ensemble)."""
        return len(self._members) if self._members is not None else 1

    # ----------------------------------------------------------- the device --

    @profile.entry
    def _run(self, canvas_img: torch.Tensor):
        """The mesh program on a (X, Y, Z, C) canvas: the label canvas (or
        the ROI labels and their start in cascade mode), on the first
        shard's device; a ``predict.program`` span with device edges
        (``utils/profile.py``)."""
        with torch.inference_mode(), profile.span("predict.program",
                                                  device_edges=True):
            if self._members is not None:
                return self._ensemble(canvas_img, self._member_nets()), None
            if self.mode == "cascade":
                return self._cascade(canvas_img)
            x = zscore(canvas_img.to(self.device).float())
            if self.mode == "spatial":
                probs = self._fwd(x)
            else:
                probs = self._sweep(x)
            return torch.argmax(probs, dim=-1).to(torch.uint8), None

    def warmup(self, probs: bool = False, stage: str = "all") -> float:
        """Run the mesh program once on a zero canvas and fetch its output
        (``serve --multichip --warmup``): the kernels' builds and the
        replicas on every device. One mesh program serves, so ``"primary"``
        is ``"all"`` and ``"rest"`` does nothing (the probability artifacts
        do not compose with ``--multichip``). Returns wall seconds."""
        from ..data.constants import NUM_MODALITIES

        if stage == "rest":
            return 0.0
        t0 = time.time()
        x = torch.zeros(self.canvas + (NUM_MODALITIES,), dtype=torch.bfloat16,
                        device=self.device)
        labels, start = self._run(x)
        labels.cpu()
        if start is not None:
            start.cpu()
        return time.time() - t0

    def reload_params(self, params_fine, params_coarse=None) -> None:
        """Swap the serving weights into every replica (``serve --multichip``
        + SIGHUP)."""
        if self.mode == "cascade" and params_coarse is None:
            raise ValueError("mode='cascade' reload needs the coarse-stage params")
        self.fine.reload(params_fine)
        if self.coarse is not None:
            self.coarse.reload(params_coarse)

    def reload_members(self, members) -> None:
        """Swap every ensemble member's weights (the count may change)."""
        if self._members is None:
            raise ValueError("reload_members on a non-ensemble predictor")
        if not members:
            raise ValueError("reload_members needs at least one member")
        self._put_members(members)

    # ------------------------------------------------------------- the host --

    def predict_arrays(self, image: np.ndarray) -> np.ndarray:
        """raw (X, Y, Z, 4) float32 -> internal labels (X, Y, Z) uint8: the
        single-device predictor's crop, cast and center-fit, the mesh
        program, paste, un-crop and host postprocessing."""
        bbox = brain_bbox_fast_np(image)
        canvas_img = crop_cast_fit_np(image, bbox, self.canvas)
        labels_r, start = self._run(canvas_img.to(self.device))
        labels_r = labels_r.cpu().numpy()
        if start is None:
            labels_c = labels_r
        else:
            labels_c = np.zeros(self.canvas, np.uint8)
            sx, sy, sz = (int(v) for v in start.cpu().tolist())
            rx, ry, rz = labels_r.shape
            labels_c[sx:sx + rx, sy:sy + ry, sz:sz + rz] = labels_r
        labels = uncrop_labels(labels_c, bbox.shape, bbox, self.canvas)
        return postprocess_labels(
            labels, min_component_voxels=self.exp.infer.min_component_voxels,
            et_min_voxels=self.exp.infer.et_min_voxels)

    def predict_case(self, case):
        """Predictor API (``evaluate --multichip``): (labels, None), no
        prep/device/post split."""
        return self.predict_arrays(case.image), None

    def predict_dir(self, case_dir: str, output_path: Optional[str] = None):
        """Predict one BraTS case directory and write ``<case>_pred.nii.gz``
        (or ``output_path``); returns the path. The whole mesh runs one case
        at a time."""
        from ..data.case import load_case
        from ..data.constants import internal_to_disk
        from ..utils.nifti import write_nifti

        case = load_case(case_dir)
        labels = self.predict_arrays(case.image)
        if output_path is None:
            output_path = os.path.join(case_dir, f"{case.name}_pred.nii.gz")
        write_nifti(output_path, internal_to_disk(labels).astype(np.uint8),
                    like=case.header)
        return output_path

    def predict_dirs(self, case_dirs: Sequence[str], output_paths=None) -> list:
        """The serving daemon's batch entry: cases in turn, each over the
        whole mesh. Returns the output paths."""
        if output_paths is None:
            output_paths = [None] * len(case_dirs)
        return [self.predict_dir(d, out)
                for d, out in zip(case_dirs, output_paths)]
