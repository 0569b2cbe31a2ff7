"""Whole-case prediction (reference: ``brats2019_tpu/infer/predictor.py``).

Host: NIfTI decode (the native threaded decoder when it is available,
``data/case.py``), brain bbox (the decoder's fused bbox from ``Case.meta``
where the reference takes it, :440-452, else the strided scan), bucketed crop
+ bf16 cast (:432-475), or with ``transfer_dtype="int8"`` an f32 crop
quantized per modality to int8 (half the bytes; lossy, opt-in). One
host->device copy of the crop, cast to bf16 on the device and embedded into
the zero canvas there, so the device program sees one input dtype.
Device: the program ``models/cascade.py`` ``make_predict_fn`` chose (the
split cascade, the staged sweep or the monolithic program) returns the ROI
labels and their start; without a cascade the ROI is the whole canvas and
the start is zeros. Host: paste into the canvas, un-crop, scipy postprocessing
unless the program already did it on the device (``postproc="device"``),
NIfTI write with the input header.

``predict_arrays`` / ``predict_dir`` run one case. ``predict_arrays_many`` /
``predict_dirs`` are the serving path (:344, :700): host prep, the device
program and host postprocessing overlap across the cases of a batch, and
with several cards (``devices``; default every local card for ``cuda``) the
cases are striped round-robin over them, case i on card i mod n, each card
running the whole program on its cases (its own copy of the nets, built at
its first case, and its own copy stream).
``InferenceConfig.serving_depth`` threads prepare cases (decode or payload
cache, encode, and on a card the copy from pinned memory on a copy stream,
with an event the compute stream waits on); ONE thread, the caller's,
launches every device program, in order; ``serving_depth`` threads fetch
(from pinned memory the device->host copy was started into), paste, un-crop,
postprocess and write. The labels equal the one-by-one path's bitwise.
With ``batch_volumes=2`` and the split cascade (:75-106, :408-417),
consecutive cases are paired: both run ``stage_roi``, then one fine forward
at batch 16 (``SplitCascade.stage_finish_pair``); a pair shares a lane (case
i on lane (i // 2) mod n) and an odd tail runs the single-volume
``stage_finish``. Both entry points print :func:`transfer_bound_hint`'s
advisory once per predictor when the host-to-device copy of the payloads,
timed alone, takes most of the pipeline's cadence.

Spans (``utils/profile.py``; all of one volume share its request id, the
call's number and the volume's index): ``predict.call`` around a call;
in the prep threads ``predict.prep`` (children ``prep.decode`` on the
directory path, ``prep.encode``, ``prep.copy``); on the dispatch thread
``predict.await_prep`` (the wait for a prepared canvas), ``predict.program``
(the device program; with pairing, an odd tail's ``stage_finish`` is a
second one of its volume) and, at the call's end, ``predict.await_post``
(the drain), each with device edges; in the post threads ``predict.post``
(children ``post.fetch``, ``post.finish``, ``post.write``).

The probability path (:628-695): ``predict_probs_arrays``, ``probs_for_dir``
(through the payload cache) and ``predict_probs_dir`` run the program's
``probs`` (the mean class probabilities the labels are argmaxed from), paste
the ROI at its start into an f32 canvas, un-crop, and give voxels no tile
wrote exact background; ``save_probs_npz`` writes the ``<case>_probs.npz``
artifact.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import sys
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..configs.presets import ExperimentConfig
from ..data.case import load_case, modality_paths
from ..data.constants import NUM_MODALITIES, internal_to_disk
from ..data.preprocess import (
    BBox,
    brain_bbox_fast_np,
    crop_cast_bucket_np,
    crop_cast_fit_np,
    quantize_int8_per_modality,
    uncrop_from_canvas_np,
)
from ..models.cascade import make_predict_fn
from ..utils import profile
from ..utils.nifti import read_header, write_nifti
from ..utils.weights import build_network, load_params, state_dict_from_flat
from .payload_cache import load_payload, payload_cache_path, store_payload
from .postprocess import postprocess_labels


def save_probs_npz(output_path: str, probs: np.ndarray) -> str:
    """The ``<case>_probs.npz`` artifact contract, in one place (predictor,
    ensemble, and the predict CLI all write through here; :43-60): float16
    ``probs`` (X, Y, Z, C) + ``classes`` naming the channel order in BraTS
    disk labels [0, 1, 2, 4]."""
    # temp+rename: a reader (GET /artifact) must never see a torn file
    tmp = f"{output_path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            probs=probs.astype(np.float16),
            classes=np.array([0, 1, 2, 4], np.int32),
        )
    os.replace(tmp, output_path)
    return output_path


def background_fill(probs: np.ndarray) -> np.ndarray:
    """Voxels that no tile or member wrote (all-zero probabilities) become
    exact background one-hot, in place; returns ``probs``."""
    probs[probs.sum(-1) == 0, 0] = 1.0
    return probs


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


def _start_host_copy(*tensors):
    """Start the device->host readback of ``tensors`` into pinned memory on
    the current stream, without blocking, so it overlaps the next volume's
    device work (:62). Returns (host tensors, event to wait on); CPU tensors
    come back as they are with no event."""
    if not tensors or tensors[0].device.type != "cuda":
        return tensors, None
    host = tuple(
        torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
            t, non_blocking=True)
        for t in tensors
    )
    event = torch.cuda.Event()
    event.record()
    return host, event


class _PairDispatcher:
    """Volume pairing (reference :75-106). ``dispatch`` runs a volume's
    ``stage_roi`` on its lane and holds its flip stack until a second volume
    of the same lane arrives; then one ``stage_finish_pair`` (the fine
    forward at batch 16) serves both, and each gets its readback through its
    ``emit``. ``flush`` sends each lane's odd tail through the single-volume
    ``stage_finish``. Called from the one dispatch thread."""

    def __init__(self, predictor: "Predictor"):
        self.p = predictor
        self.pending: dict = {}  # lane -> [(emit, tiles, start, req), ...]

    def dispatch(self, prepped, lane: int, emit, req=None) -> None:
        program, ctx = self.p._program_on(lane)
        with ctx, torch.inference_mode():
            with profile.span("predict.program", req, device_edges=True):
                tiles, start = program.stage_roi(self.p._await_canvas(*prepped))
                buf = self.pending.setdefault(lane, [])
                buf.append((emit, tiles, start, req))
                if len(buf) < 2:
                    return
                (e0, t0, s0, _), (e1, t1, s1, _) = buf
                buf.clear()
                la, sa, lb, sb = program.stage_finish_pair(t0, t1, s0, s1)
            e0(_start_host_copy(la, sa))
            e1(_start_host_copy(lb, sb))

    def flush(self) -> None:
        for lane, buf in self.pending.items():
            program, ctx = self.p._program_on(lane)
            with ctx, torch.inference_mode():
                for emit, tiles, start, req in buf:
                    with profile.span("predict.program", req, device_edges=True):
                        out = program.stage_finish(tiles, start)
                    emit(_start_host_copy(*out))
            buf.clear()


def transfer_bound_hint(
    copy_s, wall_s: float, n_volumes: int, transfer_dtype: str,
) -> Optional[str]:
    """Serving telemetry (the reference's policy, :109-131): when the
    host-to-device copies (``copy_s``, seconds a volume, the copy alone:
    decode and encode are not in it) take most of the pipeline cadence,
    recommend the int8 transfer encoding rather than switch to it: int8 is
    lossy, so changing the wire encoding of medical masks is the operator's
    call. A pure function, so the policy is testable."""
    if transfer_dtype == "int8" or n_volumes < 4 or len(copy_s) < 4:
        return None
    med = sorted(copy_s)[len(copy_s) // 2]
    cadence = wall_s / max(n_volumes, 1)
    if cadence <= 0 or med < 0.5 * cadence:
        return None
    return (
        f"note: the host->device copy dominates serving (median "
        f"{med * 1e3:.0f} ms/volume ≈ {100 * med / cadence:.0f}% of the "
        f"{cadence * 1e3:.0f} ms pipeline cadence); --transfer-dtype int8 "
        f"halves its bytes (lossy: the masks may differ from the bf16 path's; "
        f"and its host quantizer costs more than the bf16 cast)"
    )


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
    flat export dicts or ``params.npz`` paths (``utils/weights.py``). The
    fine network is the one ``exp.unet``'s class names (``build_network``:
    the U-Net, or the Swin UNETR of ``configs/swin_unetr.py``); the coarse
    net is a U-Net."""

    def __init__(
        self,
        exp: ExperimentConfig,
        params_fine,
        params_coarse=None,
        device: Union[str, torch.device] = "cuda",
        devices=None,
    ):
        self.exp = exp
        if exp.infer.transfer_dtype not in ("bfloat16", "int8"):
            raise ValueError(
                f"transfer_dtype must be 'bfloat16' or 'int8', got "
                f"{exp.infer.transfer_dtype!r}"
            )
        self.device = resolve_device(device)
        self.canvas = tuple(exp.infer.canvas or exp.train.pool_shape)
        self.fine = build_network(exp.unet, params_fine, self.device)
        self.coarse = None
        if (exp.infer.cascade and exp.coarse_unet is not None
                and params_coarse is not None):
            self.coarse = build_network(exp.coarse_unet, params_coarse, self.device)
        self.program = make_predict_fn(
            self.fine, exp.infer, self.canvas,
            num_classes=exp.unet.num_classes, coarse=self.coarse,
        )
        # bounded in-memory payload memo (InferenceConfig.payload_memo_volumes)
        self._payload_memo: collections.OrderedDict = collections.OrderedDict()
        self._memo_lock = threading.Lock()
        # serving telemetry: each volume's host-to-device copy alone, for
        # the transfer-bound advisory (printed once per predictor)
        self._copy_times: list = []
        self._transfer_hinted = False
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # the striping lanes of the multi-case paths: lane 0 is this
        # device's program, lane j > 0 a copy on devices[j], built at its
        # first case (_lane)
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if self.device.type == "cuda" and self.device.index is None
                       else [self.device])
        self.devices = [torch.device(d) for d in devices] or [self.device]
        self._lanes: dict = {}
        self._lane_lock = threading.Lock()

    def _lane(self, j: int):
        """(device, program, copy stream) of striping lane ``j``."""
        if j == 0:
            return self.device, self.program, self._copy_stream
        with self._lane_lock:
            if j not in self._lanes:
                dev = self.devices[j]
                copy = lambda m, cfg: None if m is None else build_network(
                    cfg, {"params/" + k.replace(".", "/"): v.detach().cpu().numpy()
                          for k, v in m.state_dict().items()}, dev)
                program = make_predict_fn(
                    copy(self.fine, self.exp.unet), self.exp.infer, self.canvas,
                    num_classes=self.exp.unet.num_classes,
                    coarse=copy(self.coarse, self.exp.coarse_unet))
                stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
                self._lanes[j] = (dev, program, stream)
            return self._lanes[j]

    def _lane_of(self, i: int, pair=None) -> int:
        """The lane of the i-th case of a batch: round-robin over devices,
        by pairs when pairing (a pair shares a lane; reference :365)."""
        return (i // 2 if pair is not None else i) % len(self.devices)

    def _program_on(self, lane: int):
        """(program, device context) of striping lane ``lane``."""
        dev, program, _ = self._lane(lane)
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        return program, ctx

    @property
    def _pairs(self) -> bool:
        """Pairing applies: it is configured and the program is the split
        cascade (the one with a paired stage)."""
        return (self.exp.infer.batch_volumes >= 2
                and hasattr(self.program, "stage_finish_pair"))

    # ---------------------------------------------------------------- weights --

    def warmup(self, probs: bool = False, stage: str = "all") -> float:
        """Run the serving device programs once on a zero canvas and fetch
        their outputs, so the first real case pays no first-use cost
        (``serve --warmup``, :215): on a card that is the nvcc build of the
        CUDA kernels, Triton's compiles, cuDNN/cuBLAS handles and the
        allocator's first blocks. ``stage="primary"`` warms the label
        program, the one program the first queued case needs; ``"rest"`` the
        other arms: with pairing the paired stage and the odd tail's
        ``stage_finish`` (:250-259), and the probability program when
        ``probs`` (the daemon emits probability or uncertainty artifacts);
        ``"all"`` both. Returns wall seconds."""
        if stage not in ("all", "primary", "rest"):
            raise ValueError(f"warmup stage {stage!r}")
        t0 = time.time()
        x = torch.zeros(self.canvas + (NUM_MODALITIES,),
                        dtype=torch.bfloat16, device=self.device)
        outs = []
        if stage in ("all", "primary"):
            outs.append(self.predict_device(x))
        if stage in ("all", "rest"):
            if self._pairs:
                with torch.inference_mode():
                    tiles, start = self.program.stage_roi(x)
                    outs.append(self.program.stage_finish_pair(
                        tiles, tiles, start, start))
                    outs.append(self.program.stage_finish(tiles, start))
            if probs:
                outs.append(self.probs_device(x))
        for out in outs:
            _, event = _start_host_copy(*out)
            if event is not None:
                event.synchronize()
        return time.time() - t0

    def reload_params(self, params_fine, params_coarse=None) -> None:
        """Swap the serving weights in place (``serve``'s SIGHUP hot reload,
        :263). The new params must match the current nets' structure (strict
        load); the conv kernels' compute-dtype copies and Winograd transforms
        follow the version counters, so the next volume uses the new
        weights."""
        if params_coarse is None and self.coarse is not None:
            raise ValueError(
                "reload_params: the cascade is active; pass params_coarse too "
                "(or retire the coarse stage by rebuilding the Predictor)"
            )
        for model, params in ((self.fine, params_fine),
                              (self.coarse, params_coarse)):
            if model is None or params is None:
                continue
            flat = load_params(params) if isinstance(params, str) else params
            model.load_state_dict(state_dict_from_flat(flat), strict=True)
        with self._lane_lock:
            self._lanes.clear()     # the other cards' copies: rebuilt from these

    # ------------------------------------------------------------- host side --

    def _encode_host(
        self, image: np.ndarray, meta: Optional[dict] = None
    ) -> Tuple[torch.Tensor, Optional[Tuple[int, int, int]], BBox]:
        """Brain bbox -> (bucketed) crop + bf16 cast, or an f32 crop
        quantized to int8 per modality (``transfer_dtype="int8"``): the
        bytes that cross to the device. ``dst is None`` means ``small`` is
        the whole canvas in bf16; the int8 whole canvas has ``dst`` (0, 0, 0),
        as the reference's (:468-474). Deterministic for a fixed (input,
        canvas, bucket, transfer dtype), which is what makes the payload
        cacheable. ``meta`` (the native decoder's, from ``Case.meta``) gives
        the brain bbox the decoder fused into its decode (:440-452); without
        it the strided exact scan finds it."""
        if meta is not None:
            bbox = BBox(tuple(int(v) for v in meta["bbox_lo"]),
                        tuple(int(v) for v in meta["bbox_hi"]),
                        image.shape[:3])
        else:
            bbox = brain_bbox_fast_np(image)
        bucket = self.exp.infer.transfer_bucket
        int8 = self.exp.infer.transfer_dtype == "int8"
        # int8 quantizes from f32, so the bucketed and whole-canvas payloads
        # are bitwise equal (same nonzero set, same per-modality scale)
        dtype = torch.float32 if int8 else torch.bfloat16
        if bucket:
            small, dst = crop_cast_bucket_np(image, bbox, self.canvas, bucket,
                                             dtype=dtype)
        else:
            small = crop_cast_fit_np(image, bbox, self.canvas, dtype=dtype)
            dst = (0, 0, 0) if int8 else None
        if int8:
            small = torch.from_numpy(quantize_int8_per_modality(small.numpy()))
        return small, dst, bbox

    def _memo_encode(self, image: np.ndarray, meta: Optional[dict] = None):
        """``_encode_host`` through the bounded in-memory payload memo, keyed
        by array identity (:487): a volume submitted again skips the bbox
        scan and the crop/cast; the transfer still happens per dispatch.
        Entries hold a weak reference to the keyed array, so a stream of
        distinct volumes pins nothing: a dead entry is swept on the next
        call, and the liveness check makes a recycled ``id()`` read as a
        miss. Submitted arrays must not be mutated in place afterwards. The
        bbox source is part of the key (:509-516): the same array submitted
        with and without the decoder's meta never shares an entry."""
        encode = (lambda: self._encode_host(image)) if meta is None else (
            lambda: self._encode_host(image, meta))
        cap = self.exp.infer.payload_memo_volumes
        if cap <= 0:
            return encode()
        key = id(image) if meta is None else (
            id(image), tuple(int(v) for v in meta["bbox_lo"]),
            tuple(int(v) for v in meta["bbox_hi"]))
        with self._memo_lock:
            for k in [k for k, e in self._payload_memo.items() if e[0]() is None]:
                del self._payload_memo[k]
            ent = self._payload_memo.get(key)
            if ent is not None and ent[0]() is image:
                self._payload_memo.move_to_end(key)
                return ent[1]
        payload = encode()
        try:
            ref = weakref.ref(image)
        except TypeError:
            return payload  # an input that takes no weak reference: uncached
        with self._memo_lock:
            self._payload_memo[key] = (ref, payload)
            self._payload_memo.move_to_end(key)
            while len(self._payload_memo) > cap:
                self._payload_memo.popitem(last=False)
        return payload

    def _payload_to_device(self, small: torch.Tensor,
                           dst: Optional[Tuple[int, int, int]], lane: int = 0):
        """Copy the payload to the lane's device and embed it into the zero
        canvas (:477). On a card the copy leaves pinned memory on the copy
        stream and the embed follows it there; the returned event marks the
        canvas ready, and the thread that launches the device program waits
        on it (``_await_canvas``). Returns (canvas, event or None).
        The copy alone is timed for the transfer advisory: on a card by
        CUDA events around it, on the CPU (no link) by the host clock around
        the embed."""
        dev, _, stream = self._lane(lane)
        if dev.type != "cuda":
            t0 = time.perf_counter()
            canvas = self._embed(small, dst, dev)
            self._note_copy(time.perf_counter() - t0)
            return canvas, None
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            pinned = small.pin_memory()
            timed = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            timed[0].record()
            moved = pinned.to(dev, non_blocking=True)
            timed[1].record()
            canvas = self._embed(moved, dst, dev)
            event = torch.cuda.Event()
            event.record()
        self._note_copy(timed)
        return canvas, event

    def _embed(self, small: torch.Tensor,
               dst: Optional[Tuple[int, int, int]], dev=None) -> torch.Tensor:
        """The payload on ``dev`` cast to bf16 (the int8 encoding
        dequantizes by cast alone: the program's per-modality z-score is
        scale-invariant; :196-213), placed at ``dst`` in a zero canvas."""
        dev = self.device if dev is None else dev
        small = small.to(dev).to(torch.bfloat16)
        if dst is None:
            return small
        canvas = torch.zeros(self.canvas + tuple(small.shape[3:]),
                             dtype=small.dtype, device=dev)
        x, y, z = dst
        sx, sy, sz = small.shape[:3]
        canvas[x:x + sx, y:y + sy, z:z + sz] = small
        return canvas

    def _await_canvas(self, canvas: torch.Tensor, event) -> torch.Tensor:
        """Make the current stream wait for a canvas made on the copy stream."""
        if event is not None:
            stream = torch.cuda.current_stream(canvas.device)
            stream.wait_event(event)
            canvas.record_stream(stream)
        return canvas

    def _prep_to(self, image: np.ndarray, meta: Optional[dict] = None,
                 lane: int = 0):
        """Host encode (memoized) + transfer to the lane's device: ((canvas,
        event), cropped shape, bbox). Runs in a prep thread on the serving
        path."""
        with profile.span("prep.encode"):
            small, dst, bbox = self._memo_encode(image, meta)
        with profile.span("prep.copy"):
            moved = self._payload_to_device(small, dst, lane)
        return moved, bbox.shape, bbox

    def _note_copy(self, timing) -> None:
        """Record one volume's host-to-device copy: seconds, or a started
        pair of CUDA events read when the advisory needs them (prep threads
        append; the list keeps the last 64)."""
        self._copy_times.append(timing)
        del self._copy_times[:-64]

    def _copy_seconds(self, n: int) -> list:
        """The last ``n`` copies' seconds (waits for their events)."""
        out = []
        for t in self._copy_times[-n:]:
            if isinstance(t, list):
                t[1].synchronize()
                t = t[0].elapsed_time(t[1]) / 1e3
            out.append(t)
        return out

    def _maybe_transfer_hint(self, n: int, wall_s: float) -> None:
        """Print the transfer-bound advisory at most once per predictor
        (reference :397-406)."""
        if self._transfer_hinted:
            return
        hint = transfer_bound_hint(self._copy_seconds(n), wall_s, n,
                                   self.exp.infer.transfer_dtype)
        if hint:
            self._transfer_hinted = True
            print(hint, file=sys.stderr)

    def prepare(self, image: np.ndarray, meta: Optional[dict] = None):
        """Host encode + copy to the device, ready on the current stream:
        (canvas on the device, cropped shape, bbox)."""
        (canvas, event), shape, bbox = self._prep_to(image, meta)
        return self._await_canvas(canvas, event), shape, bbox

    def _cache_path(self, case_dir: str) -> Optional[str]:
        cache_dir = self.exp.infer.prep_cache_dir
        if not cache_dir:
            return None
        return payload_cache_path(
            cache_dir, case_dir, self.canvas, self.exp.infer.transfer_bucket,
            self.exp.infer.transfer_dtype,
        )

    def _prep_dir_to(self, case_dir: str, lane: int = 0):
        """Case-directory prep through the on-disk payload cache (:551): a
        hit loads the stored payload and reads only the t1 header (for the
        output's affine); a miss decodes, encodes and stores. The stored
        payload is bitwise what the uncached path ships. Returns
        ``(case_name, header, (canvas, event), cropped_shape, bbox)``."""
        path = self._cache_path(case_dir)
        with profile.span("prep.decode"):
            payload = load_payload(path) if path is not None else None
            if payload is not None:
                name = os.path.basename(os.path.normpath(case_dir))
                header = read_header(modality_paths(case_dir)[0])
            else:
                case = load_case(case_dir)
                name, header = case.name, case.header
        if payload is not None:
            small, dst, bbox = payload
        else:
            with profile.span("prep.encode"):
                small, dst, bbox = self._encode_host(case.image, case.meta)
                if path is not None:
                    store_payload(path, small, dst, bbox)
        with profile.span("prep.copy"):
            moved = self._payload_to_device(small, dst, lane)
        return name, header, moved, bbox.shape, bbox

    def prefill_payload_cache(self, case_dir: str) -> bool:
        """Decode + encode one case into the on-disk payload cache without
        touching the device (:596): the serve daemon's watch loop calls this
        from a background thread for arrivals queued behind the current
        batch. True when it wrote a new entry (False: cache off, or warm)."""
        path = self._cache_path(case_dir)
        # the filename embeds the input signature, so a listed entry is warm
        if path is None or os.path.exists(path):
            return False
        case = load_case(case_dir)
        small, dst, bbox = self._encode_host(case.image, case.meta)
        store_payload(path, small, dst, bbox)
        return True

    def _paste_roi(self, labels_r: np.ndarray, start: np.ndarray) -> np.ndarray:
        """Place the ROI labels into a zero canvas."""
        if labels_r.shape == self.canvas:
            return labels_r
        out = np.zeros(self.canvas, dtype=labels_r.dtype)
        sx, sy, sz = (int(v) for v in start)
        rx, ry, rz = labels_r.shape
        out[sx:sx + rx, sy:sy + ry, sz:sz + rz] = labels_r
        return out

    def _finish(self, fetched, cropped_shape, bbox: BBox) -> np.ndarray:
        """Fetch + paste + un-crop + host postprocessing (skipped when the
        device program already did it): the one tail of every path (:329).
        ``fetched`` is ``_start_host_copy``'s return."""
        (labels_r, start), event = fetched
        with profile.span("post.fetch"):
            if event is not None:
                event.synchronize()
            labels_r, start = labels_r.cpu().numpy(), start.cpu().numpy()
        with profile.span("post.finish"):
            labels_c = self._paste_roi(labels_r, start)
            labels = uncrop_from_canvas_np(labels_c, cropped_shape, bbox,
                                           self.canvas)
            if self.exp.infer.postproc == "device":
                return labels
            return postprocess_labels(
                labels,
                min_component_voxels=self.exp.infer.min_component_voxels,
                et_min_voxels=self.exp.infer.et_min_voxels,
            )

    def _finish_and_write(self, fetched, name, header, shape, bbox, case_dir,
                          out) -> str:
        labels = self._finish(fetched, shape, bbox)
        if out is None:
            out = os.path.join(case_dir, f"{name}_pred.nii.gz")
        with profile.span("post.write"):
            write_nifti(out, internal_to_disk(labels).astype(np.uint8),
                        like=header)
        return out

    # ------------------------------------------------------------ entry points --

    @profile.entry
    def predict_device(self, canvas_img: torch.Tensor, lane: int = 0, req=None):
        """Lane ``lane``'s device program on an embedded canvas:
        (labels_roi, start). ``req``: the volume's request id."""
        program, ctx = self._program_on(lane)
        with ctx, torch.inference_mode(), profile.span(
                "predict.program", req, device_edges=True):
            return program(canvas_img)

    def probs_device(self, canvas_img: torch.Tensor):
        """The probability program on an embedded canvas: (probs_roi f32,
        start)."""
        with torch.inference_mode():
            return self.program.probs(canvas_img)

    def _dispatch(self, prepped, lane: int = 0, req=None):
        """Wait for a prepared canvas, launch the lane's device program on it
        and start the readback. Called from one thread only."""
        _, ctx = self._program_on(lane)
        with ctx:
            canvas = self._await_canvas(*prepped)
            return _start_host_copy(*self.predict_device(canvas, lane, req))

    @profile.entry
    def predict_arrays(
        self, image: np.ndarray, meta: Optional[dict] = None
    ) -> Tuple[np.ndarray, PredictionStats]:
        """image: raw (X, Y, Z, 4) float32 -> internal labels (X, Y, Z) uint8;
        ``meta``: the native decoder's (its fused bbox), when it read it."""
        req = (profile.call_number(), 0)
        with profile.span("predict.call", req):
            t0 = time.time()
            with profile.span("predict.prep"):
                prepped, cropped_shape, bbox = self._prep_to(image, meta)
            t1 = time.time()
            fetched = self._dispatch(prepped, req=req)
            if fetched[1] is not None:
                fetched[1].synchronize()
            t2 = time.time()
            with profile.span("predict.post"):
                labels = self._finish(fetched, cropped_shape, bbox)
        return labels, PredictionStats(t1 - t0, t2 - t1, time.time() - t2)

    def _pipelined(self, n: int, prep, finish) -> list:
        """The serving pipeline over ``n`` cases (:344): prep threads run
        ``prep(i, lane) -> (prepped, job)``, this thread launches the device
        programs in order (paired when ``batch_volumes`` is 2), post threads
        run ``finish(i, fetched, job)``. Returns the finishes' results in
        order."""
        depth = max(1, self.exp.infer.serving_depth)
        pair = _PairDispatcher(self) if self._pairs else None
        call = profile.call_number()

        def prep_one(i, lane):
            with profile.span("predict.prep", (call, i)):
                return prep(i, lane)

        def post_one(i, fetched, job):
            with profile.span("predict.post", (call, i)):
                return finish(i, fetched, job)

        t_wall = time.time()
        with profile.span("predict.call", (call, None)), \
                ThreadPoolExecutor(depth) as prep_pool, \
                ThreadPoolExecutor(depth) as post_pool:
            preps = [prep_pool.submit(profile.carry(prep_one), i,
                                      self._lane_of(i, pair))
                     for i in range(n)]
            posts: dict = {}
            for i, fut in enumerate(preps):
                req = (call, i)
                with profile.span("predict.await_prep", req, device_edges=True):
                    prepped, job = fut.result()

                def emit(fetched, i=i, job=job):
                    posts[i] = post_pool.submit(profile.carry(post_one), i,
                                                fetched, job)

                lane = self._lane_of(i, pair)
                if pair is None:
                    emit(self._dispatch(prepped, lane, req))
                else:
                    pair.dispatch(prepped, lane, emit, req)
            if pair is not None:
                pair.flush()
            with profile.span("predict.await_post", (call, None),
                              device_edges=True):
                results = [posts[i].result() for i in range(n)]
        self._maybe_transfer_hint(n, time.time() - t_wall)
        return results

    @profile.entry
    def predict_arrays_many(self, images) -> list:
        """Pipelined batch prediction (:344): prep threads encode and
        transfer, this thread launches the device programs in order (paired
        when ``batch_volumes`` is 2), post threads fetch and postprocess.
        Returns the label volumes in order."""

        def prep(i, lane):
            moved, shape, bbox = self._prep_to(images[i], None, lane)
            return moved, (shape, bbox)

        return self._pipelined(len(images), prep,
                               lambda i, fetched, job: self._finish(fetched, *job))

    def predict_case(self, case) -> Tuple[np.ndarray, PredictionStats]:
        """``predict_arrays`` on a loaded case, with its decoder meta
        (``evaluate`` calls this; :698)."""
        return self.predict_arrays(case.image, meta=case.meta)

    # -------------------------------------------------------- probabilities --

    def predict_probs_arrays(
        self, image: np.ndarray, meta: Optional[dict] = None
    ) -> Tuple[np.ndarray, PredictionStats]:
        """Mean class probabilities for the whole volume (X, Y, Z, C) f32
        (:628): the same TTA-averaged canvas the labels are argmaxed from.
        Voxels outside the predicted ROI or the brain bbox get exact
        background one-hot."""
        t0 = time.time()
        canvas, shape, bbox = self.prepare(image, meta)
        t1 = time.time()
        probs, dev_s, post_s = self._probs_from_prepped(canvas, shape, bbox)
        return probs, PredictionStats(t1 - t0, dev_s, post_s)

    def _probs_from_prepped(self, canvas_img, cropped_shape, bbox):
        """The probability program + host un-crop for a prepared canvas
        (:645): (probs, device s, post s)."""
        t1 = time.time()
        canvas_p = self._probs_canvas_np(canvas_img)
        t2 = time.time()
        probs = uncrop_from_canvas_np(canvas_p, cropped_shape, bbox, self.canvas)
        return background_fill(probs), t2 - t1, time.time() - t2

    def _probs_canvas_np(self, canvas_img: torch.Tensor) -> np.ndarray:
        """Run the probability program and paste its ROI at its start into
        a zero host f32 canvas (:658)."""
        (probs_r, start), event = _start_host_copy(*self.probs_device(canvas_img))
        if event is not None:
            event.synchronize()
        probs_r = probs_r.numpy()
        if probs_r.shape[:3] == self.canvas:
            return probs_r
        canvas_p = np.zeros(self.canvas + (probs_r.shape[-1],), np.float32)
        sx, sy, sz = (int(v) for v in start)
        rx, ry, rz = probs_r.shape[:3]
        canvas_p[sx:sx + rx, sy:sy + ry, sz:sz + rz] = probs_r
        return canvas_p

    def probs_for_dir(self, case_dir: str):
        """The probability pass for one case directory through the payload
        cache (``--prep-cache``), as the label pass decodes (:674). Returns
        ``(name, header, probs)``."""
        name, header, prepped, shape, bbox = self._prep_dir_to(case_dir)
        canvas = self._await_canvas(*prepped)
        probs, _, _ = self._probs_from_prepped(canvas, shape, bbox)
        return name, header, probs

    def predict_probs_dir(self, case_dir: str,
                          output_path: Optional[str] = None) -> str:
        """Write a case's probability canvas as ``<case>_probs.npz``
        (float16 ``probs`` (X, Y, Z, 4) + ``classes`` naming the channel
        order in BraTS disk labels [0, 1, 2, 4]) (:686)."""
        name, _header, probs = self.probs_for_dir(case_dir)
        if output_path is None:
            output_path = os.path.join(case_dir, f"{name}_probs.npz")
        return save_probs_npz(output_path, probs)

    # ----------------------------------------------------------- many cases --

    @profile.entry
    def predict_dirs(self, case_dirs, output_paths=None) -> list:
        """Pipelined multi-case path (:700), the one ``serve`` and the
        multi-case CLI use: decode (or payload-cache hit), the device
        program, and postprocess + NIfTI write overlap. ``output_paths[i]``
        overrides where case i's prediction goes (default
        ``<case_dir>/<case>_pred.nii.gz``). Returns the output paths; serve
        and the multi-case predict CLI come through here, so the transfer
        advisory fires here too."""
        if output_paths is None:
            output_paths = [None] * len(case_dirs)

        def prep(i, lane):
            name, header, moved, shape, bbox = self._prep_dir_to(case_dirs[i], lane)
            return moved, (name, header, shape, bbox)

        def finish(i, fetched, job):
            return self._finish_and_write(fetched, *job, case_dirs[i],
                                          output_paths[i])

        return self._pipelined(len(case_dirs), prep, finish)

    @profile.entry
    def predict_dir(
        self, case_dir: str, output_path: Optional[str] = None
    ) -> Tuple[str, PredictionStats]:
        """Predict one BraTS case directory and write ``<case>_pred.nii.gz``
        (BraTS disk labels, input header) next to it or at output_path."""
        req = (profile.call_number(), 0)
        with profile.span("predict.call", req):
            t0 = time.time()
            with profile.span("predict.prep"):
                name, header, prepped, shape, bbox = self._prep_dir_to(case_dir)
            t1 = time.time()
            fetched = self._dispatch(prepped, req=req)
            if fetched[1] is not None:
                fetched[1].synchronize()
            t2 = time.time()
            with profile.span("predict.post"):
                out = self._finish_and_write(fetched, name, header, shape, bbox,
                                             case_dir, output_path)
        return out, PredictionStats(t1 - t0, t2 - t1, time.time() - t2)
