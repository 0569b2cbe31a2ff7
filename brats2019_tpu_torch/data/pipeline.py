"""Host -> device input pipeline: the device-resident case pool (reference:
``brats2019_tpu/data/pipeline.py``).

Whole preprocessed cases live on the device as a fixed-size pool; patch
sampling and augmentation run on the device inside the train step. The
host's only steady-state job is preparing the next case in a background
thread; :meth:`CasePool.maybe_refresh` swaps one slot when a prepared case
is ready and never waits for one.

Layout (one device):
  image : (K, X, Y, Z, 4)  bfloat16, z-scored, bbox-cropped to the canvas
  seg   : (K, X, Y, Z)     uint8 internal labels
  fg_host : (K, T, 3)      int32 foreground-voxel table for biased sampling,
                           kept on the host: the origins are drawn there, so
                           drawing one needs no device read

The case cursor (epoch, index) is part of the training checkpoint.

Data parallelism (:246-292): each shard of a mesh has its own pool on its
device, filled from its own cursor over the one shuffled order, striding by
the number of shards from its global index (``stride``, ``offset``), so the
shards hold disjoint cases and the process layout does not change which case
a shard sees. One shard: stride 1, offset 0, the one-device pool.

The prep cache (``prep_cache_dir``, :105-183): an uncompressed npz per
(case, canvas, downsample, input-file signature) holding the prepared
canvas, so a pool that revisits a case skips the NIfTI decode, z-score and
bbox scan. File names and fields are the JAX package's, so one cache
directory serves both packages.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import sys
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .case import Case, load_case, modality_paths, seg_path
from .preprocess import brain_bbox_fast_np, center_fit_axis, crop_np, zscore_np
from .sampling import FG_TABLE_SIZE, build_fg_table_np

# bump when prepare_training_case's output semantics change — stale cache
# entries (older version, different canvas/downsample, touched inputs) are
# never read because the version + prep params + input file signature are
# all part of the cache filename
PREP_CACHE_VERSION = 1


def fit_to_canvas(vol: np.ndarray, canvas: Tuple[int, int, int], fill=0) -> np.ndarray:
    """Center-pad (or center-crop) spatial dims to exactly ``canvas``."""
    out_shape = tuple(canvas) + vol.shape[3:]
    out = np.full(out_shape, fill, dtype=vol.dtype)
    src_sl, dst_sl = [], []
    for ax in range(3):
        start, n, dst = center_fit_axis(vol.shape[ax], canvas[ax])
        src_sl.append(slice(start, start + n))
        dst_sl.append(dst)
    out[tuple(dst_sl)] = vol[tuple(src_sl)]
    return out


def prepare_training_case(
    case: Case,
    canvas: Tuple[int, int, int],
    downsample: int = 1,
) -> Dict[str, object]:
    """z-score -> bbox crop -> (coarse view) -> canvas fit -> fg table.

    ``downsample`` > 1 gives the coarse stage's view: the cropped volume is
    box-averaged (image) and stride-subsampled (labels) by that factor
    before canvas fitting. The image comes back as a bf16 CPU tensor
    (round to nearest even, bitwise the reference's ml_dtypes cast).
    """
    img = zscore_np(case.image)
    seg = case.seg if case.seg is not None else np.zeros(img.shape[:3], np.uint8)
    bbox = brain_bbox_fast_np(img)
    img = crop_np(img, bbox)
    seg = crop_np(seg, bbox)
    if downsample > 1:
        d = downsample
        trim = tuple((s // d) * d for s in img.shape[:3])
        img = img[: trim[0], : trim[1], : trim[2]]
        seg = seg[: trim[0], : trim[1], : trim[2]]
        img = img.reshape(
            trim[0] // d, d, trim[1] // d, d, trim[2] // d, d, -1
        ).mean(axis=(1, 3, 5))
        seg = seg[d // 2 :: d, d // 2 :: d, d // 2 :: d]
    img = fit_to_canvas(img.astype(np.float32), canvas)
    seg = fit_to_canvas(seg.astype(np.uint8), canvas)
    return {
        "image": torch.from_numpy(img).to(torch.bfloat16),
        "seg": seg,
        "fg": build_fg_table_np(seg, FG_TABLE_SIZE),
    }


def _case_signature_hash(case_dir: str, with_seg: bool = True) -> str:
    """sha1 of the (mtime_ns, size) signature of every input file — editing
    or re-uploading a case invalidates any cache entry keyed on this.
    st_mtime_ns, not whole seconds: a case rewritten within the same second
    with unchanged sizes must still invalidate its entry."""
    import hashlib

    paths = list(modality_paths(case_dir))
    if with_seg:
        sp = seg_path(case_dir)
        if sp:
            paths.append(sp)
    sig = "|".join(
        f"{os.path.basename(p)}:{os.stat(p).st_mtime_ns}:{os.path.getsize(p)}"
        for p in paths
    )
    return hashlib.sha1(sig.encode()).hexdigest()[:16]


def _prep_cache_path(
    cache_dir: str, case_dir: str, canvas, downsample: int
) -> str:
    """Cache filename keyed by everything that determines the prep output:
    version, canvas, downsample, and the input-file signature hash."""
    h = _case_signature_hash(case_dir)
    base = os.path.basename(os.path.normpath(case_dir))
    c = "x".join(map(str, canvas))
    return os.path.join(
        cache_dir,
        f"{base}.v{PREP_CACHE_VERSION}.c{c}.d{downsample}.{h}.npz",
    )


def cached_prepare_training_case(
    case_dir: str, canvas, downsample: int = 1,
    cache_dir: Optional[str] = None,
) -> Dict[str, object]:
    """prepare_training_case with an optional on-disk cache of the prepped
    arrays (z-scored bf16 canvas + labels + fg table), as the JAX package's
    (:126-183): an entry is an uncompressed npz (the bf16 image as its
    uint16 bit pattern, ``seg``, ``fg``), written to a temporary name and
    renamed, and older entries of the same case and prep params are pruned;
    a corrupt entry is rebuilt."""
    if not cache_dir:
        return prepare_training_case(
            load_case(case_dir, load_seg=True), canvas, downsample=downsample
        )
    path = _prep_cache_path(cache_dir, case_dir, canvas, downsample)
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                return {
                    "image": torch.from_numpy(z["image_u16"].view(np.int16)
                                              ).view(torch.bfloat16),
                    "seg": z["seg"],
                    "fg": z["fg"],
                }
        except Exception as e:  # noqa: BLE001 — corrupt entry: rebuild
            print(f"[pool] discarding corrupt cache entry {path}: {e}",
                  file=sys.stderr, flush=True)
    out = prepare_training_case(
        load_case(case_dir, load_seg=True), canvas, downsample=downsample
    )
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        # savez gets a file object so it cannot append its own .npz suffix
        with open(tmp, "wb") as f:
            np.savez(f, image_u16=out["image"].view(torch.int16).numpy()
                     .view(np.uint16), seg=out["seg"], fg=out["fg"])
        os.replace(tmp, path)
        # prune superseded entries for the same case + prep params (older
        # input signature or older PREP_CACHE_VERSION); file name =
        # base.vN.cC.dD.hash.npz: match on (base, cC, dD)
        def _entry_key(fn: str):
            parts = fn.rsplit(".", 5)
            return (parts[0], parts[2], parts[3]) if len(parts) == 6 else None

        mine = os.path.basename(path)
        key = _entry_key(mine)
        for fn in os.listdir(cache_dir):
            if fn.endswith(".npz") and fn != mine and _entry_key(fn) == key:
                try:
                    os.remove(os.path.join(cache_dir, fn))
                except OSError:
                    pass
    except OSError as e:
        print(f"[pool] prep-cache write failed ({e}); continuing uncached",
              file=sys.stderr, flush=True)
        try:
            os.remove(tmp)
        except OSError:
            pass
    return out


@dataclasses.dataclass
class CaseCursor:
    """Deterministic shuffled traversal of the case list; checkpointable.
    Epoch e visits ``default_rng(seed + e * 1_000_003).permutation(n)``;
    ``stride``/``offset`` walk an interleaved subsequence of it."""

    n_cases: int
    seed: int = 0
    epoch: int = 0
    index: int = 0
    stride: int = 1
    offset: int = 0

    def _order(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self.epoch * 1_000_003)
        return rng.permutation(self.n_cases)

    def _positions_per_epoch(self) -> int:
        if self.offset >= self.n_cases:
            return 1
        return (self.n_cases - 1 - self.offset) // self.stride + 1

    def next_index(self) -> int:
        order = self._order()
        pos = self.offset + self.index * self.stride
        i = int(order[pos % self.n_cases])
        self.index += 1
        if self.index >= self._positions_per_epoch():
            self.index = 0
            self.epoch += 1
        return i

    def state(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "index": self.index, "seed": self.seed}

    def load_state(self, s: Dict[str, int]) -> None:
        self.epoch, self.index, self.seed = s["epoch"], s["index"], s["seed"]


class CasePool:
    """Device-resident pool of ``cases`` prepared cases with a background
    host refresh, read through the prep cache when ``prep_cache_dir`` is
    set; ``stride``/``offset``: a data-parallel shard's interleaved share of
    the traversal."""

    def __init__(
        self,
        case_dirs: Sequence[str],
        device: torch.device,
        canvas: Tuple[int, int, int],
        cases: int,
        downsample: int = 1,
        seed: int = 0,
        prefetch: int = 2,
        prep_cache_dir: Optional[str] = None,
        stride: int = 1,
        offset: int = 0,
    ):
        if not case_dirs:
            raise ValueError("CasePool needs at least one case")
        self.case_dirs = list(case_dirs)
        self.device = torch.device(device)
        self.canvas = tuple(canvas)
        self.downsample = downsample
        self.prep_cache_dir = prep_cache_dir
        self.k = cases
        self.cursor = CaseCursor(len(self.case_dirs), seed=seed,
                                 stride=stride, offset=offset)
        self._queue: "queue.Queue[Dict[str, object]]" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._slot = 0
        self._warned: set = set()
        first = [self._load_next() for _ in range(self.k)]
        self.image = torch.stack([c["image"] for c in first]).to(self.device)
        self.seg = torch.from_numpy(np.stack([c["seg"] for c in first])).to(self.device)
        self.fg_host = np.stack([c["fg"] for c in first])

    def _prepare(self, d: str) -> Dict[str, object]:
        return cached_prepare_training_case(d, self.canvas,
                                            downsample=self.downsample,
                                            cache_dir=self.prep_cache_dir)

    def _load_next(self) -> Dict[str, object]:
        return self._prepare(self.case_dirs[self.cursor.next_index()])

    # -- background refresh ------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=10)
            self._thread = None

    def _worker(self) -> None:
        """Prepare cases ahead. An unreadable case is reported once and
        skipped with a back-off; a whole failing pass stops the worker
        (training continues on the current pool)."""
        consecutive = 0
        while not self._stop.is_set():
            d = self.case_dirs[self.cursor.next_index()]
            try:
                c = self._prepare(d)
                consecutive = 0
            except Exception as e:  # noqa: BLE001 — report + skip below
                consecutive += 1
                if d not in self._warned:
                    self._warned.add(d)
                    print(f"[pool] refresh skipping unreadable case {d}: "
                          f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
                if consecutive >= max(len(self.case_dirs), 4):
                    print("[pool] every case failed to load; stopping the "
                          "refresh worker (training continues on the current "
                          "device pool)", file=sys.stderr, flush=True)
                    return
                self._stop.wait(0.5)
                continue
            while not self._stop.is_set():
                try:
                    self._queue.put(c, timeout=0.5)
                    break
                except queue.Full:
                    pass

    def maybe_refresh(self) -> bool:
        """Swap one pool slot (round robin) with a prepared case, if one is
        ready; never waits."""
        try:
            c = self._queue.get_nowait()
        except queue.Empty:
            return False
        slot = self._slot % self.k
        self._slot += 1
        self.image[slot].copy_(c["image"], non_blocking=True)
        self.seg[slot].copy_(torch.from_numpy(c["seg"]), non_blocking=True)
        self.fg_host[slot] = c["fg"]
        return True

    def state(self) -> Dict[str, int]:
        return self.cursor.state()

    def load_state(self, s) -> None:
        self.cursor.load_state(s)
