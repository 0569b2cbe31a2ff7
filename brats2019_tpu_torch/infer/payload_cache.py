"""On-disk transfer-payload cache for the serving/predict path (reference:
``brats2019_tpu/infer/payload_cache.py``).

Caches the post-bbox *transfer payload*, the exact bytes
``Predictor._encode_host`` ships to the device (the bucketed brain crop in
bf16 or int8, its canvas offset, and the brain bbox), keyed by the case's
input-file signature and every prep parameter that determines the encoding
(the transfer dtype among them, so bf16 and int8 entries never collide). A
hit skips gzip inflate, the brain-bbox scan and crop/cast/quantize; the
payload is bitwise what the uncached path ships, so the masks are identical.

File names, the signature hash and the npz fields (bf16 stored as its uint16
bit pattern, int8 as it is) are the reference's, so a cache directory written
by one package reads in the other. Entries are written atomically (tmp +
rename: serve shards may share a cache dir), corrupt entries are discarded
and rebuilt, and superseded entries of the same case and parameters are
pruned.
"""

from __future__ import annotations

import hashlib
import os
import sys
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.pipeline import _case_signature_hash
from ..data.preprocess import BBox

# bump when the payload semantics change (the version is part of the filename)
PAYLOAD_CACHE_VERSION = 1

Payload = Tuple[torch.Tensor, Optional[Tuple[int, int, int]], BBox]


def payload_cache_path(
    cache_dir: str,
    case_dir: str,
    canvas: Tuple[int, int, int],
    bucket: Optional[int],
    transfer_dtype: str,
) -> str:
    """Cache filename keyed by everything that determines the payload:
    version, canvas, transfer bucket, transfer dtype, and the input-file
    signature. The case identity is the basename plus a short hash of the
    absolute directory, so same-named cases under two roots never evict each
    other."""
    h = _case_signature_hash(case_dir, with_seg=False)
    norm = os.path.normpath(os.path.abspath(case_dir))
    dirh = hashlib.sha1(norm.encode()).hexdigest()[:8]
    base = f"{os.path.basename(norm)}-{dirh}"
    c = "x".join(map(str, canvas))
    b = f"b{bucket}" if bucket else "b0"
    return os.path.join(
        cache_dir,
        f"{base}.pv{PAYLOAD_CACHE_VERSION}.c{c}.{b}.{transfer_dtype}.{h}.npz",
    )


def load_payload(path: str) -> Optional[Payload]:
    """Read a payload entry; None on a miss. A corrupt entry is discarded
    (the caller rebuilds and overwrites)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            small = z["small"]
            if small.dtype == np.uint16:      # bf16 stored as its bit pattern
                small = torch.from_numpy(small.view(np.int16)).view(torch.bfloat16)
            elif small.dtype == np.int8:      # the int8 transfer encoding
                small = torch.from_numpy(small)
            else:
                raise ValueError(f"unexpected payload dtype {small.dtype}")
            dst = tuple(int(v) for v in z["dst"]) if z["has_dst"] else None
            bbox = BBox(
                tuple(int(v) for v in z["bbox_lo"]),
                tuple(int(v) for v in z["bbox_hi"]),
                tuple(int(v) for v in z["full_shape"]),
            )
            return small, dst, bbox
    except Exception as e:  # noqa: BLE001 — corrupt entry: rebuild
        print(f"[payload-cache] discarding corrupt entry {path}: {e}",
              file=sys.stderr, flush=True)
        return None


def store_payload(path: str, small: torch.Tensor,
                  dst: Optional[Tuple[int, int, int]], bbox: BBox) -> None:
    """Atomic (tmp + rename) uncompressed npz write, then prune superseded
    entries of the same case and parameters. A write failure degrades to
    uncached operation: serving must not die because a cache volume filled."""
    cache_dir = os.path.dirname(path)
    small = small.contiguous()
    bits = (small.view(torch.int16).numpy().view(np.uint16)
            if small.dtype == torch.bfloat16 else small.numpy())
    # pid and thread id: prep threads of one process may miss the same case
    # at once, and a shared tmp name would interleave their writes
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(cache_dir, exist_ok=True)
        with open(tmp, "wb") as f:
            np.savez(
                f,
                small=bits,
                has_dst=dst is not None,
                dst=np.zeros(3, np.int32) if dst is None
                else np.asarray(dst, np.int32),
                bbox_lo=np.asarray(bbox.lo, np.int32),
                bbox_hi=np.asarray(bbox.hi, np.int32),
                full_shape=np.asarray(bbox.full_shape, np.int32),
            )
        os.replace(tmp, path)
        _prune_superseded(cache_dir, os.path.basename(path))
    except OSError as e:
        print(f"[payload-cache] write failed ({e}); continuing uncached",
              file=sys.stderr, flush=True)
        try:
            os.remove(tmp)
        except OSError:
            pass


def _entry_key(fn: str):
    """(base, canvas, bucket, dtype) from ``base.pvN.cC.bB.DTYPE.hash.npz``;
    version and signature hash are not part of the key, so a bumped version
    or a re-uploaded case supersedes the old entry."""
    parts = fn.rsplit(".", 6)
    if len(parts) != 7 or not parts[1].startswith("pv"):
        return None
    return (parts[0], parts[2], parts[3], parts[4])


def _prune_superseded(cache_dir: str, mine: str) -> None:
    """Remove same-key entries no newer than the one just written (with two
    shards racing on a re-uploaded case the later writer wins)."""
    key = _entry_key(mine)
    if key is None:
        return
    try:
        my_mtime = os.path.getmtime(os.path.join(cache_dir, mine))
    except OSError:
        return
    for fn in os.listdir(cache_dir):
        if fn.endswith(".npz") and fn != mine and _entry_key(fn) == key:
            p = os.path.join(cache_dir, fn)
            try:
                if os.path.getmtime(p) <= my_mtime:
                    os.remove(p)
            except OSError:
                pass
