"""ctypes binding for the native case loader ``csrc/fastnifti.cpp`` (a copy
of the JAX package's ``brats2019_tpu/utils/nifti_fast.py``; the decoder's
contract and the meta it returns are the reference's).

``load_volumes_fast`` decodes all modalities of a BraTS case in parallel
native threads: gunzip + parse + F->C reorder + channel interleave + one-pass
nonzero stats and brain bbox, in place of four NumPy passes on the host.

Build: at first use, ``g++`` with the flags of the root ``csrc/Makefile``
(:data:`CXX_FLAGS`, :data:`LD_FLAGS`) compiles the port's own copy into
``<checkout>/build/host/libfastnifti_<hash>.so``, named by a hash of the
source and the flags (as ``ops/_build.py`` names the CUDA kernels), under an
flock so concurrent first users (parallel tests, several worker processes)
never load a half-written library. ``-march=native`` builds for the host
that runs it. When g++, zlib or the load fails, :func:`available` is False
and ``data/case.py`` ``load_case(backend="auto")`` uses the NumPy reader;
``backend="native"`` raises instead.

ABI handshake: the library must export ``fn_abi_version() == 2``
(``FN_ABI_VERSION`` in the source); any other answer counts as unavailable,
so these argtypes never call a library of another signature.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fastnifti.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "host"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LD_FLAGS = ("-shared", "-lz", "-lpthread")
ABI_VERSION = 2  # FN_ABI_VERSION in csrc/fastnifti.cpp


class _FNInfo(ctypes.Structure):
    _fields_ = [
        ("dims", ctypes.c_int64 * 3),
        ("sum", ctypes.c_double),
        ("sumsq", ctypes.c_double),
        ("nonzero", ctypes.c_int64),
        ("bbox_lo", ctypes.c_int64 * 3),
        ("bbox_hi", ctypes.c_int64 * 3),
        ("ok", ctypes.c_int32),
        ("err", ctypes.c_char * 256),
    ]


_lib = None
_tried = False
_lock = threading.Lock()
# why the last build or load failed (None when it did not)
build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha1(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfastnifti_{h.hexdigest()[:12]}.so"


def _build(so: Path) -> None:
    """Compile to a temporary name and rename it into place, under an flock
    on ``<so>.lock``; a library already there is kept."""
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(str(so) + ".lock", "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            if so.exists():
                return
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LD_FLAGS]
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=300)
            if res.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed (rc "
                                   f"{res.returncode}):\n{res.stderr[-2000:]}")
            os.replace(tmp, so)
        finally:
            fcntl.flock(lock_f, fcntl.LOCK_UN)


def _ensure_lib():
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.fn_abi_version.restype = ctypes.c_int
            if lib.fn_abi_version() != ABI_VERSION:
                raise RuntimeError(f"{so}: ABI {lib.fn_abi_version()}, "
                                   f"expected {ABI_VERSION}")
        except Exception as e:  # noqa: BLE001 — unavailable: NumPy reader
            build_error = f"{type(e).__name__}: {e}"
            return None
        lib.fn_probe.argtypes = [ctypes.c_char_p, ctypes.c_int64 * 3]
        lib.fn_probe.restype = ctypes.c_int
        lib.fn_read_case.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64 * 3,
            ctypes.POINTER(_FNInfo),
            ctypes.c_int32,
        ]
        lib.fn_read_case.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """True when the decoder is built (or builds now) and loads."""
    return _ensure_lib() is not None


def load_volumes_fast(
    paths: List[str],
) -> Optional[Tuple[np.ndarray, dict]]:
    """Decode N NIfTI files into one (X, Y, Z, N) float32 array natively.

    Returns (array, meta), or None when the library is unavailable or a file
    is malformed or disagrees with the first one's dims. meta carries the
    per-volume nonzero stats and the union brain bbox:
    {"mean": (N,), "std": (N,), "bbox_lo": (3,), "bbox_hi": (3,)}.
    """
    lib = _ensure_lib()
    if lib is None:
        return None
    dims = (ctypes.c_int64 * 3)()
    if lib.fn_probe(paths[0].encode(), dims) != 0:
        return None
    shape = (dims[0], dims[1], dims[2], len(paths))
    out = np.empty(shape, dtype=np.float32)
    infos = (_FNInfo * len(paths))()
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.fn_read_case(
        c_paths,
        len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dims,
        infos,
        0,
    )
    if rc != 0:
        return None
    # the native side rejects a dims mismatch before writing; never trust
    # the buffer unless every decoded header matched the allocation
    for info in infos:
        if tuple(info.dims[:]) != (dims[0], dims[1], dims[2]):
            return None
    means, stds = [], []
    lo = np.array([dims[0], dims[1], dims[2]], np.int64)
    hi = np.zeros(3, np.int64)
    for info in infos:
        n = max(int(info.nonzero), 1)
        mu = info.sum / n
        var = max(info.sumsq / n - mu * mu, 0.0)
        means.append(mu)
        stds.append(var ** 0.5)
        if info.nonzero:
            lo = np.minimum(lo, np.array(info.bbox_lo[:], np.int64))
            hi = np.maximum(hi, np.array(info.bbox_hi[:], np.int64))
    if (hi <= lo).any():
        lo = np.zeros(3, np.int64)
        hi = np.array([dims[0], dims[1], dims[2]], np.int64)
    meta = {
        "mean": np.array(means, np.float64),
        "std": np.array(stds, np.float64),
        "bbox_lo": lo,
        "bbox_hi": hi,
    }
    return out, meta
