"""Build and load the CUDA C++ kernels.

The sources under ``brats2019_tpu_torch/csrc/`` expose a plain C interface.
At first use they are compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``<checkout>/build/kernels/`` (named by a hash of source and
flags, so an edit rebuilds) and loaded with ``ctypes``. Pointers and the
stream travel as ``c_void_p``; every entry point returns
``cudaGetLastError()`` and :func:`check` raises when it is not 0. A failed
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict = {}
_lib_locks: dict = {}
# nvcc's stderr (ptxas register / shared-memory report) per built library
build_logs: dict = {}


def find_nvcc() -> str:
    cand = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand.append(os.path.join(root, "bin", "nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
        "the CUDA kernels are built from source at first use"
    )


def load_library(name: str, sources, signatures: dict,
                 extra_flags=(), prepare: str | None = None) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>_<hash>.so`` from ``sources``
    (file names under csrc/). ``signatures`` maps each exported function
    to its ctypes ``argtypes``; every function returns an int error code.
    ``extra_flags`` go to nvcc after the common ones (a probe build's -D).
    ``prepare`` names an exported function without arguments called once
    after loading (e.g. to set a kernel's shared-memory attribute outside
    any stream capture); a non-zero return raises.
    One lock per library: two libraries build side by side when two threads
    ask for them (:func:`build_all`)."""
    with _lock:
        if name in _libs:
            return _libs[name]
        lib_lock = _lib_locks.setdefault(name, threading.Lock())
    with lib_lock:
        if name in _libs:
            return _libs[name]
        paths = [CSRC / s for s in sources]
        flags = (*NVCC_FLAGS, *extra_flags)
        h = hashlib.sha1(" ".join(flags).encode())
        for p in paths:
            h.update(p.read_bytes())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *flags, "-o", str(tmp), *map(str, paths)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            build_logs[name] = res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {name} (rc {res.returncode}):\n"
                    f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
                )
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        if prepare is not None:
            check(getattr(lib, prepare)(), f"{name}: {prepare}")
        with _lock:
            _libs[name] = lib
        return lib


def build_all(loaders) -> None:
    """Call each library loader (e.g. ``conv._lib``) on its own thread, so
    every CUDA source compiles at once (one nvcc per source)."""
    threads = []
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    for fn in loaders:
        t = threading.Thread(target=run, args=(fn,))
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SMs of a CUDA device (a launch plan counts its tile waves in them)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def count_launch(wrapper, *counters: str) -> None:
    """Add one to ``wrapper.launches`` (or to each named counter of the
    wrapper), under a lock: a serving process has prep and post threads beside
    the thread that launches kernels."""
    with _count_lock:
        for counter in counters or ("launches",):
            setattr(wrapper, counter, getattr(wrapper, counter) + 1)
