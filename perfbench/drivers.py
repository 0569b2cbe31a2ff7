"""What every driver of a traffic kind shares, and the loader that finds a
kind's driver by name: ``perfbench/traffic/<kind>.py``, the general generator
that reads every mix (``perfbench/traffic/<mix>.json``) whose ``kind`` names
it, a function ``run(ctx: Context) -> Outcome``. A new kind of traffic is a
new file there; the harness needs no edit.

A driver has three parts: set-up (inputs and weights from the seed, the
program built and warmed on the cell's shapes), the measured window
(``--trace 0``) or the traced one (``--trace 1``), and the readings that
decide ``correct``, taken once the window has closed, the peak memory has
been read and the program's state is freed.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import synth, trace
from .reference import networks, unet as ref_unet


@dataclasses.dataclass
class Context:
    exp: object                # the program's ExperimentConfig
    config: dict               # the configuration file's "experiment"
    mix: dict
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    t0: float                  # the process's start, for set-up time


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: Dict[str, float]
    readings: Dict[str, object]   # what the per-layer readers read
    profile: Optional[trace.Profile]
    checks: Dict[str, float]
    memory_peak_bytes: int


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_seconds(device, fn: Callable[[], object]) -> float:
    """Seconds ``fn``'s work takes on the device's stream (CUDA events,
    synchronised at the end); on the CPU the host clock."""
    sync(device)
    if device.type != "cuda":
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    fn()
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) * 1e-3


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def flat_params(exp: dict, seed: int, device, coarse: bool = False) -> Dict[str, np.ndarray]:
    """The fine network's weights (``exp``: the configuration file's
    ``experiment``), or with ``coarse`` the coarse U-Net's, made on
    ``device`` from the seed, as the flat export dict the program loads."""
    net, section, tag = ((ref_unet, "coarse_unet", "coarse") if coarse
                         else (networks.reference(exp), "unet", "fine"))
    made = synth.params(net.param_shapes(exp[section]), seed, tag, device)
    return {k: v.cpu().numpy() for k, v in made.items()}


def load(root: Path, kind: str):
    """The driver module of traffic kind ``kind`` in the checkout ``root``."""
    path = root / "perfbench" / "traffic" / f"{kind}.py"
    if not path.is_file():
        raise KeyError(f"no driver {path.name} for traffic kind {kind!r}")
    spec = importlib.util.spec_from_file_location(f"perfbench_traffic_{kind}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
