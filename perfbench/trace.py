"""The traced window: ``torch.profiler`` over a stretch of the cell's own
work, reduced to what the per-layer readers and the ``breakdown`` need.

* busy: the union of the intervals in which a kernel, a copy or a fill ran
  on the device; idle is the rest of the window (a ``record_function``
  marker around the traced work, on the host's clock in the trace's time
  base);
* the device operations that took most time, by name;
* the idle gaps, the longest each named by the innermost host operation
  that spans its midpoint, summed by name;
* every call of the program's own operators (``brats_torch::*``,
  ``ops/library.py``): its name, its inputs' shapes and the device time of
  the kernels launched under it, for a reader to select from.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Tuple

import numpy as np

WINDOW = "perfbench_window"
NAMED_GAPS = 500     # the longest gaps named one by one; the rest summed
OPS = "brats_torch::"   # the namespace of the program's operators


@dataclasses.dataclass
class Profile:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    op_calls: List[Tuple[str, Tuple[tuple, ...], float]]   # name, input shapes, s


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _device_side(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith(("CUDA", "PrivateUse1"))


def _on_device(evt) -> bool:
    """A kernel, copy or fill on the device (not a host annotation's
    device-side mirror)."""
    return (_device_side(evt) and not getattr(evt, "is_user_annotation", False)
            and evt.name != WINDOW)


def profiled(fn: Callable[[], object], sync: Callable[[], None]):
    """Run ``fn`` under the profiler; returns (its result, :class:`Profile`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts, record_shapes=True) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            out = fn()
            sync()
            wall = time.perf_counter() - t0
    return out, summarize(prof.events(), wall)


def summarize(events, wall_s: float) -> Profile:
    events = list(events)
    marks = [e for e in events if e.name == WINDOW and not _device_side(e)]
    w0, w1 = ((marks[0].time_range.start, marks[0].time_range.end) if marks
              else (0.0, wall_s * 1e6))
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if _on_device(e))
    merged: List[List[float]] = []
    for a, b, _ in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    by_name: dict = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    host = [e for e in events if not _on_device(e) and e.name != WINDOW]
    h0 = np.array([e.time_range.start for e in host] or [0.0])
    h1 = np.array([e.time_range.end for e in host] or [0.0])
    names = [e.name for e in host] or [""]
    edges = np.array([w0] + [x for ab in merged for x in ab] + [w1])
    spans = np.stack([edges[0::2], edges[1::2]], -1)
    spans = spans[spans[:, 1] > spans[:, 0]]
    spans = spans[np.argsort(spans[:, 0] - spans[:, 1])]
    gaps: dict = {}
    for a, b in spans[:NAMED_GAPS]:
        mid = 0.5 * (a + b)
        inside = (h0 <= mid) & (h1 >= mid)
        name = (names[int(np.argmin(np.where(inside, h1 - h0, np.inf)))]
                if inside.any() else "(no host operation)")
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    rest = float((spans[NAMED_GAPS:, 1] - spans[NAMED_GAPS:, 0]).sum()) * 1e-6
    if rest > 0:
        gaps["(shorter gaps)"] = rest
    calls = [(e.name, tuple(tuple(x) for x in (e.input_shapes or ())), _device_us(e) * 1e-6)
             for e in events if e.name.startswith(OPS) and not _on_device(e)]
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]
    return Profile(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                   device_ops=top(by_name), idle_gaps=top(gaps), op_calls=calls)
