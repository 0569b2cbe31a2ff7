"""The port's tracing: program spans kept in memory, and ``--profile`` on
train and predict, a ``torch.profiler`` trace written in Chrome trace format
as ``<dir>/trace.json`` (reference: ``jax.profiler.start_trace`` /
``stop_trace`` in ``brats2019_tpu/train/loop.py`` and ``cli/predict.py``).

Spans. ``with span(name, req, device_edges):`` marks a stretch of the
program at a layer boundary. A span that records keeps, in a bounded
in-memory list that :func:`snapshot` reads: its name, its request id (given,
or its parent's), its parent (the span open around it on the same thread),
its thread, and its start and end on ``time.perf_counter_ns``. While a
profiler records on the calling thread, it also opens a
``torch.profiler.record_function(name)``, so the span lands in the
profiler's events on the device trace's own clock. With ``device_edges`` it
records a CUDA event on the current stream at entry and at exit, read only
when :func:`snapshot` is asked, after the work: no sync on the hot path. For
a span in which the host waits, exit minus entry on the device clock is the
time the stream stood empty while the host was in the span. Counts are span
counts (volumes, CC flag reads, steps). Span names never start with
``brats_torch::``, the namespace of the program's operators.

The spans the port opens: ``predict.call``, ``predict.prep`` (``prep.decode``,
``prep.encode``, ``prep.copy``), ``predict.await_prep``, ``predict.program``,
``predict.await_post``, ``predict.post`` (``post.fetch``, ``post.finish``,
``post.write``) in ``infer/predictor.py``; ``program.sweep`` and
``program.cc`` in ``models/cascade.py``, ``cc.sync`` in
``ops/connected_components.py``; ``train.step``, ``train.sample``,
``train.forward``, ``train.backward``, ``train.update`` in
``train/step.py``; ``swin.encoder`` and ``swin.decoder`` (device edges)
around the two halves of a Swin UNETR forward in ``models/swin_unetr.py``.

On or off. A call into the port (a function decorated with :func:`entry`:
``Predictor.predict_arrays_many``, ``predict_dirs``, ``predict_arrays``,
``predict_dir``, ``predict_device``, ``MultichipPredictor._run``,
``TrainStep.__call__``) reads the switch once, on its calling thread: on
while ``torch.profiler`` records there or :func:`start_trace`'s profiler
runs, or inside :func:`recording`. Its threads get the state with their
work (:func:`carry`), because a pool thread cannot see the caller's
profiler. Off, ``span`` costs one check of the thread's state and returns
a shared no-op: no ``record_function``, no event, nothing kept.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Callable, List, Optional

import torch

OFF, RECORD, PROFILE = 0, 1, 2   # a call's state: off, spans, spans + record_function
KEPT = 1 << 16                   # finished spans kept, the oldest dropped first


class _Thread(threading.local):
    """A thread's recorder state: the running call's (None outside a call)
    and its open spans."""

    state = None

    def __init__(self):
        self.stack: list = []


_tls = _Thread()
_kept: collections.deque = collections.deque(maxlen=KEPT)
_ids = itertools.count(1)
_calls = itertools.count()
_forced = [0]                    # open recording() blocks, in any thread
_traced = [0]                    # running start_trace() profilers
_count_lock = threading.Lock()   # guards both counts
_NOOP = contextlib.nullcontext()


class Span:
    """One finished span. ``device_ms`` is the time between its two CUDA
    events (None without device edges), read once on first use."""

    __slots__ = ("id", "name", "req", "parent", "thread", "start_ns", "end_ns",
                 "_edges", "_device_ms")

    def __init__(self, name: str, req, parent: Optional["Span"], edges):
        self.id = next(_ids)
        self.name, self.parent, self._edges = name, parent, edges
        self.req = req if req is not None or parent is None else parent.req
        self.thread = threading.get_ident()
        self.start_ns, self.end_ns = time.perf_counter_ns(), 0
        self._device_ms = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        if self._device_ms is None and self._edges is not None:
            self._edges[1].synchronize()
            self._device_ms = self._edges[0].elapsed_time(self._edges[1])
        return self._device_ms


class _Open:
    __slots__ = ("name", "req", "edges", "state", "span", "rf")

    def __init__(self, name, req, edges, state):
        self.name, self.req, self.edges, self.state = name, req, edges, state

    def __enter__(self):
        stack = _tls.stack
        edges = None
        if self.edges and torch.cuda.is_initialized():
            edges = (torch.cuda.Event(enable_timing=True),
                     torch.cuda.Event(enable_timing=True))
            edges[0].record()
        self.span = Span(self.name, self.req, stack[-1] if stack else None, edges)
        stack.append(self.span)
        self.rf = None
        if self.state == PROFILE:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self.span

    def __exit__(self, *exc):
        s = self.span
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if s._edges is not None:
            s._edges[1].record()
        s.end_ns = time.perf_counter_ns()
        _tls.stack.pop()
        _kept.append(s)
        return False


def span(name: str, req=None, device_edges: bool = False):
    """A span around a ``with`` block (module docstring); the shared no-op
    when the running call does not record."""
    state = _tls.state
    if not state:
        return _NOOP
    return _Open(name, req, device_edges, state)


def _switch() -> int:
    # a profiler of all threads reads as off in every thread, so the one
    # start_trace() runs is counted here
    if _traced[0] or torch.autograd._profiler_enabled():
        return PROFILE
    return RECORD if _forced[0] else OFF


def entry(fn: Callable) -> Callable:
    """Decorate a call into the port: the outermost one on a thread reads the
    switch (module docstring) for the spans its work opens."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if _tls.state is not None:
            return fn(*args, **kwargs)
        _tls.state = _switch()
        try:
            return fn(*args, **kwargs)
        finally:
            _tls.state = None

    return call


def carry(fn: Callable) -> Callable:
    """``fn`` to run in another thread with this call's state (``fn`` itself
    when the call does not record)."""
    state = _tls.state
    if not state:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        outer = _tls.state
        _tls.state = state
        try:
            return fn(*args, **kwargs)
        finally:
            _tls.state = outer

    return run


def call_number() -> int:
    """A new call's number, the first half of its volumes' request ids."""
    return next(_calls)


@contextlib.contextmanager
def recording():
    """Record spans in the calls that start inside this block, with or
    without a profiler (tests, ``chip_smoke.py``)."""
    with _count_lock:
        _forced[0] += 1
    try:
        yield
    finally:
        with _count_lock:
            _forced[0] -= 1


def snapshot() -> List[Span]:
    """The finished spans kept, oldest first."""
    return list(_kept)


def clear() -> None:
    _kept.clear()


def _experimental_config():
    """``profile_all_threads`` where the installed torch has it, so the trace
    shows the prep and post threads' spans too; else None."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def start_trace(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts,
                                  experimental_config=_experimental_config())
    prof.start()
    with _count_lock:
        _traced[0] += 1
    return prof


def stop_trace(prof, device: torch.device, out_dir: str) -> str:
    """Wait for the card, stop the trace and write ``<out_dir>/trace.json``."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    with _count_lock:
        _traced[0] -= 1
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path
