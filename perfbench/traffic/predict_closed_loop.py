"""Traffic kind ``predict_closed_loop``: a site segments a cohort.

``volumes`` distinct synthetic cases of ``shape`` (from the seed) are
submitted to ``Predictor.predict_arrays_many`` call after call, the next call
once the last returned: a closed loop of one client, with the pipelined
predictor's prep, dispatch and post threads inside a call. The mix's
``warmup_calls`` run in set-up; the window counts the volumes its calls
completed over its wall time, every call's fill and drain in it. The traced
run profiles ``trace_calls`` calls, then times the host's prep and the device
program apart. ``check_volumes`` answers, drawn from the seed among those the
window completed (one the latest of the largest brain), are judged by the
plain reference once the window has closed.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from perfbench import synth, trace
from perfbench.drivers import (Context, Outcome, device_seconds, flat_params, free,
                               peak_bytes, sync)
from perfbench.reference import networks, segment


class _Starts:
    """Stands in for the predictor's device program and keeps the ROI
    start each volume's program returns (a device tensor; read once the
    window has closed)."""

    def __init__(self, program):
        self._program, self.taken = program, []

    def __getattr__(self, name):
        return getattr(self._program, name)

    def __call__(self, canvas):
        labels, start = self._program(canvas)
        self.taken.append(start)
        return labels, start


class _Sample:
    """The requests whose answers the reference judges: ``k`` drawn
    uniformly from all that completed (reservoir sampling, from the seed),
    one slot always holding the latest answer for the case with the largest
    brain (the longest request)."""

    def __init__(self, k: int, seed: int, longest: int):
        self.k, self.longest = max(k - 1, 0), longest
        self.rng = np.random.default_rng([int(seed), 7])
        self.seen, self.kept, self.last_longest = 0, [], None

    def offer(self, outputs, starts) -> None:
        for i, (labels, start) in enumerate(zip(outputs, starts)):
            item = (i, labels, start)
            if i == self.longest:
                self.last_longest = item
            self.seen += 1
            if len(self.kept) < self.k:
                self.kept.append(item)
            else:
                j = int(self.rng.integers(0, self.seen))
                if j < self.k:
                    self.kept[j] = item

    def items(self):
        return self.kept + ([self.last_longest] if self.last_longest else [])


def _largest_brain(vols) -> int:
    return int(np.argmax([int(np.any(v != 0, axis=-1).sum()) for v in vols]))


def setup(ctx: Context):
    """(predictor, its start keeper, volumes, fine and coarse weights)."""
    from brats2019_tpu_torch.infer.predictor import Predictor

    cfg, dev = ctx.config, ctx.device
    fine = flat_params(cfg, ctx.seed, dev)
    coarse = flat_params(cfg, ctx.seed, dev, coarse=True) if cfg.get("coarse_unet") else None
    vols = synth.volumes(ctx.mix["volumes"], ctx.mix["shape"], ctx.seed, dev)
    free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pred = Predictor(ctx.exp, fine, coarse, device=dev)
    keeper = _Starts(pred.program)
    pred.program = keeper
    for _ in range(ctx.mix["warmup_calls"]):
        pred.predict_arrays_many(vols)
    sync(dev)
    keeper.taken.clear()
    return pred, keeper, vols, fine, coarse


def judge(ctx: Context, sample: _Sample, vols, fine, coarse) -> List[dict]:
    ref = segment.Segmenter(ctx.config, fine, coarse, ctx.device)
    out = []
    for i, labels, start in sample.items():
        r = segment.judge_served(ref, vols[i], labels, start.cpu().numpy())
        out.append(dict(r, volume=i))
    return out


def run(ctx: Context) -> Outcome:
    dev, mix = ctx.device, ctx.mix
    pred, keeper, vols, fine, coarse = setup(ctx)
    setup_s = time.perf_counter() - ctx.t0
    sample = _Sample(mix["check_volumes"], ctx.seed, _largest_brain(vols))

    def call():
        out = pred.predict_arrays_many(vols)
        sample.offer(out, keeper.taken)
        keeper.taken.clear()
        return len(out)

    e2e, readings, prof = {"setup_s": setup_s}, {"kind": "predict"}, None
    if not ctx.traced:
        t = time.perf_counter()
        done, marks = 0, [t]
        while True:
            done += call()
            marks.append(time.perf_counter())
            if marks[-1] - t >= ctx.seconds:
                break
        e2e["predict_vol_per_s"] = done / (time.perf_counter() - t)
        readings["call_s"] = [float(d) for d in np.diff(marks)]
    else:
        done, prof = trace.profiled(
            lambda: sum(call() for _ in range(mix["trace_calls"])), lambda: sync(dev))
        prep, canvases = [], []
        for v in vols:
            t = time.perf_counter()
            canvases.append(pred.prepare(v)[0])
            prep.append(time.perf_counter() - t)
        program_s = device_seconds(
            dev, lambda: [pred.predict_device(c) for c in canvases])
        del canvases
        readings.update(host_prep_s=prep, program_s=program_s / len(vols),
                        volume_flops=networks.reference(ctx.config).program_flops(ctx.config))
    peak = peak_bytes(dev)
    del pred, keeper
    free(dev)
    results = judge(ctx, sample, vols, fine, coarse)
    checks = {"gap": max(r["gap"] for r in results)}
    readings["judged"] = results
    return Outcome(done, 0, e2e, readings, prof, checks, peak)
