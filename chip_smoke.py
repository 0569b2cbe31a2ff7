#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (built for an H100).

    python3 chip_smoke.py

Run from the root of a checkout. Phases:

1. Setup: torch/CUDA versions, the card's name and power limit, TF32 off for
   the plain references, and the kernels built from the checkout's sources.
2. Kernels against their plain torch versions on the card, at every shape
   the flagship cascade's predict path and training path give them: the
   predict shapes, the train steps (fine b1 128^3, coarse b1 64^3) forward
   and backward (conv dgrad is the conv kernel with Ci and Co swapped), and
   the whole-canvas evals (160,224,160) and (80,112,80). Tolerances: conv and
   IN dx max|d|/max|ref| <= 1e-2 against f32 math on the same bf16 inputs
   rounded to bf16; IN+act forward <= 2 bf16 ulp; dgamma/dbeta (f32 sums in
   another order) max|d|/max|ref| <= 1e-3; 2x down/up and their backwards
   <= 1 bf16 ulp. Device time of both (repeated calls replayed from one
   CUDA graph), and their back-to-back wall time (CUDA events), which for a
   small call reads the wrapper's host launch cost.
3. The predict slice: CASES synthetic 240x240x155 cases and seeded random
   ``cascade`` weights saved as ``params.npz``, run through
   ``brats2019_tpu_torch.cli.predict`` on the card with the launch counters
   zeroed just before; outputs checked (shape, labels in {0,1,2,4}), every
   forward kernel launched (24 convs per volume), a repeat run bitwise
   equal, the kernel path held against the plain torch path on the CPU at a
   small input, and device ms/volume (CUDA events) and end-to-end s/volume.
4. The training slice: ``brats2019_tpu_torch.cli.train --preset cascade
   --stage all --device cuda`` on the phase-3 cases (2 train, 1 val) for
   TRAIN_STEPS steps per stage, counters zeroed just before; every logged
   loss finite and grad_norm > 0; the three backward kernels launched exactly
   (14 IN, 3 down, 3 up per fine step; 10, 2, 2 per coarse step); a rerun
   with more steps resumes; ``cli.predict`` serves the trained workdir. Then
   one train step of the kernel path on the card against the plain path on
   the CPU (bf16 both, same weights and batch, a 64^3 patch), and per stage
   the train step ms (CUDA events after warm-up), patches/s, MFU, peak
   device memory, the kernels' device ms per step against their plain
   versions, and a torch.profiler table of the step's device time.

The line before the last holds the kernels' JSON record (forward kernels:
launches on the predict slice, times per volume; backward kernels: launches
on the training slice, times per fine train step; ``ms``/``plain_ms`` are
device times, ``wall_ms``/``plain_wall_ms`` back-to-back wall times); the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a CUDA device the script exits 1 before doing anything.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
# where the profiler tables go (set CHIP_SMOKE_OUT to collect them elsewhere)
OUT = os.environ.get("CHIP_SMOKE_OUT", os.path.join(ROOT, "build", "profiles"))
CASES = 3   # synthetic 240x240x155 requests
SEED = 0    # of the cases and of the random weights
TRAIN_STEPS = 20   # per stage; log every 5, eval and checkpoint every 10
# the one-step check of the kernel train step against the plain path: its
# input, and bounds set from the readings at that size on an H100 (PERF.md:
# loss rel <= 5.6e-6; per-parameter card/CPU-bf16 distance ratio <= 1.17
# where the distance exceeds 0.01; 1.004 and 0.992 over all grads)
STEP_REF_PATCH = (64, 64, 64)
LOSS_TOL = 1e-4
GRAD_FACTOR, GRAD_FACTOR_ALL, GRAD_ABS = 1.3, 1.1, 2e-3

KERNELS = {
    # name: (route, source, the TPU kernel it replaces)
    "conv3d": ("cuda", "brats2019_tpu_torch/csrc/conv3d.cu",
               "brats2019_tpu/ops/pallas_conv.py:79"),
    "instance_norm_act": ("triton", "brats2019_tpu_torch/ops/triton_norm.py",
                          "brats2019_tpu/ops/pallas_norm.py:340"),
    "downsample2x": ("triton", "brats2019_tpu_torch/ops/triton_resize.py",
                     "brats2019_tpu/ops/pallas_resize.py:268"),
    "upsample2x": ("triton", "brats2019_tpu_torch/ops/triton_resize.py",
                   "brats2019_tpu/ops/pallas_resize.py:103"),
    "instance_norm_act_bwd": ("triton", "brats2019_tpu_torch/ops/triton_norm.py",
                              "brats2019_tpu/ops/pallas_norm.py:265"),
    "downsample2x_bwd": ("triton", "brats2019_tpu_torch/ops/triton_resize.py",
                         "brats2019_tpu/ops/pallas_resize.py:304"),
    "upsample2x_bwd": ("triton", "brats2019_tpu_torch/ops/triton_resize.py",
                       "brats2019_tpu/ops/pallas_resize.py:213"),
}
FORWARD = ("conv3d", "instance_norm_act", "downsample2x", "upsample2x")
BACKWARD = ("instance_norm_act_bwd", "downsample2x_bwd", "upsample2x_bwd")
FAILURES: list = []


def check(ok: bool, what: str) -> None:
    print(f"  [{'PASS' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------------ shapes --

def unet_calls(cfg, batch, spatial):
    """The (kernel, shape) calls one forward of ``cfg`` makes, in order:
    conv (N, D, H, W, Ci, Co); norm/down/up (N, D, H, W, C)."""
    r = cfg.stem_downsample
    s = tuple(v // r for v in spatial)
    c = cfg.in_channels * r ** 3
    calls = []

    def block(c_in, f):
        calls.extend([("conv3d", (batch, *s, c_in, f)),
                      ("instance_norm_act", (batch, *s, f)),
                      ("conv3d", (batch, *s, f, f)),
                      ("instance_norm_act", (batch, *s, f))])

    for lvl in range(cfg.levels):
        block(c, cfg.feats(lvl))
        c = cfg.feats(lvl)
        if lvl < cfg.levels - 1:
            calls.append(("downsample2x", (batch, *s, c)))
            s = tuple(v // 2 for v in s)
    for lvl in reversed(range(cfg.levels - 1)):
        calls.append(("upsample2x", (batch, *s, c)))
        s = tuple(v * 2 for v in s)
        block(c + cfg.feats(lvl), cfg.feats(lvl))
        c = cfg.feats(lvl)
    return calls


def train_calls(cfg, batch, spatial):
    """The calls of one train step: the forward's, then the backward's in
    reverse order (IN, down and up backward at their forward input's shape;
    conv dgrad as the conv kernel with Ci and Co swapped, none for the
    stem's first conv)."""
    fwd = unet_calls(cfg, batch, spatial)
    bwd = []
    for i, (name, shape) in enumerate(fwd):
        if name != "conv3d":
            bwd.append((name + "_bwd", shape))
        elif i > 0:
            bwd.append(("conv3d", shape[:4] + (shape[5], shape[4])))
    return fwd + bwd[::-1]


# ------------------------------------------------------------------ phase 2 --

def bf16_ulps(got, ref):
    """Largest |got - ref| in units of bf16 spacing at |ref| (magnitudes
    below 2^-10 use the spacing at 2^-10)."""
    import torch

    ref32 = ref.float()
    mag = ref32.abs().clamp_min(2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - ref32).abs() / ulp).max().item()


def cuda_ms(fn, reps: int) -> float:
    """Wall time per call of back-to-back calls (CUDA events): for a small
    call this is the wrapper's host launch cost, not the card's."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph
    (after a warm-up call on a side stream), timed by CUDA events around a
    replay, so no host launch cost sits between the kernels. (On an H100,
    per-call torch.profiler sessions read up to a third below the wall time
    of a 9 ms kernel in one run and not in another, so they are not used
    here.)"""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def check_kernels(calls, dev):
    """Each unique (kernel, shape) once: error against the plain version,
    then the device time of both (CUDA graph) and their back-to-back wall time
    (CUDA events). Returns {(name, shape): (err, max_abs_err, ms, plain_ms,
    wall_ms, plain_wall_ms)}."""
    import torch

    from brats2019_tpu_torch.ops import conv, norm, resize

    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, shape in dict.fromkeys(calls):
        if name == "conv3d":
            n, d, h, w, ci, co = shape
            x = torch.randn((n, d, h, w, ci), generator=g, device=dev).bfloat16()
            wt = (torch.randn((3, 3, 3, ci, co), generator=g, device=dev)
                  / (27 * ci) ** 0.5).bfloat16()
            kern = lambda: conv.conv3d_kernel(x, wt)
            plain = lambda: conv.conv3d_plain(x, wt)
        elif name == "instance_norm_act":
            x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).bfloat16()
            gam = torch.rand(shape[-1], generator=g, device=dev) + 0.5
            bet = torch.randn(shape[-1], generator=g, device=dev) * 0.2
            kern = lambda: norm.instance_norm_act_kernel(x, gam, bet)[0]
            plain = lambda: norm.instance_norm_act_plain(x, gam, bet)
        elif name == "instance_norm_act_bwd":
            x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).bfloat16()
            gy = torch.randn(shape, generator=g, device=dev).bfloat16()
            gam = torch.rand(shape[-1], generator=g, device=dev) + 0.5
            bet = torch.randn(shape[-1], generator=g, device=dev) * 0.2
            _, mean, rstd = norm._plain_stats(x, gam, bet, 1e-5, "relu")
            args = (x, gy, gam, bet, mean, rstd)
            kern = lambda: norm.instance_norm_act_bwd_kernel(*args)
            plain = lambda: norm.instance_norm_act_bwd_plain(*args)
        elif name == "downsample2x_bwd":
            gy = torch.randn((shape[0],) + tuple(v // 2 for v in shape[1:4])
                             + shape[4:], generator=g, device=dev).bfloat16()
            kern = lambda: resize.downsample2x_bwd_kernel(gy, shape)
            plain = lambda: resize.downsample2x_bwd_plain(gy, shape)
        elif name == "upsample2x_bwd":
            gy = torch.randn((shape[0],) + tuple(2 * v for v in shape[1:4])
                             + shape[4:], generator=g, device=dev).bfloat16()
            kern = lambda: resize.upsample2x_bwd_kernel(gy)
            plain = lambda: resize.upsample2x_bwd_plain(gy)
        else:
            x = torch.randn(shape, generator=g, device=dev).bfloat16()
            kfn = getattr(resize, f"{name}_kernel")
            pfn = getattr(resize, f"{name}_plain")
            kern = lambda: kfn(x)
            plain = lambda: pfn(x)
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        extra = ""
        if name == "instance_norm_act_bwd":
            rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
            sums_err = max(rel(got[1], ref[1]), rel(got[2], ref[2]))
            extra = f", dgamma/dbeta {sums_err:.3e} (tol 1e-3)"
            got, ref = got[0], ref[0]
        abs_err = (got.float() - ref.float()).abs().max().item()
        if name in ("conv3d", "instance_norm_act_bwd"):
            err = abs_err / ref.float().abs().max().item()
            ok = err <= 1e-2 and (not extra or sums_err <= 1e-3)
            what = f"max|d|/max|ref| {err:.3e} (tol 1e-2){extra}"
        else:
            err = bf16_ulps(got, ref)
            tol = 2 if name == "instance_norm_act" else 1
            ok = err <= tol
            what = f"{err:.2f} bf16 ulp (tol {tol})"
        finite = bool(torch.isfinite(got.float()).all())
        reps = 3 if got.numel() > 1e8 else 10
        wall, plain_wall = cuda_ms(kern, reps), cuda_ms(plain, reps)
        ms, plain_ms = device_ms(kern, reps), device_ms(plain, reps)
        check(ok and finite and got.shape == ref.shape,
              f"{name} {shape}: {what}, max|d| {abs_err:.3e}; device "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; wall "
              f"kernel {wall:.4f} ms, plain {plain_wall:.4f} ms")
        results[(name, shape)] = (err, abs_err, ms, plain_ms, wall, plain_wall)
        del got, ref, kern, plain
    return results


# ------------------------------------------------------------------ phase 3 --

def read_labels(case_dirs):
    from brats2019_tpu_torch.utils.nifti import read_nifti

    out = []
    for d in case_dirs:
        name = os.path.basename(d)
        seg, _ = read_nifti(os.path.join(d, f"{name}_pred.nii.gz"),
                            apply_scaling=False)
        out.append(seg)
    return out


def small_reference(exp, work, dev) -> None:
    """Kernel path on the card vs the plain path on the CPU for both nets at
    a small input, same weights, bf16 compute on both."""
    import torch

    from brats2019_tpu_torch.utils.weights import build_unet

    g = torch.Generator().manual_seed(1)
    for stage, cfg in (("fine", exp.unet), ("coarse", exp.coarse_unet)):
        npz = os.path.join(work, stage, "params.npz")
        x = torch.randn((1, 32, 32, 32, 4), generator=g)
        with torch.inference_mode():
            ref = build_unet(cfg, npz, "cpu")(x)
            got = build_unet(cfg, npz, dev)(x.to(dev)).cpu()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        check(bool(torch.isfinite(got).all()) and rel <= 5e-2 and agree >= 0.98,
              f"{stage} net (1,32,32,32,4) card vs CPU plain: logits "
              f"max|d|/max|ref| {rel:.3e} (tol 5e-2), argmax agreement "
              f"{agree:.5f} (tol 0.98)")


def time_slice(exp, work, case_dirs, dev, card):
    """Device ms/volume (CUDA events around the device program on an
    embedded canvas) and end-to-end s/volume (host clock around
    predict_dir: decode, prep, device, postprocess, NIfTI write)."""
    import torch

    from brats2019_tpu_torch.data.case import load_case
    from brats2019_tpu_torch.infer.predictor import Predictor

    pred = Predictor(exp, os.path.join(work, "fine", "params.npz"),
                     os.path.join(work, "coarse", "params.npz"), device=dev)
    dev_ms, roi_ms, fin_ms = [], [], []
    for d in case_dirs:
        canvas, _, _ = pred.prepare(load_case(d).image)
        pred.predict_device(canvas)
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            with torch.inference_mode():
                ev[0].record()
                tiles, start = pred.program.stage_roi(canvas)
                ev[1].record()
                pred.program.stage_finish(tiles, start)
                ev[2].record()
            torch.cuda.synchronize()
            roi_ms.append(ev[0].elapsed_time(ev[1]))
            fin_ms.append(ev[1].elapsed_time(ev[2]))
            dev_ms.append(ev[0].elapsed_time(ev[2]))
    e2e = []
    for d in case_dirs:
        t0 = time.perf_counter()
        pred.predict_dir(d, os.path.join(work, "timed_pred.nii.gz"))
        e2e.append(time.perf_counter() - t0)
    med = lambda v: sorted(v)[len(v) // 2]
    torch.cuda.reset_peak_memory_stats()
    pred.predict_device(canvas)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  device ms/vol median {med(dev_ms):.3f} (stage_roi "
          f"{med(roi_ms):.3f}, stage_finish {med(fin_ms):.3f}; all "
          f"{[round(v, 3) for v in dev_ms]}) on {card}", flush=True)
    print(f"  e2e s/vol median {med(e2e):.3f} (all "
          f"{[round(v, 3) for v in e2e]}) on {card}; peak device memory "
          f"{peak:.2f} GiB", flush=True)


# ------------------------------------------------------------------ phase 4 --

class _Tee(io.TextIOBase):
    """Write to several text streams (the train CLI's output is both shown
    and searched)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(main_fn, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = main_fn(args)
    return rc, buf.getvalue()


def check_train_log(workdir, stage):
    """Every logged step: finite loss, grad_norm > 0; evals logged."""
    with open(os.path.join(workdir, stage, f"{stage}_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "loss" in r]
    evals = [r for r in recs if "val_dice_mean" in r]
    ok = bool(train) and all(math.isfinite(r["loss"]) and r["grad_norm"] > 0
                             for r in train)
    check(ok and [r["step"] for r in train] == [5, 10, 15, 20] and len(evals) == 2,
          f"{stage} log: steps {[r['step'] for r in train]}, losses "
          f"{[round(r['loss'], 4) for r in train]}, grad_norm "
          f"{[round(r['grad_norm'], 4) for r in train]}, val_dice_mean "
          f"{[round(r['val_dice_mean'], 4) for r in evals]}")


def train_slice(cases_root, case_dirs, stage_calls):
    """The train CLI on the card at full cascade width, resume, serve."""
    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.cli import predict as predict_cli
    from brats2019_tpu_torch.cli import train as train_cli
    from brats2019_tpu_torch.data.constants import VOLUME_SHAPE

    tw = os.path.join(WORK, "train_workdir")
    args = ["--data", cases_root, "--preset", "cascade", "--stage", "all",
            "--device", "cuda", "--workdir", tw, "--log-every", "5",
            "--eval-every", "10", "--checkpoint-every", "10"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc, _ = run_cli(train_cli.main, args + ["--steps", str(TRAIN_STEPS)])
    counts = ops.launch_counts()
    check(rc == 0, f"train CLI exit code {rc} ({time.perf_counter() - t0:.1f} s "
                   f"for {TRAIN_STEPS} steps of each stage)")
    for stage in ("coarse", "fine"):
        check_train_log(tw, stage)
    per_step = {stage: {k: sum(1 for n, _ in calls if n == k) for k in KERNELS}
                for stage, calls in stage_calls.items()}
    print(f"  launches on the training slice: {counts}; per train step "
          f"{per_step}", flush=True)
    for k in BACKWARD:
        want = TRAIN_STEPS * sum(per_step[st][k] for st in per_step)
        check(counts[k] > 0 and counts[k] == want,
              f"{k} launched {counts[k]} times on the training slice "
              f"(expected {want})")
    for k in FORWARD:
        check(counts[k] > 0, f"{k} launched {counts[k]} times on the training slice")
    rc, out = run_cli(train_cli.main, args + ["--steps", str(TRAIN_STEPS + 4)])
    for stage in ("coarse", "fine"):
        check(rc == 0 and f"[{stage}] resumed from step {TRAIN_STEPS}" in out,
              f"rerun with --steps {TRAIN_STEPS + 4}: {stage} resumed from "
              f"step {TRAIN_STEPS} (exit code {rc})")
    rc = predict_cli.main([cases_root, "--preset", "cascade", "--workdir", tw,
                           "--device", "cuda"])
    check(rc == 0, f"predict CLI on the trained workdir: exit code {rc}")
    for d, seg in zip(case_dirs, read_labels(case_dirs)):
        vals = sorted(int(v) for v in set(seg.ravel().tolist()))
        check(seg.shape == VOLUME_SHAPE and set(vals) <= {0, 1, 2, 4},
              f"trained workdir, {os.path.basename(d)}: shape {seg.shape}, "
              f"labels {vals}")
    return counts


def step_reference(exp, dev):
    """One train step's loss and grads, kernel path on the card against the
    plain path on the CPU, bf16 compute on both, same weights and batch, at
    STEP_REF_PATCH (the coarse stage's patch; there the fine net's deepest
    IN normalises over 4^3 voxels, the coarse net's over 8^3). bf16 rounding
    alone moves these grads (the plain bf16 path against the same net in
    f32), and by more the farther a parameter sits from the head: 0.02-0.4%
    relative L2 for the head and the last IN, 20-28% at the stem, at random
    weights. So
    each path is measured against the f32 plain path, and the card path may
    be no noisier than the plain bf16 path: each parameter's card grad no
    farther from f32 than GRAD_FACTOR x the CPU bf16 grad's distance +
    GRAD_ABS (an added error above ~0.8x a parameter's own bf16 noise
    fails), all grads together no farther than GRAD_FACTOR_ALL x +
    GRAD_ABS. Loss: LOSS_TOL relative, card vs CPU bf16. The per-parameter
    distances are written under OUT."""
    import dataclasses

    import torch

    from brats2019_tpu_torch.train.loop import init_stage
    from brats2019_tpu_torch.train.step import make_microbatch_loss

    g = torch.Generator().manual_seed(2)
    cfg = dataclasses.replace(exp.train, patch=STEP_REF_PATCH)
    for stage, ucfg in (("fine", exp.unet), ("coarse", exp.coarse_unet)):
        t0 = time.perf_counter()
        imgs = torch.randn((1, *STEP_REF_PATCH, 4), generator=g)
        segs = torch.randint(0, 4, (1, *STEP_REF_PATCH), generator=g)
        loss_fn = make_microbatch_loss(cfg, ucfg.stem_downsample, lowres=True)
        runs = {}
        for key, where, dt in (("cpu_bf16", "cpu", "bfloat16"),
                               ("card_bf16", dev, "bfloat16"),
                               ("cpu_f32", "cpu", "float32")):
            model, _ = init_stage(dataclasses.replace(ucfg, compute_dtype=dt),
                                  cfg, where)
            loss, _ = loss_fn(model, imgs.to(where), segs.to(where))
            loss.backward()
            runs[key] = (loss.item(), {n: p.grad.float().cpu()
                                       for n, p in model.named_parameters()})
        f32 = runs["cpu_f32"][1]
        names = list(f32)
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()
        cat = lambda d: torch.cat([d[n].flatten() for n in names])
        err = {k: {n: rel(runs[k][1][n], f32[n]) for n in names}
               for k in ("cpu_bf16", "card_bf16")}
        tot = {k: rel(cat(runs[k][1]), cat(f32)) for k in err}
        vs_cpu = {n: rel(runs["card_bf16"][1][n], runs["cpu_bf16"][1][n])
                  for n in names}
        worst = max(names, key=lambda n: err["card_bf16"][n]
                    - 2 * err["cpu_bf16"][n])
        l_cpu, l_card = runs["cpu_bf16"][0], runs["card_bf16"][0]
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        finite = all(bool(torch.isfinite(v).all())
                     for v in runs["card_bf16"][1].values())
        ok = (finite and loss_rel <= LOSS_TOL
              and all(err["card_bf16"][n]
                      <= GRAD_FACTOR * err["cpu_bf16"][n] + GRAD_ABS
                      for n in names)
              and tot["card_bf16"] <= GRAD_FACTOR_ALL * tot["cpu_bf16"] + GRAD_ABS)
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, f"step_reference_{stage}.json"), "w") as f:
            json.dump({"loss": {k: v[0] for k, v in runs.items()}, "all": tot,
                       "per_param": {n: {"card_bf16": err["card_bf16"][n],
                                         "cpu_bf16": err["cpu_bf16"][n],
                                         "card_vs_cpu": vs_cpu[n]}
                                     for n in names}}, f, indent=1)
        med = lambda v: sorted(v)[len(v) // 2]
        ratio = max(err["card_bf16"][n] / err["cpu_bf16"][n] for n in names)
        check(ok, f"{stage} train step, patch {STEP_REF_PATCH}, card vs CPU plain, "
                  f"bf16, {time.perf_counter() - t0:.1f} s: "
                  f"loss {l_card:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2e}, tol "
                  f"{LOSS_TOL:g}; f32 {runs['cpu_f32'][0]:.6f}); largest "
                  f"card/CPU-bf16 distance ratio {ratio:.3f} (bound "
                  f"{GRAD_FACTOR:g}x + {GRAD_ABS:g}); grads vs f32, all "
                  f"params: card {tot['card_bf16']:.3e}, CPU bf16 "
                  f"{tot['cpu_bf16']:.3e}; per param median card "
                  f"{med(err['card_bf16'].values()):.3e}, CPU bf16 "
                  f"{med(err['cpu_bf16'].values()):.3e}; closest to the "
                  f"bound {worst} card {err['card_bf16'][worst]:.3e} vs CPU "
                  f"bf16 {err['cpu_bf16'][worst]:.3e}; card vs CPU bf16 "
                  f"median {med(vs_cpu.values()):.3e}")


def _kernel_us(evt) -> float:
    """Device time of a profiler row that is a device kernel (0 for the
    host-side ops, which would count their kernels a second time)."""
    if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total",
                 "device_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_steps(step, pool, stage, first_step, n, step_ms):
    """torch.profiler over n train steps: device kernel time by name (top
    rows printed, the whole table under OUT), and its sum against
    the unprofiled step time (CUDA events) as the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(first_step, first_step + n):
                step(pool, i)
            torch.cuda.synchronize()
        rows = sorted((e for e in prof.key_averages() if _kernel_us(e) > 0),
                      key=_kernel_us, reverse=True)
        busy_ms = sum(_kernel_us(e) for e in rows) / n / 1e3
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, f"train_profile_{stage}.txt"), "w") as f:
            for e in rows:
                f.write(f"{_kernel_us(e) / n:12.1f} us/step  "
                        f"{e.count // n:5d}/step  {e.key}\n")
        print(f"  {stage} profile: device kernels {busy_ms:.3f} ms per step = "
              f"{100 * busy_ms / step_ms:.1f}% of the {step_ms:.3f} ms step "
              f"(idle {100 * (1 - busy_ms / step_ms):.1f}%)", flush=True)
        for e in rows[:15]:
            print(f"    {_kernel_us(e) / n / 1e3:9.3f} ms/step "
                  f"{e.count // n:4d}x  {e.key[:100]}", flush=True)
    except Exception as e:  # noqa: BLE001 — an extra measurement only
        print(f"  {stage} profile: not measured ({type(e).__name__}: {e})",
              flush=True)


def time_training(exp, dev, card, results, stage_calls):
    """Per stage: train step ms (CUDA events, 10 steps after 3 warm-up
    steps) on a device pool of random cases at the stage's canvas, patches/s,
    MFU, peak device memory, each kernel's ms per step against its plain
    version (phase-2 times at the step's shapes), then a profile."""
    import types

    import numpy as np
    import torch

    from brats2019_tpu_torch.train.loop import init_stage, stage_config
    from brats2019_tpu_torch.train.step import TrainStep, make_microbatch_loss
    from brats2019_tpu_torch.utils.flops import mfu, train_step_flops

    name = torch.cuda.get_device_name(0)
    out = {}
    for stage in ("coarse", "fine"):
        ucfg, cfg, _ = stage_config(exp, stage)
        model, opt = init_stage(ucfg, cfg, dev)
        g = torch.Generator(device=dev).manual_seed(3)
        k = cfg.pool_cases_per_device
        canvas = tuple(cfg.pool_shape)
        rng = np.random.default_rng(3)
        pool = types.SimpleNamespace(
            image=torch.randn((k,) + canvas + (4,), generator=g,
                              device=dev).bfloat16(),
            seg=torch.randint(0, 4, (k,) + canvas, generator=g, device=dev,
                              dtype=torch.uint8),
            fg_host=np.stack([np.stack([rng.integers(0, c, 4096) for c in canvas],
                                       -1).astype(np.int32) for _ in range(k)]))
        step = TrainStep(model, cfg, make_microbatch_loss(
            cfg, ucfg.stem_downsample, lowres=True), opt)
        for i in range(3):
            step(pool, i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        reps = 10
        ev[0].record()
        for i in range(3, 3 + reps):
            aux = step(pool, i)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / reps
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        flops = train_step_flops(ucfg, cfg)
        m = mfu(flops, ms / 1e3, name)
        check(math.isfinite(float(aux["loss"])),
              f"{stage} timed steps: loss {float(aux['loss']):.4f}")
        print(f"  {stage} train step {ms:.3f} ms (CUDA events, mean of {reps} "
              f"after 3 warm-up), {cfg.batch_per_device * 1e3 / ms:.2f} "
              f"patches/s, MFU {'n/a' if m is None else f'{100 * m:.2f}%'} "
              f"({flops / 1e12:.3f} TFLOP/step), peak device memory "
              f"{peak:.2f} GiB, patch {cfg.patch} on {card}", flush=True)
        kern = {}
        for kname in BACKWARD + FORWARD:
            mine = [results[(n, sh)] for n, sh in stage_calls[stage] if n == kname]
            kern[kname] = tuple(sum(r[i] for r in mine) for i in (2, 3, 4, 5))
            print(f"    {kname}: {len(mine)} calls/step, device "
                  f"{kern[kname][0]:.4f} ms/step in kernels vs "
                  f"{kern[kname][1]:.4f} ms/step plain torch; wall "
                  f"{kern[kname][2]:.4f} vs {kern[kname][3]:.4f}", flush=True)
        out[stage] = kern
        profile_steps(step, pool, stage, 3 + reps, 3, ms)
        del model, opt, step, pool
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; this smoke test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.cli import predict as predict_cli
    from brats2019_tpu_torch.configs.presets import get_preset
    from brats2019_tpu_torch.data import synthetic
    from brats2019_tpu_torch.data.constants import VOLUME_SHAPE
    from brats2019_tpu_torch.ops import _build, conv
    from brats2019_tpu_torch.train.loop import stage_config
    from brats2019_tpu_torch.utils.weights import init_params, save_params_npz

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print("== phase 1: setup", flush=True)
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s), "
          f"device 0: {name}", flush=True)
    print(f"  card: {card}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    conv._lib()
    print(f"  built conv3d.cu with nvcc in {time.perf_counter() - t0:.1f} s; "
          f"ptxas: {_build.build_logs.get('conv3d', '(cached)').strip()}",
          flush=True)

    exp = get_preset("cascade")
    calls = (unet_calls(exp.coarse_unet, 1, exp.infer.coarse_shape)
             + unet_calls(exp.unet, 8, exp.infer.roi_shape))
    coarse_canvas = stage_config(exp, "coarse")[1].pool_shape
    stage_calls = {
        "coarse": train_calls(exp.coarse_unet, 1, exp.train.coarse_patch),
        "fine": train_calls(exp.unet, 1, exp.train.patch),
    }
    eval_calls = (unet_calls(exp.coarse_unet, 1, coarse_canvas)
                  + unet_calls(exp.unet, 1, exp.train.pool_shape))
    print("== phase 2: kernels vs plain torch at the flagship shapes", flush=True)
    t0 = time.perf_counter()
    results = check_kernels(calls + stage_calls["coarse"] + stage_calls["fine"]
                            + eval_calls, dev)
    print(f"  phase 2 took {time.perf_counter() - t0:.1f} s", flush=True)

    print("== phase 3: the cascade predict slice on the card", flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    work = os.path.join(WORK, "workdir")
    for stage, cfg, seed in (("fine", exp.unet, SEED),
                             ("coarse", exp.coarse_unet, SEED + 1)):
        os.makedirs(os.path.join(work, stage))
        save_params_npz(os.path.join(work, stage, "params.npz"),
                        init_params(cfg, seed))
    t0 = time.perf_counter()
    case_dirs = synthetic.write_dataset(os.path.join(WORK, "cases"), CASES,
                                        shape=VOLUME_SHAPE, seed0=SEED)
    print(f"  wrote {CASES} synthetic {VOLUME_SHAPE} cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cli_args = [os.path.join(WORK, "cases"), "--preset", "cascade",
                "--workdir", work, "--device", "cuda"]

    ops.reset_launch_counts()
    rc = predict_cli.main(cli_args)
    counts = ops.launch_counts()
    check(rc == 0, f"predict CLI exit code {rc}")
    per_vol = {k: v / CASES for k, v in counts.items()}
    expect = {k: sum(1 for n, _ in calls if n == k) for k in FORWARD}
    print(f"  launches on the slice: {counts} ({per_vol} per volume; "
          f"expected per volume {expect})", flush=True)
    for k in FORWARD:
        check(counts[k] > 0 and counts[k] == expect[k] * CASES,
              f"{k} launched {counts[k]} times on the slice")
    first = read_labels(case_dirs)
    for d, seg in zip(case_dirs, first):
        vals = sorted(int(v) for v in set(seg.ravel().tolist()))
        check(seg.shape == VOLUME_SHAPE and set(vals) <= {0, 1, 2, 4},
              f"{os.path.basename(d)}: shape {seg.shape}, labels {vals}")
    rc = predict_cli.main(cli_args)
    check(rc == 0, f"repeat predict CLI exit code {rc}")
    for d, a, b in zip(case_dirs, first, read_labels(case_dirs)):
        check(a.shape == b.shape and bool((a == b).all()),
              f"{os.path.basename(d)}: repeat run bitwise equal")
    small_reference(exp, work, dev)
    time_slice(exp, work, case_dirs, dev, card)

    print("== phase 4: the cascade training slice on the card", flush=True)
    t0 = time.perf_counter()
    train_counts = train_slice(os.path.join(WORK, "cases"), case_dirs,
                               stage_calls)
    step_reference(exp, dev)
    per_step = time_training(exp, dev, card, results, stage_calls)
    print(f"  phase 4 took {time.perf_counter() - t0:.1f} s", flush=True)

    record = []
    for k, (route, source, replaces) in KERNELS.items():
        errs = [r[1] for (n, _), r in results.items() if n == k]
        if k in FORWARD:
            # per volume: the predict slice's calls of this kernel, summed
            mine = [results[(n, shape)] for n, shape in calls if n == k]
            times = tuple(sum(r[i] for r in mine) for i in (2, 3, 4, 5))
            launches = counts[k]
        else:
            # per fine train step: the step's calls of this kernel, summed
            times = per_step["fine"][k]
            launches = train_counts[k]
        record.append({
            "name": k, "route": route, "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(errs),
            "ms": times[0], "plain_ms": times[1],
            "wall_ms": times[2], "plain_wall_ms": times[3],
        })
    for r in record:
        unit = "vol" if r["name"] in FORWARD else "fine train step"
        print(f"  {r['name']}: device {r['ms']:.4f} ms/{unit} in kernels vs "
              f"{r['plain_ms']:.4f} plain torch (wall {r['wall_ms']:.4f} vs "
              f"{r['plain_wall_ms']:.4f}) on {card}", flush=True)
    print(f"== done in {time.perf_counter() - t_start:.1f} s; "
          f"{len(FAILURES)} failure(s)", flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    if FAILURES:
        for f in FAILURES:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
