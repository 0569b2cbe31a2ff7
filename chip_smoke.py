#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (built for an H100).

    python3 chip_smoke.py

Run from the root of a checkout. Phases:

1. Setup: torch/CUDA versions, the card's name and power limit, TF32 off for
   the plain references, and the kernels built from the checkout's sources.
2. Kernels against their plain torch versions on the card, at every shape
   the flagship cascade's predict path gives them (conv: max|d|/max|ref| <=
   1e-2 against f32 math on the same bf16 inputs rounded to bf16; IN+act <= 2
   bf16 ulp; 2x down/up <= 1 bf16 ulp), with CUDA-event times of both.
3. The slice: CASES synthetic 240x240x155 cases and seeded random ``cascade``
   weights saved as ``params.npz``, run through
   ``brats2019_tpu_torch.cli.predict`` on the card with the launch counters
   zeroed just before; outputs checked (shape, labels in {0,1,2,4}), every
   kernel launched (24 convs per volume), a repeat run bitwise equal, the
   kernel path held against the plain torch path on the CPU at a small
   input, and device ms/volume (CUDA events) and end-to-end s/volume timed.

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a CUDA device the script exits 1 before doing anything.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
CASES = 3   # synthetic 240x240x155 requests
SEED = 0    # of the cases and of the random weights

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
}
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


def check_kernels(calls, dev):
    """Each unique (kernel, shape) once: error against the plain version and
    both times. Returns {(name, shape): (err, max_abs_err, ms, plain_ms)}."""
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
            kern = lambda: norm.instance_norm_act_kernel(x, gam, bet)
            plain = lambda: norm.instance_norm_act_plain(x, gam, bet)
        else:
            x = torch.randn(shape, generator=g, device=dev).bfloat16()
            kfn = getattr(resize, f"{name}_kernel")
            pfn = getattr(resize, f"{name}_plain")
            kern = lambda: kfn(x)
            plain = lambda: pfn(x)
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        abs_err = (got.float() - ref.float()).abs().max().item()
        if name == "conv3d":
            err = abs_err / ref.float().abs().max().item()
            ok = err <= 1e-2
            what = f"max|d|/max|ref| {err:.3e} (tol 1e-2)"
        else:
            err = bf16_ulps(got, ref)
            tol = 2 if name == "instance_norm_act" else 1
            ok = err <= tol
            what = f"{err:.2f} bf16 ulp (tol {tol})"
        finite = bool(torch.isfinite(got.float()).all())
        reps = 3 if x.numel() > 1e8 else 10
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, reps)
        check(ok and finite and got.shape == ref.shape,
              f"{name} {shape}: {what}, max|d| {abs_err:.3e}, "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        results[(name, shape)] = (err, abs_err, ms, plain_ms)
        del x, got, ref
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
    print("== phase 2: kernels vs plain torch at the flagship shapes", flush=True)
    t0 = time.perf_counter()
    results = check_kernels(calls, dev)
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
    expect = {k: sum(1 for n, _ in calls if n == k) for k in KERNELS}
    print(f"  launches on the slice: {counts} ({per_vol} per volume; "
          f"expected per volume {expect})", flush=True)
    for k in KERNELS:
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

    record = []
    for k, (route, source, replaces) in KERNELS.items():
        mine = [(shape, results[(n, shape)]) for n, shape in calls if n == k]
        record.append({
            "name": k, "route": route, "source": source, "replaces": replaces,
            "launches": counts[k],
            "max_abs_err": max(r[1] for _, r in mine),
            # per volume: the main path's calls of this kernel, summed
            "ms": sum(r[2] for _, r in mine),
            "plain_ms": sum(r[3] for _, r in mine),
        })
    for r in record:
        print(f"  {r['name']}: {r['ms']:.3f} ms/vol in kernels vs "
              f"{r['plain_ms']:.3f} ms/vol plain torch on {card}", flush=True)
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
