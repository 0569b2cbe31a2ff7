#!/usr/bin/env python3
"""Standalone check of the PyTorch port's conv kernels on a CUDA card.

    timeout 300 python3 tools/torch_conv_check.py            # build + correctness
    timeout 600 python3 tools/torch_conv_check.py --time     # + times per shape
    timeout 600 python3 tools/torch_conv_check.py --probe    # + the fill probe
    timeout 600 python3 tools/torch_conv_check.py --winograd [--time] [--probe]
    timeout 600 python3 tools/torch_conv_check.py --f32 [--winograd] [--time]
        [--parent FILE] [--probe]

Without ``--winograd`` it checks the direct conv; with it, the Winograd conv
(see the end of this text).

Builds ``csrc/conv3d_wgmma.cu`` and ``csrc/conv3d.cu`` side by side (one nvcc
each), prints ptxas's report for the wgmma source, and holds every
(box depth, Co tile) instance of the wgmma kernel against ``conv3d_plain`` at
small shapes: ragged boxes, halos at every face, N > 1, Co tails, Ci tails in
a chunk, many chunks. On a mismatch it repeats the shape with one-tap weights
and prints which taps, planes and columns are off. A wrong barrier phase traps
inside the kernel once a wait has lasted 20 s; run under ``timeout`` all the
same.

``--time``: device ms (CUDA-graph replay) of the planner's instance, the other
wgmma instances, the mma.sync kernel and cuDNN's bf16 conv at the flagship
shapes, with the achieved TFLOP/s. ``--probe``: the mma.sync kernel built with
its products removed (-DCONV3D_LOADS_ONLY), to read how much of its time the
shared-memory fills alone take.

``--winograd``: builds ``csrc/winograd3d_wgmma.cu`` and ``csrc/winograd3d.cu``,
prints ptxas's report for the first (registers, spills), checks its shared
memory against the planner's, and holds both against ``conv3d_winograd_plain``
at small shapes (ragged bricks, N > 1, Ci tails in a chunk, Co tails, many
chunks; tolerance 2e-2 of max|ref|, a repeat run bitwise equal). With
``--time``: device ms of the wgmma instance, the mma.sync instance, the direct
conv kernel and cuDNN at every conv shape of the flagship predict path, and
their sums per volume. With ``--probe``: the mma.sync instance built without
its products (-DWINOGRAD_NO_PRODUCTS) and without its transforms
(-DWINOGRAD_NO_TRANSFORMS).

``--f32``: the f32 FFMA instance of ``csrc/conv3d.cu`` (with ``--winograd``,
of ``csrc/winograd3d.cu``): ptxas's registers and spills for its kernels, then
held against ``conv3d_plain`` (the Winograd also against
``conv3d_winograd_plain``) within 1e-5 of max|ref| at small ragged shapes and
at every f32 conv shape (the accuracy config's tile batch, ``smoke`` and
``unit`` train steps, forward and dgrad), every box depth of the direct
instance, a repeat run bitwise equal, launches on ``launches_f32``, and the
planner's shared-memory bytes equal to the kernel's. ``--time``: device ms
per shape and sums per tile batch and train step beside cuDNN's f32 conv
(TF32 off) and the bound; ``--parent FILE`` (the parent's ``.cu``, whose
f32 entry point takes the plan's box depth, Co tile and slab, e.g. from
``git show HEAD:brats2019_tpu_torch/csrc/conv3d.cu``) also times the parent's
f32 entry point on the same inputs in turns (parent, this, this, parent).
``--probe``: probe builds timed beside the instance as built: the direct
conv without its products (-DCONV3D_F32_FILLS_ONLY), without its stores
(-DCONV3D_F32_NO_STORE) and with its registers capped
(-DCONV3D_F32_MAXNREG), with the blocks that fit on an SM per shape; the
Winograd without the making of V, the products or A^T
(-DWINOGRAD_F32_PROBE).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from brats2019_tpu_torch.ops import _build, conv, winograd  # noqa: E402
from brats2019_tpu_torch.configs.presets import get_preset  # noqa: E402
from chip_smoke import device_ms, unet_calls  # noqa: E402  (graph-replay timing)

INSTANCES = conv.WGMMA_INSTANCES
SMALL = [
    # (N, D, H, W, Ci), Co
    ((1, 8, 8, 8, 16), 64),        # one box, one k-step
    ((1, 8, 8, 8, 64), 64),        # one whole chunk
    ((1, 5, 6, 7, 16), 16),        # ragged box smaller than 8 x 8
    ((2, 9, 3, 13, 32), 24),       # N = 2, ragged on every axis
    ((1, 12, 14, 10, 96), 192),    # the coarse net's deepest level: a Ci tail
    ((1, 6, 7, 5, 48), 48),        # Co = 48 tail, one 48-channel chunk
    ((1, 16, 16, 16, 144), 96),    # 64 + 64 + 16 channels, Co = 96 tail
    ((2, 8, 16, 24, 192), 320),    # three chunks, five 64-wide Co tiles
    ((1, 4, 8, 8, 576), 256),      # nine chunks: the ring wraps many times
]


def flagship_shapes():
    """((N, D, H, W, Ci), Co) of every conv of the flagship cascade's predict
    path (coarse net b1, fine net b8), plus one dgrad of the fine train step."""
    exp = get_preset("cascade")
    calls = (unet_calls(exp.coarse_unet, 1, exp.infer.coarse_shape)
             + unet_calls(exp.unet, 8, exp.infer.roi_shape))
    shapes = [sh for name, sh in calls if name == "conv3d"]
    shapes.append((1, 64, 64, 64, 64, 192))
    return [(sh[:5], sh[5]) for sh in dict.fromkeys(shapes)]


def make(shape, co, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    w = (torch.randn((3, 3, 3, shape[-1], co), generator=g, device=dev)
         / (27 * shape[-1]) ** 0.5).bfloat16()
    return x, w


def rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def diagnose(x, w, plan):
    """One-tap weights: which taps, d-planes and output columns disagree."""
    for tap in range(27):
        w1 = torch.zeros_like(w)
        w1[tap // 9, (tap // 3) % 3, tap % 3] = w[tap // 9, (tap // 3) % 3, tap % 3]
        got = conv.conv3d_kernel_wgmma(x, w1, plan).float()
        ref = conv.conv3d_plain(x, w1).float()
        torch.cuda.synchronize()
        bad = (got - ref).abs() > 1e-2 * ref.abs().max()
        if bad.any():
            idx = bad.nonzero()
            print(f"    tap {tap}: {int(bad.sum())} of {bad.numel()} off; "
                  f"first {idx[0].tolist()}, d {sorted(set(idx[:, 1].tolist()))[:8]}, "
                  f"h {sorted(set(idx[:, 2].tolist()))[:8]}, "
                  f"w {sorted(set(idx[:, 3].tolist()))[:8]}, "
                  f"co {sorted(set(idx[:, 4].tolist()))[:8]}", flush=True)
        else:
            print(f"    tap {tap}: ok", flush=True)


def check_small(dev) -> int:
    failures = 0
    for shape, co in SMALL:
        x, w = make(shape, co, dev)
        ref = conv.conv3d_plain(x, w)
        auto = conv.plan_conv(*shape, co)
        for bd, bn in INSTANCES:
            plan = conv.wgmma_plan(*shape, co, bd, bn)
            got = conv.conv3d_kernel_wgmma(x, w, plan)
            again = conv.conv3d_kernel_wgmma(x, w, plan)
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            same = bool(torch.equal(got, again))
            ok = err <= 1e-2 and same and bool(torch.isfinite(got.float()).all())
            mark = " (the planner's)" if (plan.box[0], plan.bn) == (auto.box[0], auto.bn) else ""
            print(f"  [{'PASS' if ok else 'FAIL'}] {shape}->{co} box {bd}x8x8 "
                  f"bn {bn}{mark}: max|d|/max|ref| {err:.3e}, repeat bitwise "
                  f"{same}, grid {plan.grid}", flush=True)
            if not ok:
                failures += 1
                if failures <= 2:
                    diagnose(x, w, plan)
        old = conv.conv3d_kernel_mma_sync(x, w)
        torch.cuda.synchronize()
        print(f"         mma.sync kernel {rel_err(old, ref):.3e}", flush=True)
    return failures


def time_shapes(dev, card) -> None:
    print(f"== times on {card} (device ms, CUDA-graph replay)", flush=True)
    tot = {}
    worst = (0.0, None)
    for shape, co in flagship_shapes():
        x, w = make(shape, co, dev)
        reps = 3 if x.numel() > 1e8 else 10
        flops = 2.0 * 27 * shape[-1] * co * x.numel() / shape[-1]
        auto = conv.plan_conv(*shape, co)
        row = {}
        for bd, bn in INSTANCES:
            plan = conv.wgmma_plan(*shape, co, bd, bn)
            row[f"{bd}/{bn}"] = device_ms(
                lambda: conv.conv3d_kernel_wgmma(x, w, plan), reps)
        row["mma.sync"] = device_ms(lambda: conv.conv3d_kernel_mma_sync(x, w), reps)
        xc = x.permute(0, 4, 1, 2, 3)
        wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        with torch.no_grad():
            row["cudnn"] = device_ms(lambda: F.conv3d(xc, wc, padding=1), reps)
        mine = row[f"{auto.box[0]}/{auto.bn}"]
        best = min(row[f"{bd}/{bn}"] for bd, bn in INSTANCES)
        tot["fastest instance"] = tot.get("fastest instance", 0.0) + best
        worst = max(worst, (mine / best, (shape, co)))
        for k, v in row.items():
            tot[k] = tot.get(k, 0.0) + v
        tot["planner"] = tot.get("planner", 0.0) + mine
        print(f"  {shape}->{co}: planner {auto.box[0]}/{auto.bn} {mine:.4f} ms "
              f"= {flops / mine / 1e9:.0f} TFLOP/s "
              f"({100 * flops / mine / 1e9 / 989:.1f}% of 989), "
              f"{auto.flop_per_filled_byte:.0f} flop/filled byte; "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    print("  sums over these shapes: "
          + ", ".join(f"{k} {v:.3f}" for k, v in tot.items()), flush=True)
    # how well _INSTANCE_COST's weights still describe the card
    print(f"  the planner's choices take {tot['planner'] / tot['fastest instance']:.3f}x "
          f"the fastest instances' sum; farthest at {worst[1]}: {worst[0]:.2f}x",
          flush=True)


def probe(dev, card) -> None:
    """The mma.sync kernel with its products removed: fills, barriers and the
    epilogue alone."""
    sig = {"conv3d_ndhwc_bf16": conv._SIG["conv3d_ndhwc_bf16"]}
    lib = _build.load_library("conv3d_loads_only", ["conv3d.cu"], sig,
                              extra_flags=("-DCONV3D_LOADS_ONLY",))
    print(f"== fill probe on {card}: conv3d.cu as built, and with the "
          f"products removed (device ms)", flush=True)
    # the fine net's two largest levels, where the time is
    for shape, co in (sc for sc in flagship_shapes()
                      if sc[0][0] == 8 and sc[0][1] >= 32):
        x, w = make(shape, co, dev)
        y = torch.empty(shape[:4] + (co,), dtype=x.dtype, device=dev)

        def loads_only():
            rc = lib.conv3d_ndhwc_bf16(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), *shape, co,
                torch.cuda.current_stream().cuda_stream)
            _build.check(rc, "conv3d (loads only)")

        reps = 3
        full = device_ms(lambda: conv.conv3d_kernel_mma_sync(x, w), reps)
        fills = device_ms(loads_only, reps)
        m = x.numel() // shape[-1]
        chunks = 27 * -(-shape[-1] // 32)
        filled = -(-m // 128) * -(-co // 64) * chunks * (128 + 64) * 32 * 2
        print(f"  {shape}->{co}: whole {full:.4f} ms, fills alone {fills:.4f} ms "
              f"({100 * fills / full:.0f}%); {filled / 1e9:.2f} GB filled = "
              f"{filled / fills / 1e9:.2f} TB/s with the products removed, "
              f"{filled / full / 1e9:.2f} TB/s as built", flush=True)


# ------------------------------------------------------------ the Winograd conv --

WINO_TOL = 2e-2
WINO_SMALL = [
    # (N, D, H, W, Ci), Co; D, H, W even
    ((1, 8, 8, 8, 16), 8),         # one brick, half a chunk, one 8-channel group
    ((1, 8, 8, 8, 32), 64),        # one brick, one whole chunk, a whole Co tile
    ((1, 8, 8, 8, 64), 32),        # two chunks, one consumer half of N masked
    ((1, 12, 14, 10, 96), 192),    # the coarse net's deepest level: ragged bricks
    ((2, 6, 4, 18, 48), 40),       # N = 2, a Ci tail in a chunk, a Co tail
    ((1, 16, 16, 16, 144), 96),    # 8 bricks, 4.5 chunks, Co tail in the 2nd tile
    ((2, 24, 28, 20, 32), 48),     # 72 bricks, ragged on every axis
    ((1, 4, 8, 8, 576), 256),      # 18 chunks: the rings wrap many times
    ((1, 64, 64, 64, 32), 64),     # 512 bricks on 132 blocks: persistent walk
]


def predict_conv_calls():
    """((N, D, H, W, Ci), Co) -> calls per volume on the flagship predict path."""
    exp = get_preset("cascade")
    calls = (unet_calls(exp.coarse_unet, 1, exp.infer.coarse_shape)
             + unet_calls(exp.unet, 8, exp.infer.roi_shape))
    return collections.Counter((sh[:5], sh[5]) for name, sh in calls
                               if name == "conv3d")


def wino_check_small(dev) -> int:
    failures = 0
    for shape, co in WINO_SMALL:
        x, w = make(shape, co, dev)
        ref = winograd.conv3d_winograd_plain(x, w)
        plan = winograd.plan_winograd(*shape, co)
        for which, fn in (("wgmma", winograd.conv3d_winograd_kernel),
                          ("mma.sync", winograd.conv3d_winograd_kernel_mma_sync)):
            got = fn(x, w)
            again = fn(x, w)
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            same = bool(torch.equal(got, again))
            ok = (err <= WINO_TOL and same
                  and bool(torch.isfinite(got.float()).all()))
            failures += not ok
            print(f"  [{'PASS' if ok else 'FAIL'}] {which} {shape}->{co}: "
                  f"max|d|/max|ref| {err:.3e} (tol {WINO_TOL:g}), repeat bitwise "
                  f"{same}; plan {plan.instance}, {plan.grid} (brick, Co tile) "
                  f"pairs on {plan.blocks} blocks, fill {plan.fill:.2f}",
                  flush=True)
            if not ok and which == "wgmma":
                bad = ((got.float() - ref.float()).abs()
                       > WINO_TOL * ref.float().abs().max())
                idx = bad.nonzero()
                print(f"    {int(bad.sum())} of {bad.numel()} off; first "
                      f"{idx[0].tolist()}; d {sorted(set(idx[:, 1].tolist()))[:10]}, "
                      f"h {sorted(set(idx[:, 2].tolist()))[:10]}, "
                      f"w {sorted(set(idx[:, 3].tolist()))[:10]}, "
                      f"co {sorted(set(idx[:, 4].tolist()))[:12]}", flush=True)
    return failures


def wino_time(dev, card) -> None:
    print(f"== Winograd times on {card} (device ms, CUDA-graph replay): wgmma "
          f"instance, mma.sync instance, direct conv kernel, cuDNN", flush=True)
    tot = collections.Counter()
    for (shape, co), count in predict_conv_calls().items():
        x, w = make(shape, co, dev)
        reps = 3 if x.numel() > 1e8 else 10
        m = x.numel() // shape[-1]
        macs = 8.0 * shape[-1] * co * m
        nbytes = 2.0 * (x.numel() + 27 * shape[-1] * co + m * co)
        bound = max(nbytes / 3.35e12, 2 * macs / 989e12) * 1e3
        row = {
            "wgmma": device_ms(lambda: winograd.conv3d_winograd_kernel(x, w), reps),
            "mma.sync": device_ms(
                lambda: winograd.conv3d_winograd_kernel_mma_sync(x, w), reps),
            "direct": device_ms(lambda: conv.conv3d_kernel(x, w), reps),
        }
        xc = x.permute(0, 4, 1, 2, 3)
        wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        with torch.no_grad():
            row["cudnn"] = device_ms(lambda: F.conv3d(xc, wc, padding=1), reps)
        row["bound"] = bound
        plan = winograd.plan_winograd(*shape, co)
        for k, v in row.items():
            tot[k] += count * v
        print(f"  {shape}->{co} x{count}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f"; products {2 * macs / row['wgmma'] / 1e9:.0f} TFLOP/s "
              f"({100 * 2 * macs / row['wgmma'] / 1e9 / 989:.1f}% of 989), "
              f"{plan.grid} pairs / {plan.blocks} blocks, fill {plan.fill:.2f}",
              flush=True)
    print("  sums per volume (24 convs): "
          + ", ".join(f"{k} {v:.3f}" for k, v in tot.items()), flush=True)


def wino_probe(dev, card) -> None:
    """The mma.sync Winograd kernel as built, without its products, without
    its transforms."""
    sig = {"winograd3d_ndhwc_bf16": winograd._SIG["winograd3d_ndhwc_bf16"]}
    libs = {
        "no products": _build.load_library(
            "winograd3d_no_products", ["winograd3d.cu"], sig,
            extra_flags=("-DWINOGRAD_NO_PRODUCTS",)),
        "no transforms": _build.load_library(
            "winograd3d_no_transforms", ["winograd3d.cu"], sig,
            extra_flags=("-DWINOGRAD_NO_TRANSFORMS",)),
        "neither": _build.load_library(
            "winograd3d_neither", ["winograd3d.cu"], sig,
            extra_flags=("-DWINOGRAD_NO_PRODUCTS", "-DWINOGRAD_NO_TRANSFORMS")),
    }
    print(f"== probe on {card}: winograd3d.cu as built, without the U loads and "
          f"products, without the two transforms, with neither (device ms)",
          flush=True)
    for (shape, co), _ in predict_conv_calls().items():
        if shape[0] != 8 or shape[1] < 32:
            continue            # the fine net's two largest levels
        x, w = make(shape, co, dev)
        u = winograd.padded_u(w)
        y = torch.empty(shape[:4] + (co,), dtype=x.dtype, device=dev)
        row = {"whole": device_ms(
            lambda: winograd.conv3d_winograd_kernel_mma_sync(x, w), 3)}
        for name, lib in libs.items():
            def run(lib=lib):
                rc = lib.winograd3d_ndhwc_bf16(
                    x.data_ptr(), u.data_ptr(), y.data_ptr(), *shape, co,
                    u.shape[1], u.shape[2],
                    torch.cuda.current_stream().cuda_stream)
                _build.check(rc, "winograd3d probe")
            row[name] = device_ms(run, 3)
        print(f"  {shape}->{co}: "
              + ", ".join(f"{k} {v:.4f} ms ({100 * v / row['whole']:.0f}%)"
                          for k, v in row.items()), flush=True)


def wino_probe_wgmma(dev, card) -> None:
    """The wgmma Winograd kernel as built and with one or two of its four
    kinds of work left out (-DWINOGRAD_PROBE=bits)."""
    variants = {"no copies": 1, "no V": 2, "no products": 4, "no A^T": 8,
                "no V, no A^T": 10, "none of the four": 15}
    sig = {"winograd3d_wgmma_ndhwc_bf16":
           winograd._SIG_WGMMA["winograd3d_wgmma_ndhwc_bf16"]}
    libs = {}

    def loader(name, bits):
        def load():
            libs[name] = _build.load_library(
                f"winograd3d_wgmma_probe{bits}", ["winograd3d_wgmma.cu"], sig,
                extra_flags=(f"-DWINOGRAD_PROBE={bits}",))
        return load

    _build.build_all([loader(n, b) for n, b in variants.items()])
    print(f"== probe on {card}: winograd3d_wgmma.cu as built and with work "
          f"left out (device ms)", flush=True)
    for shape, co in (((8, 64, 64, 64, 64), 64), ((8, 64, 64, 64, 192), 64),
                      ((8, 32, 32, 32, 128), 128), ((8, 16, 16, 16, 256), 256)):
        x, w = make(shape, co, dev)
        u = winograd.padded_u(w)
        y = torch.empty(shape[:4] + (co,), dtype=x.dtype, device=dev)
        plan = winograd.plan_winograd(*shape, co)
        row = {"whole": device_ms(
            lambda: winograd.conv3d_winograd_kernel(x, w), 3)}
        for name in variants:
            def run(lib=libs[name]):
                rc = lib.winograd3d_wgmma_ndhwc_bf16(
                    x.data_ptr(), u.data_ptr(), y.data_ptr(), *shape, co,
                    u.shape[1], u.shape[2], plan.blocks,
                    torch.cuda.current_stream().cuda_stream)
                _build.check(rc, "winograd3d_wgmma probe")
            row[name] = device_ms(run, 3)
        print(f"  {shape}->{co}: "
              + ", ".join(f"{k} {v:.4f} ms ({100 * v / row['whole']:.0f}%)"
                          for k, v in row.items()), flush=True)


def main_winograd(args, dev, card) -> int:
    t0 = time.perf_counter()
    _build.build_all([winograd._lib_wgmma, winograd._lib, conv._lib_wgmma])
    print(f"built winograd3d_wgmma.cu, winograd3d.cu and conv3d_wgmma.cu in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print("ptxas, winograd3d_wgmma:\n"
          + _build.build_logs.get("winograd3d_wgmma", "(cached)"), flush=True)
    have = winograd._lib_wgmma().winograd3d_wgmma_smem_bytes()
    want = winograd.wgmma_smem_bytes()
    ok = have == want and want <= winograd.SMEM_LIMIT
    failures = int(not ok)
    print(f"  [{'PASS' if ok else 'FAIL'}] shared memory: kernel {have}, planner "
          f"{want} bytes (limit {winograd.SMEM_LIMIT})", flush=True)
    if args.probe:      # first: it does not depend on the new kernel
        wino_probe(dev, card)
    failures += wino_check_small(dev)
    if args.probe:
        wino_probe_wgmma(dev, card)
    if args.time:
        wino_time(dev, card)
    print(f"{failures} failure(s)", flush=True)
    return 1 if failures else 0


# ------------------------------------------------------------ the f32 instances --

F32_TOL = 1e-5
F32_SMALL = [
    # (N, D, H, W, Ci), Co
    ((1, 1, 3, 1, 3), 5),          # size-1 axes, scalar loads (Ci % 4 != 0)
    ((2, 9, 7, 13, 12), 20),       # N = 2, ragged boxes, a Co tile of 20
    ((1, 5, 6, 7, 4), 4),          # one ragged box, the narrowest tile
    ((2, 6, 10, 4, 8), 3),         # Co < 4: a masked tail in one 4-wide tile
    ((1, 4, 4, 4, 6), 12),         # Ci % 4 != 0 with a 12-wide tile
    ((1, 12, 14, 10, 24), 64),     # one 64-wide tile
    ((1, 16, 16, 16, 48), 12),     # Ci in slabs
    ((1, 8, 8, 8, 80), 136),       # slabs, three Co tiles of 48 (a tail of 8)
]
F32_WINO_SMALL = [
    # (N, D, H, W, Ci), Co; D, H, W even
    ((3, 2, 2, 2, 5), 3),          # one tile a sample, scalar channels
    ((2, 12, 14, 10, 24), 40),     # ragged bricks, two Co tiles of 20
    ((1, 16, 16, 16, 48), 24),     # the whole raw patch, chunks of Ci
    ((1, 8, 8, 8, 80), 136),       # the raw patch a chunk at a time, 5 Co tiles
    ((1, 6, 10, 4, 12), 20),       # Ci 12, Co 20
    ((2, 4, 6, 18, 8), 32),        # a 32-wide tile (512 threads)
]


def f32_calls():
    """{what: [((N, D, H, W, Ci), Co), ...]} of the f32 configurations'
    convs, one entry a call: the accuracy config's tile batch (forward), one
    ``smoke`` and one ``unit`` train step (forward and dgrad)."""
    from chip_smoke import accuracy_exp, train_calls

    acc = accuracy_exp()
    smoke, unit = get_preset("smoke"), get_preset("unit")
    out = {"accuracy tile batch (8, 32^3)": unet_calls(acc.unet, 8, acc.infer.tile),
           "smoke train step (1, 64^3)": train_calls(smoke.unet, 1, smoke.train.patch),
           "unit train step (1, 16^3)": train_calls(unit.unet, 1, unit.train.patch)}
    return {k: [(sh[:5], sh[5]) for name, sh in v if name == "conv3d"]
            for k, v in out.items()}


def make_f32(shape, co, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev)
    w = torch.randn((3, 3, 3, shape[-1], co), generator=g, device=dev) / (27 * shape[-1]) ** 0.5
    return x, w


def f32_check(dev, winograd_too: bool) -> int:
    """Every f32 instance (the direct conv at each box depth the planner
    may choose; with ``winograd_too`` the Winograd) against its plain
    version at small ragged shapes and every f32 conv shape: within 1e-5 of
    max|ref|, a repeat run bitwise equal, launches on ``launches_f32``, the
    planner's shared memory equal to the kernel's."""
    lib = winograd._lib() if winograd_too else conv._lib()
    shapes = (F32_WINO_SMALL if winograd_too else F32_SMALL) + list(
        dict.fromkeys(c for v in f32_calls().values() for c in v))
    failures = 0
    for shape, co in shapes:
        x, w = make_f32(shape, co, dev)
        if winograd_too:
            plan = winograd.plan_winograd(*shape, co, dtype=torch.float32)
            have = lib.winograd3d_f32_smem_bytes(plan.raw_channels, plan.bn, plan.chunk)
            ref = winograd.conv3d_winograd_plain(x, w)
            direct = conv.conv3d_plain(x, w)
            variants = [("", plan, lambda: winograd.conv3d_winograd_kernel(x, w))]
            wrapper = winograd.conv3d_winograd
        else:
            plan = conv.plan_conv(*shape, co, dtype=torch.float32)
            have = lib.conv3d_f32_smem_bytes(plan.box[0], plan.bn, plan.chunk)
            ref = direct = conv.conv3d_plain(x, w)
            variants = [("", plan, lambda: conv.conv3d_kernel(x, w))]
            for bd in conv.F32_BOX_DEPTHS:
                ct = conv.f32_co_tile(co)
                if bd != plan.box[0] and conv.f32_threads(bd, ct) <= conv.F32_MAX_THREADS:
                    p2 = conv.f32_plan(*shape, co, bd=bd)
                    variants.append((" (forced box depth)", p2,
                                     lambda p2=p2: conv.conv3d_kernel_f32(x, w, p2)))
            wrapper = conv.conv3d
        for label, plan, fn in variants:
            if not winograd_too:
                have = lib.conv3d_f32_smem_bytes(plan.box[0], plan.bn, plan.chunk)
            before = (wrapper.launches, wrapper.launches_f32)
            got, again = fn(), fn()
            torch.cuda.synchronize()
            took = (wrapper.launches - before[0], wrapper.launches_f32 - before[1])
            err, err_direct = rel_err(got, ref), rel_err(got, direct)
            same = bool(torch.equal(got, again))
            ok = (err <= F32_TOL and err_direct <= F32_TOL and same
                  and took == (2, 2) and have == plan.smem_bytes
                  and bool(torch.isfinite(got).all()))
            failures += not ok
            print(f"  [{'PASS' if ok else 'FAIL'}] {shape}->{co}{label or ' (plan)'}: "
                  f"max|d|/max|ref| {err:.3e}, against the direct conv "
                  f"{err_direct:.3e} (tol {F32_TOL:g}), repeat bitwise {same}, "
                  f"launches (all, f32) {took}; plan box "
                  f"{getattr(plan, 'box', None) or plan.brick} Co tile "
                  f"{plan.bn} chunk {plan.chunk} grid {plan.grid}, shared memory "
                  f"kernel {have} planner {plan.smem_bytes}", flush=True)
            if not ok and failures <= 3:
                bad = (got - ref).abs() > F32_TOL * ref.abs().max()
                idx = bad.nonzero()
                if len(idx):
                    print(f"    {int(bad.sum())} of {bad.numel()} off; first "
                          f"{idx[0].tolist()}; d {sorted(set(idx[:, 1].tolist()))[:10]}, "
                          f"h {sorted(set(idx[:, 2].tolist()))[:10]}, "
                          f"w {sorted(set(idx[:, 3].tolist()))[:10]}, "
                          f"co {sorted(set(idx[:, 4].tolist()))[:12]}", flush=True)
    return failures


def parent_f32(path: str, winograd_too: bool):
    """The parent's f32 entry point, built from ``path`` (its ``.cu``), with
    the signature and plan the tree's has: (x, w, y, N, D, H, W, Ci, Co,
    box_d, co_tile, slab, stream), or for the Winograd (x, padded U, y, N,
    D, H, W, Ci, Co, CiP, CoP, co_tile, chunk, raw_channels, stream). Its
    shared-memory attribute is set when it loads."""
    if winograd_too:
        name, fn, prep, sigs = ("parent_winograd3d", "winograd3d_ndhwc_f32",
                                "winograd3d_f32_prepare", winograd._SIG)
    else:
        name, fn, prep, sigs = ("parent_conv3d", "conv3d_ndhwc_f32",
                                "conv3d_f32_prepare", conv._SIG)
    sig = {k: sigs[k] for k in (fn, prep)}
    return getattr(_build.load_library(name, [os.path.abspath(path)], sig,
                                       prepare=prep), fn)


def f32_time(dev, card, winograd_too: bool, parent_path) -> None:
    """Device ms (CUDA-graph replay) of the new f32 instance at every f32 conv
    shape, with ``parent_path`` the parent's in turns (parent, this, this,
    parent), beside cuDNN's f32 conv (TF32 off) and the bound; sums per
    accuracy tile batch, smoke and unit train step."""
    parent = parent_f32(parent_path, winograd_too) if parent_path else None
    kind = "Winograd" if winograd_too else "direct"
    print(f"== f32 {kind} conv on {card} (device ms, CUDA-graph replay)", flush=True)
    timed = {}
    for shape, co in dict.fromkeys(c for v in f32_calls().values() for c in v):
        x, w = make_f32(shape, co, dev)
        y = torch.empty(shape[:4] + (co,), device=dev)
        stream = lambda: torch.cuda.current_stream().cuda_stream
        if winograd_too:
            mine = lambda: winograd.conv3d_winograd_kernel(x, w)
            if parent is not None:
                plan = winograd.plan_winograd(*shape, co, dtype=torch.float32)
                u = winograd.padded_u(w)

                def old():
                    _build.check(parent(x.data_ptr(), u.data_ptr(), y.data_ptr(),
                                        *shape, co, u.shape[1], u.shape[2], plan.bn,
                                        plan.chunk, plan.raw_channels, stream()),
                                 "parent")
        else:
            mine = lambda: conv.conv3d_kernel(x, w)
            if parent is not None:
                plan = conv.plan_conv(*shape, co, dtype=torch.float32)

                def old():
                    _build.check(parent(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                        *shape, co, plan.box[0], plan.bn, plan.chunk,
                                        stream()), "parent")
        row = {}
        if parent is not None:
            old()
            torch.cuda.synchronize()
            ref = (winograd.conv3d_winograd_plain if winograd_too else conv.conv3d_plain)(x, w)
            parent_err = rel_err(y, ref)
            t = [device_ms(f, 10) for f in (old, mine, mine, old)]
            row["parent"], row["this"] = min(t[0], t[3]), min(t[1], t[2])
        else:
            parent_err = None
            row["this"] = device_ms(mine, 10)
        xc = x.permute(0, 4, 1, 2, 3)
        wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        with torch.no_grad():
            row["cudnn"] = device_ms(lambda: F.conv3d(xc, wc, padding=1), 10)
        m = x.numel() // shape[-1]
        macs = (8 if winograd_too else 27) * shape[-1] * co * m
        nbytes = 4.0 * (x.numel() + 27 * shape[-1] * co + m * co)
        row["bound"] = max(nbytes / 3.35e12, 2 * macs / 67e12) * 1e3
        timed[(shape, co)] = row
        plan = (winograd.plan_winograd(*shape, co, dtype=torch.float32) if winograd_too
                else conv.plan_conv(*shape, co, dtype=torch.float32))
        occ = "" if winograd_too else ", %d blocks an SM" % conv._lib(
        ).conv3d_f32_blocks_per_sm(plan.box[0], plan.bn, plan.chunk)
        print(f"  {shape}->{co}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f"; {2 * macs / row['this'] / 1e9:.1f} TFLOP/s of its products "
              f"({100 * 2 * macs / row['this'] / 1e9 / 67:.1f}% of 67); plan "
              f"Co tile {plan.bn} chunk {plan.chunk} grid {plan.grid}{occ}"
              + (f"; parent's max|d|/max|ref| {parent_err:.3e}" if parent_err is not None else ""),
              flush=True)
    for what, calls in f32_calls().items():
        tot = collections.Counter()
        for c in calls:
            for k, v in timed[c].items():
                tot[k] += v
        print(f"  sums per {what}, {len(calls)} calls: "
              + ", ".join(f"{k} {v:.4f}" for k, v in tot.items())
              + (f"; this / parent {tot['this'] / tot['parent']:.3f}" if "parent" in tot else "")
              + f"; this / cuDNN {tot['this'] / tot['cudnn']:.3f}; this / bound "
              f"{tot['this'] / tot['bound']:.1f}", flush=True)


def f32_variants(dev, card, winograd_too: bool) -> None:
    """The f32 instance as built beside probe builds of the same source:
    the direct conv without its products (fills and stores), without its
    products and stores, without its stores, and with its registers capped;
    the Winograd without the making of V, the products, A^T, or all three.
    Device ms summed over the accuracy tile batch and the smoke train
    step."""
    if winograd_too:
        source, fn = "winograd3d.cu", "winograd3d_ndhwc_f32"
        sig = {k: winograd._SIG[k] for k in (fn, "winograd3d_f32_prepare")}
        prepare = "winograd3d_f32_prepare"
        variants = {"no V": ("-DWINOGRAD_F32_PROBE=1",),
                    "no products": ("-DWINOGRAD_F32_PROBE=2",),
                    "no A^T": ("-DWINOGRAD_F32_PROBE=4",),
                    "fills and barriers only": ("-DWINOGRAD_F32_PROBE=7",)}
    else:
        source, fn = "conv3d.cu", "conv3d_ndhwc_f32"
        sig = {k: conv._SIG[k] for k in (fn, "conv3d_f32_prepare")}
        prepare = "conv3d_f32_prepare"
        variants = {"fills and stores": ("-DCONV3D_F32_FILLS_ONLY",),
                    "fills alone": ("-DCONV3D_F32_FILLS_ONLY", "-DCONV3D_F32_NO_STORE"),
                    "fills and products": ("-DCONV3D_F32_NO_STORE",)}
        variants.update({f"at most {r} registers": (f"-DCONV3D_F32_MAXNREG={r}",)
                         for r in (64, 80, 96)})
    libs = {}

    def loader(i, name, flags):
        def load():
            try:
                libs[name] = _build.load_library(
                    f"{source[:-3]}_variant_{i}", [source], sig, extra_flags=flags,
                    prepare=prepare)
            except RuntimeError as e:      # a probe that does not build is skipped
                print(f"  {name}: did not build: {str(e)[-600:]}", flush=True)
        return load

    _build.build_all([loader(i, k, v) for i, (k, v) in enumerate(variants.items())])
    print(f"== f32 {'Winograd' if winograd_too else 'direct'} probe builds on "
          f"{card} (device ms summed per unit)", flush=True)
    calls = f32_calls()
    for what in ("accuracy tile batch (8, 32^3)", "smoke train step (1, 64^3)"):
        tot = collections.Counter()
        for shape, co in calls[what]:
            x, w = make_f32(shape, co, dev)
            y = torch.empty(shape[:4] + (co,), device=dev)
            stream = lambda: torch.cuda.current_stream().cuda_stream
            if winograd_too:
                plan = winograd.plan_winograd(*shape, co, dtype=torch.float32)
                u = winograd.padded_u(w)
                args = lambda: (x.data_ptr(), u.data_ptr(), y.data_ptr(), *shape, co,
                                u.shape[1], u.shape[2], plan.bn, plan.chunk,
                                plan.raw_channels, stream())
                tot["as built"] += device_ms(lambda: winograd.conv3d_winograd_kernel(x, w), 10)
            else:
                plan = conv.plan_conv(*shape, co, dtype=torch.float32)
                args = lambda: (x.data_ptr(), w.data_ptr(), y.data_ptr(), *shape, co,
                                plan.box[0], plan.bn, plan.chunk, stream())
                tot["as built"] += device_ms(lambda: conv.conv3d_kernel(x, w), 10)
            for name, lib in libs.items():
                f = getattr(lib, fn)
                tot[name] += device_ms(lambda f=f: _build.check(f(*args()), name), 10)
        print(f"  per {what}: " + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()),
              flush=True)
    for name, log in _build.build_logs.items():
        if "_variant_" in name:
            regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
            print(f"  ptxas {name}: " + "; ".join(regs[:2]), flush=True)


def ptxas_report(log: str, marker: str) -> str:
    """ptxas's lines for the kernels whose mangled name holds ``marker``."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and marker in line:
            out.extend(lines[i:i + 4])
    return "\n".join(out) or "(cached: no ptxas report)"


def main_f32(args, dev, card) -> int:
    t0 = time.perf_counter()
    lib = winograd._lib if args.winograd else conv._lib
    _build.build_all([lib])
    name = "winograd3d" if args.winograd else "conv3d"
    print(f"built {name}.cu in {time.perf_counter() - t0:.1f} s", flush=True)
    marker = "winograd_f32_kernel" if args.winograd else "conv3d_f32_kernel"
    print(f"ptxas, {marker}:\n" + ptxas_report(_build.build_logs.get(name, ""), marker),
          flush=True)
    failures = f32_check(dev, args.winograd)
    if args.probe:
        f32_variants(dev, card, args.winograd)
    if args.time:
        f32_time(dev, card, args.winograd, args.parent)
    print(f"{failures} failure(s)", flush=True)
    return 1 if failures else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--winograd", action="store_true",
                    help="check the Winograd conv kernels instead of the direct")
    ap.add_argument("--f32", action="store_true",
                    help="check the f32 instances (with --winograd, the Winograd's)")
    ap.add_argument("--parent", help="with --f32 --time: the parent's conv3d.cu "
                    "(or winograd3d.cu with --winograd) to time beside, in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-2:]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {'; '.join(nvcc)}; card: {card}", flush=True)
    if args.f32:
        return main_f32(args, dev, card)
    if args.winograd:
        return main_winograd(args, dev, card)
    t0 = time.perf_counter()
    _build.build_all([conv._lib_wgmma, conv._lib])
    print(f"built conv3d_wgmma.cu and conv3d.cu in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print("ptxas, conv3d_wgmma:\n" + _build.build_logs.get("conv3d_wgmma", "(cached)"),
          flush=True)
    lib = conv._lib_wgmma()
    failures = 0
    for bd, bn in INSTANCES:
        have, want = lib.conv3d_wgmma_smem_bytes(bd, bn), conv.wgmma_smem_bytes(bd, bn)
        ok = have == want and want <= conv.SMEM_LIMIT
        failures += not ok
        print(f"  [{'PASS' if ok else 'FAIL'}] shared memory of box {bd}x8x8 bn "
              f"{bn}: kernel {have}, planner {want} bytes", flush=True)
    failures += check_small(dev)
    if args.probe:
        probe(dev, card)
    if args.time:
        time_shapes(dev, card)
    print(f"{failures} failure(s)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
