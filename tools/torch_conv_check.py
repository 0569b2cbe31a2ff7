#!/usr/bin/env python3
"""Standalone check of the PyTorch port's conv kernels on a CUDA card.

    timeout 300 python3 tools/torch_conv_check.py            # build + correctness
    timeout 600 python3 tools/torch_conv_check.py --time     # + times per shape
    timeout 600 python3 tools/torch_conv_check.py --probe    # + the fill probe
    timeout 600 python3 tools/torch_conv_check.py --winograd [--time] [--probe]

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
"""

from __future__ import annotations

import argparse
import collections
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--winograd", action="store_true",
                    help="check the Winograd conv kernels instead of the direct")
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
