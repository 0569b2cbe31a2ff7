#!/usr/bin/env python3
"""Standalone check of the PyTorch port's fused IN+act forward on a CUDA card.

    timeout 300 python3 tools/torch_norm_check.py                  # correctness
    timeout 600 python3 tools/torch_norm_check.py --time           # + ms per shape
    timeout 600 python3 tools/torch_norm_check.py --time --parent OLD.py
    timeout 600 python3 tools/torch_norm_check.py --f32 [--time] [--parent OLD.py]

Holds ``ops.norm.instance_norm_act_kernel`` (``ops/triton_norm.py``) against
``instance_norm_act_plain`` at small and ragged shapes, batch 1 and 8, every
activation: y within 2 bf16 ulp, mean and rstd within 1e-5 relative, a repeat
run bitwise equal. ``--time``: device ms (CUDA-graph replay) at every IN+act
shape of the flagship predict path with the bytes/s of the counted bytes (x
read once, y written once) against 3.35 TB/s, and the sum per volume.
``--parent FILE`` also times another version of ``triton_norm.py`` (a file
whose ``launch(x, y, gamma, beta, eps, activation)`` has the same interface)
on the same inputs in the same call, in turns (parent, this, this, parent):
the way to hold a redesign of the forward against the one in the tree.

The partials path (the conv's STATS epilogue, ``csrc/conv3d_wgmma.cu``, then
the Triton merge and apply): at small conv shapes (ragged boxes, N > 1, both
box depths) and at every (conv, IN) pair of the flagship predict path, the
STATS conv's y bitwise equal to the conv's without it, its partials within
1e-5 of ``conv_stats_plain`` of y and bitwise repeatable, the merged mean and
rstd within 1e-5 relative of y's plain statistics, and IN+act from the
partials within 2 bf16 ulp of the plain version and bitwise repeatable.
``--time`` then gives, per pair, the three terms of the partials path (the
epilogue: the STATS conv less the conv, in turns; the merge; the apply) beside
the three-launch forward on the same y (and the parent's, with ``--parent``).

``--f32``: the f32 partials path instead (the f32 conv's STATS epilogue,
``csrc/conv3d.cu`` ``conv3d_stats_ndhwc_f32``, then the same merge and
apply): at small ragged shapes at every box depth and at every f32 (conv, IN)
pair (the accuracy config's tile batch, one ``smoke`` and one ``unit`` train
step), y bitwise equal to the plain instance's, partials within 1e-5 of
``conv_stats_plain`` and bitwise repeatable, merged mean and rstd within 1e-5
of y's plain statistics, IN+act from the partials within 1e-5 of the plain
version and bitwise repeatable; ptxas's registers and spills of the four f32
instances. ``--time``: per pair the epilogue (STATS conv less conv, in turns),
the merge and the apply, the route's one launch (the merge folded into the
apply) in turns with the two launches, and the route against the
three-launch form on the same y (with ``--parent FILE``, an earlier
``triton_norm.py``, its three-launch ``launch``), in turns (prev, this,
this, prev); sums per tile batch and train step.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from brats2019_tpu_torch.configs.presets import get_preset  # noqa: E402
from brats2019_tpu_torch.ops import conv, norm  # noqa: E402
from chip_smoke import bf16_ulps, device_ms, unet_calls  # noqa: E402

SMALL = [
    # (N, D, H, W, C)
    (1, 1, 1, 1, 3), (2, 1, 1, 17, 5), (1, 12, 14, 10, 192), (8, 8, 8, 8, 320),
    (3, 9, 7, 13, 40), (1, 64, 64, 64, 48), (8, 16, 16, 16, 256),
    (2, 32, 32, 32, 128), (1, 48, 56, 40, 48), (5, 33, 31, 29, 64),
]


def predict_norm_calls():
    """(N, D, H, W, C) -> calls per volume on the flagship predict path."""
    exp = get_preset("cascade")
    calls = (unet_calls(exp.coarse_unet, 1, exp.infer.coarse_shape)
             + unet_calls(exp.unet, 8, exp.infer.roi_shape))
    return collections.Counter(sh for name, sh in calls
                               if name == "instance_norm_act")


def make(shape, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 3 + 1).bfloat16()
    gam = torch.rand(shape[-1], generator=g, device=dev) + 0.5
    bet = torch.randn(shape[-1], generator=g, device=dev) * 0.2
    return x, gam, bet


CONV_SMALL = [
    # (N, D, H, W, Ci), Co, box depth of the instance to force (None: the plan's)
    ((1, 5, 6, 7, 16), 16, None), ((2, 9, 7, 13, 32), 24, 4),
    ((2, 9, 7, 13, 32), 24, 2), ((1, 12, 14, 10, 96), 192, None),
    ((1, 8, 8, 16, 80), 136, 4), ((3, 3, 9, 10, 32), 48, 2),
]


def predict_conv_norm_pairs():
    """((N, D, H, W, Ci), Co) of each conv followed by an IN on the flagship
    predict path -> calls per volume."""
    exp = get_preset("cascade")
    calls = (unet_calls(exp.coarse_unet, 1, exp.infer.coarse_shape)
             + unet_calls(exp.unet, 8, exp.infer.roi_shape))
    return collections.Counter(
        (sh[:5], sh[5]) for (name, sh), nxt in zip(calls, calls[1:])
        if name == "conv3d" and nxt[0] == "instance_norm_act")


def conv_inputs(shape, co, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    w = (torch.randn((3, 3, 3, shape[-1], co), generator=g, device=dev)
         / (27 * shape[-1]) ** 0.5).bfloat16()
    gam = torch.rand(co, generator=g, device=dev) + 0.5
    bet = torch.randn(co, generator=g, device=dev) * 0.2
    return x, w, gam, bet


def check_partials(shape, co, bd, dev) -> bool:
    """The checks of the partials path at one conv shape (module docstring)."""
    from brats2019_tpu_torch.ops import triton_norm

    x, w, gam, bet = conv_inputs(shape, co, dev)
    plan = conv.plan_conv(*shape, co)
    if bd is not None and bd != plan.box[0]:
        plan = conv.wgmma_plan(*shape, co, bd, 64)
    y0 = conv.conv3d_kernel_wgmma(x, w, plan)
    y, part = conv.conv3d_kernel_wgmma(x, w, plan, stats=True)
    _, part2 = conv.conv3d_kernel_wgmma(x, w, plan, stats=True)
    ref_part = conv.conv_stats_plain(y, plan)
    mean, rstd = triton_norm.merge(part, 1e-5)
    got = norm.instance_norm_act_kernel(y, gam, bet, partials=part)[0]
    again = norm.instance_norm_act_kernel(y, gam, bet, partials=part)[0]
    ref, rmean, rrstd = norm._plain_stats(y, gam, bet, 1e-5, "relu")
    torch.cuda.synchronize()
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    part_err = max(rel(part[i], ref_part[i]) for i in range(3))
    stats = max(rel(mean, rmean), rel(rstd, rrstd))
    err = bf16_ulps(got, ref)
    same = (torch.equal(y, y0), torch.equal(part, part2), torch.equal(got, again))
    ok = all(same) and part_err <= 1e-5 and stats <= 1e-5 and err <= 2
    print(f"  [{'PASS' if ok else 'FAIL'}] STATS conv {shape} -> {co}, box "
          f"{plan.box[0]}x8x8 Co tile {plan.bn}: y bitwise the plain instance's "
          f"{same[0]}; partials vs conv_stats_plain {part_err:.1e}, repeat "
          f"bitwise {same[1]}; merged mean/rstd vs y's plain statistics "
          f"{stats:.1e} (tol 1e-5); IN+act from partials {err:.2f} bf16 ulp "
          f"(tol 2), repeat bitwise {same[2]}", flush=True)
    return ok


def time_partials(dev, card, parent) -> None:
    from brats2019_tpu_torch.ops import triton_norm

    print(f"== IN+act from the conv's partials on {card} (device ms, CUDA-graph "
          "replay)", flush=True)
    tot = collections.Counter()
    for (shape, co), count in predict_conv_norm_pairs().items():
        x, w, gam, bet = conv_inputs(shape, co, dev)
        reps = 3 if x.numel() * co / shape[-1] > 1e8 else 10
        y, part = conv.conv3d_kernel(x, w, stats=True)
        n, d, h, wd, c = y.shape
        y3 = y.view(n, d * h * wd, c)
        out = torch.empty_like(y3)
        mean, rstd = triton_norm.merge(part, 1e-5)
        plain_conv = lambda: conv.conv3d_kernel(x, w)
        stats_conv = lambda: conv.conv3d_kernel(x, w, stats=True)
        t = [device_ms(f, reps) for f in (plain_conv, stats_conv, stats_conv,
                                          plain_conv)]
        row = {"conv": min(t[0], t[3]), "conv+STATS": min(t[1], t[2])}
        row["epilogue"] = row["conv+STATS"] - row["conv"]
        row["merge"] = device_ms(lambda: triton_norm.merge(part, 1e-5), reps)
        row["apply"] = device_ms(lambda: triton_norm.apply(
            y3, out, mean, rstd, gam, bet, "relu"), reps)
        row["IN from partials"] = row["merge"] + row["apply"] + row["epilogue"]
        row["three launches (prev)"] = device_ms(
            lambda: norm.instance_norm_act_kernel(y, gam, bet), reps)
        if parent is not None:
            row["parent"] = device_ms(
                lambda: parent.launch(y3, out, gam, bet, 1e-5, "relu"), reps)
        row["bound"] = 4.0 * y.numel() / 3.35e12 * 1e3
        for k, v in row.items():
            tot[k] += count * v
        print(f"  {shape} -> {co} x{count}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    print("  sums per volume (24 pairs): "
          + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()), flush=True)


def check_small(dev) -> int:
    failures = 0
    for shape in SMALL:
        for act in norm.ACTIVATIONS:
            x, gam, bet = make(shape, dev)
            got, mean, rstd = norm.instance_norm_act_kernel(x, gam, bet, activation=act)
            again, _, _ = norm.instance_norm_act_kernel(x, gam, bet, activation=act)
            ref, rmean, rrstd = norm._plain_stats(x, gam, bet, 1e-5, act)
            torch.cuda.synchronize()
            err = bf16_ulps(got, ref)
            rel = lambda a, b: ((a - b).abs() / b.abs().clamp_min(1e-3)).max().item()
            stats = max(rel(mean, rmean), rel(rstd, rrstd))
            same = bool(torch.equal(got, again))
            ok = err <= 2 and stats <= 1e-5 and same
            failures += not ok
            print(f"  [{'PASS' if ok else 'FAIL'}] {shape} {act}: {err:.2f} bf16 "
                  f"ulp (tol 2), mean/rstd rel {stats:.1e} (tol 1e-5), repeat "
                  f"bitwise {same}", flush=True)
    return failures


def time_shapes(dev, card, parent) -> None:
    print(f"== IN+act forward on {card} (device ms, CUDA-graph replay)", flush=True)
    tot = collections.Counter()
    for shape, count in predict_norm_calls().items():
        x, gam, bet = make(shape, dev)
        reps = 3 if x.numel() > 1e8 else 10
        mine = lambda: norm.instance_norm_act_kernel(x, gam, bet)
        row = {}
        if parent is not None:
            n, d, h, w, c = shape
            x3 = x.view(n, d * h * w, c)
            y3 = torch.empty_like(x3)
            old = lambda: parent.launch(x3, y3, gam, bet, 1e-5, "relu")
            times = [device_ms(f, reps) for f in (old, mine, mine, old)]
            row["parent"] = min(times[0], times[3])
            row["this"] = min(times[1], times[2])
        else:
            row["this"] = device_ms(mine, reps)
        counted = 4.0 * x.numel()
        row["bound"] = counted / 3.35e12 * 1e3
        for k, v in row.items():
            tot[k] += count * v
        print(f"  {shape} x{count}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f"; {counted / row['this'] / 1e9:.3f} TB/s of counted bytes "
              f"({100 * row['bound'] / row['this']:.0f}% of 3.35)", flush=True)
    print("  sums per volume (24 calls): "
          + ", ".join(f"{k} {v:.3f}" for k, v in tot.items()), flush=True)


# ------------------------------------------------------------ the f32 route --

F32_SMALL = [
    # (N, D, H, W, Ci), Co: every box depth takes them (at most 512 threads)
    ((2, 9, 7, 13, 12), 16), ((1, 5, 17, 3, 4), 8), ((3, 6, 9, 10, 3), 4),
    ((1, 17, 8, 16, 16), 24), ((1, 8, 8, 8, 8), 6),
]


def f32_pairs():
    """{what: [((N, D, H, W, Ci), Co), ...]}: each f32 conv that an IN follows,
    one entry a call, in the accuracy config's tile batch and one ``smoke``
    and one ``unit`` train step."""
    from chip_smoke import accuracy_exp

    acc = accuracy_exp()
    smoke, unit = get_preset("smoke"), get_preset("unit")
    runs = {"accuracy tile batch (8, 32^3)": unet_calls(acc.unet, 8, acc.infer.tile),
            "smoke train step (1, 64^3)": unet_calls(smoke.unet, 1, smoke.train.patch),
            "unit train step (1, 16^3)": unet_calls(unit.unet, 1, unit.train.patch)}
    return {k: [(sh[:5], sh[5]) for (name, sh), nxt in zip(v, v[1:])
                if name == "conv3d" and nxt[0] == "instance_norm_act"]
            for k, v in runs.items()}


def f32_inputs(shape, co, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev)
    w = torch.randn((3, 3, 3, shape[-1], co), generator=g, device=dev) / (27 * shape[-1]) ** 0.5
    gam = torch.rand(co, generator=g, device=dev) + 0.5
    bet = torch.randn(co, generator=g, device=dev) * 0.2
    return x, w, gam, bet


def f32_check_partials(shape, co, bd, dev) -> bool:
    """The checks of the f32 partials path at one conv shape (``--f32``)."""
    from brats2019_tpu_torch.ops import triton_norm

    x, w, gam, bet = f32_inputs(shape, co, dev)
    plan = conv.f32_plan(*shape, co, bd=bd) if bd else conv.plan_conv(
        *shape, co, dtype=torch.float32)
    y0 = conv.conv3d_kernel_f32(x, w, plan)
    y, part = conv.conv3d_kernel_f32(x, w, plan, stats=True)
    _, part2 = conv.conv3d_kernel_f32(x, w, plan, stats=True)
    ref_part = conv.conv_stats_plain(y, plan)
    got, mean, rstd = norm.instance_norm_act_kernel(y, gam, bet, partials=part)
    again = norm.instance_norm_act_kernel(y, gam, bet, partials=part)[0]
    mean2, rstd2 = triton_norm.merge(part, 1e-5)     # the two-launch form's
    ref, rmean, rrstd = norm._plain_stats(y, gam, bet, 1e-5, "relu")
    torch.cuda.synchronize()
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    part_err = max(rel(part[i], ref_part[i]) for i in (1, 2))
    stats = max(rel(mean, rmean), rel(rstd, rrstd), rel(mean2, rmean),
                rel(rstd2, rrstd))
    err = rel(got, ref)
    same = (torch.equal(y, y0), torch.equal(part, part2), torch.equal(got, again),
            torch.equal(part[0], ref_part[0]))
    ok = all(same) and part_err <= 1e-5 and stats <= 1e-5 and err <= 1e-5
    print(f"  [{'PASS' if ok else 'FAIL'}] f32 STATS conv {shape} -> {co}, box "
          f"{plan.box[0]}x8x8 Co tile {plan.bn} slab {plan.chunk}: y bitwise the "
          f"plain instance's {same[0]}; counts exact {same[3]}, partials vs "
          f"conv_stats_plain {part_err:.1e}, repeat bitwise {same[1]}; merged "
          f"mean/rstd vs y's plain statistics {stats:.1e} (tol 1e-5); IN+act from "
          f"partials {err:.1e} (tol 1e-5), repeat bitwise {same[2]}", flush=True)
    return ok


def f32_time(dev, card, parent) -> None:
    from brats2019_tpu_torch.ops import triton_norm

    print(f"== f32 IN+act from the f32 conv's partials on {card} (device ms, "
          "CUDA-graph replay)", flush=True)
    timed = {}
    for shape, co in dict.fromkeys(c for v in f32_pairs().values() for c in v):
        x, w, gam, bet = f32_inputs(shape, co, dev)
        y, part = conv.conv3d_kernel(x, w, stats=True)
        n, d, h, wd, c = y.shape
        y3 = y.view(n, d * h * wd, c)
        out = torch.empty_like(y3)
        mean, rstd = triton_norm.merge(part, 1e-5)
        plain_conv = lambda: conv.conv3d_kernel(x, w)
        stats_conv = lambda: conv.conv3d_kernel(x, w, stats=True)
        new = lambda: triton_norm.launch_from_partials(y3, out, part, gam, bet,
                                                       1e-5, "relu")
        two = lambda: triton_norm.apply(y3, out, *triton_norm.merge(part, 1e-5),
                                        gam, bet, "relu")
        t = [device_ms(f, 10) for f in (plain_conv, stats_conv, stats_conv,
                                        plain_conv)]
        row = {"conv": min(t[0], t[3]), "conv+STATS": min(t[1], t[2])}
        row["epilogue"] = row["conv+STATS"] - row["conv"]
        row["merge"] = device_ms(lambda: triton_norm.merge(part, 1e-5), 10)
        row["apply"] = device_ms(lambda: triton_norm.apply(
            y3, out, mean, rstd, gam, bet, "relu"), 10)
        t = [device_ms(f, 10) for f in (two, new, new, two)]
        row["merge, apply (two launches)"] = min(t[0], t[3])
        row["merge-apply (route)"] = min(t[1], t[2])
        old = (lambda: parent.launch(y3, out, gam, bet, 1e-5, "relu")) if parent else (
            lambda: triton_norm.launch(y3, out, gam, bet, 1e-5, "relu"))
        t = [device_ms(f, 10) for f in (old, new, new, old)]
        row["three launches (prev" + (", parent)" if parent else ")")] = min(t[0], t[3])
        row["IN from partials"] = min(t[1], t[2]) + row["epilogue"]
        row["bound"] = 8.0 * y.numel() / 3.35e12 * 1e3
        timed[(shape, co)] = row
        print(f"  {shape} -> {co}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
    for what, pairs in f32_pairs().items():
        tot = collections.Counter()
        for c in pairs:
            for k, v in timed[c].items():
                tot[k] += v
        print(f"  sums per {what}, {len(pairs)} pairs: "
              + ", ".join(f"{k} {v:.4f}" for k, v in tot.items())
              + f"; epilogue / conv {tot['epilogue'] / tot['conv']:.3f}", flush=True)


def main_f32(args, dev, card, parent) -> int:
    from brats2019_tpu_torch.ops import _build

    conv._lib()
    log = _build.build_logs.get("conv3d", "")
    lines = log.splitlines()
    report = [" ".join(ln.strip() for ln in lines[i:i + 4])
              for i, ln in enumerate(lines)
              if "Compiling entry function" in ln and "conv3d_f32_kernel" in ln]
    print("  ptxas, conv3d_f32_kernel instances:\n    "
          + ("\n    ".join(report) or "(cached: no ptxas report)"), flush=True)
    failures = 0
    for shape, co in F32_SMALL:
        for bd in conv.F32_BOX_DEPTHS:
            failures += not f32_check_partials(shape, co, bd, dev)
    for shape, co in dict.fromkeys(c for v in f32_pairs().values() for c in v):
        failures += not f32_check_partials(shape, co, None, dev)
    if args.time:
        f32_time(dev, card, parent)
    print(f"{failures} failure(s)", flush=True)
    return 1 if failures else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--parent", help="an earlier triton_norm.py to time beside")
    ap.add_argument("--f32", action="store_true",
                    help="check (and time) the f32 partials path instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    import triton

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, triton "
          f"{triton.__version__}; card: {card}", flush=True)
    parent = None
    if args.parent:
        spec = importlib.util.spec_from_file_location("parent_triton_norm", args.parent)
        parent = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(parent)
    if args.f32:
        return main_f32(args, dev, card, parent)
    failures = check_small(dev)
    conv._lib_wgmma()
    from brats2019_tpu_torch.ops import _build

    print("  ptxas, conv3d_wgmma: " + " | ".join(
        ln.strip() for ln in _build.build_logs.get("conv3d_wgmma", "(cached)").splitlines()
        if ln.strip() and "Compiling entry" not in ln and "(C7519)" not in ln),
        flush=True)
    for shape, co, bd in CONV_SMALL:
        failures += not check_partials(shape, co, bd, dev)
    for shape, co in predict_conv_norm_pairs():
        failures += not check_partials(shape, co, None, dev)
    if args.time:
        time_shapes(dev, card, parent)
        time_partials(dev, card, parent)
    print(f"{failures} failure(s)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
