#!/usr/bin/env python3
"""Standalone check of the PyTorch port's fused IN+act forward on a CUDA card.

    timeout 300 python3 tools/torch_norm_check.py                  # correctness
    timeout 600 python3 tools/torch_norm_check.py --time           # + ms per shape
    timeout 600 python3 tools/torch_norm_check.py --time --parent OLD.py

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
from brats2019_tpu_torch.ops import norm  # noqa: E402
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--parent", help="an earlier triton_norm.py to time beside")
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
    failures = check_small(dev)
    if args.time:
        time_shapes(dev, card, parent)
    print(f"{failures} failure(s)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
