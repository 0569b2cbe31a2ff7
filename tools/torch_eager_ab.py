#!/usr/bin/env python3
"""Parent-against-change timing of the port's eager paths on one CUDA card.

    python3 tools/torch_eager_ab.py --parent DIR [--rounds 5] [--reps 20]
    python3 tools/torch_eager_ab.py --tree DIR [--reps 20]      (one run)
    python3 tools/torch_eager_ab.py --dispatch                  (this tree)

With ``--parent`` (the root of a parent tree unpacked with ``git archive``
into a directory ``.gitignore`` lists; only its ``brats2019_tpu_torch/`` is
read), runs one warm-up process per tree (it builds the kernels and is not
counted), then ``--rounds`` processes a side in turns (parent, change,
change, parent, ...), each one run of this script with ``--tree``, and
prints per metric each side's per-process medians and a verdict:
``regressed`` (every change run slower than every parent run),
``improved`` (every change run faster), ``held`` (the ranges overlap and
the change's median lies inside the parent's range) or ``unresolved``.
Then it runs ``--dispatch`` on this tree.

One run (``--tree``) imports ``brats2019_tpu_torch`` from DIR, builds seeded
random ``cascade`` weights and one synthetic 240x240x155 case, and times:

* device ms/vol (CUDA events around ``predict_device``, after two warm-up
  calls) and the host clock until the call returns, of the split cascade,
  ``cascade --no-tta`` (the monolithic program) and serve's program (the
  Winograd backend with ``postproc="device"``);
* the fine and coarse train steps (the steps ``chip_smoke.py`` phase 4
  times) and the distillation step with two teachers (phase 8's): ms/step
  from CUDA events over the steps after three warm-up steps, on a device
  pool of random cases;
* ``postprocess_device`` alone (ms by CUDA events on a 128^3 ROI of
  labels), serve's device postprocessing.

``--dispatch`` times what the ``torch.library`` dispatcher adds to each
``brats_torch::`` operator call on the card: each operator's schema is
defined again on a probe operator whose CUDA implementation returns
outputs made once, and the host clock over calls of the probe operator is
set against calls of that implementation (no kernel launch in either; best
of 15 rounds of 2000 calls, taken in turns), under ``no_grad`` (a training
step's forward inside its autograd Function, the weights requiring a
gradient) and ``inference_mode`` (predict). It counts the operator calls of
one volume of each program and of one train step, and prints their
product with the cost, plus the direct conv's ``_stats_route`` look-up
before each STATS conv: the dispatcher's host time per volume or step.

Prints the card's name and power limit. The last line is a JSON object of
everything printed. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREDICT = {"split cascade": ({}, "direct"),
           "cascade --no-tta": ({"tta_flips": False}, "direct"),
           "winograd + postproc=device": ({"postproc": "device"}, "winograd")}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]


def med(v):
    return statistics.median(v)


def predictors(exp, pf, pc):
    """(name, backend, Predictor) of each program of PREDICT."""
    from brats2019_tpu_torch.infer.predictor import Predictor

    for name, (infer, backend) in PREDICT.items():
        e = dataclasses.replace(exp, infer=dataclasses.replace(exp.infer, **infer))
        yield name, backend, Predictor(e, pf, pc, device="cuda")


def train_steps(exp, tparams):
    """(name, step, pool) of the fine, coarse and distillation steps, each
    pool random cases at the stage's canvas, made on the card."""
    import numpy as np
    import torch

    from brats2019_tpu_torch.train import distill
    from brats2019_tpu_torch.train.loop import init_stage, stage_config
    from brats2019_tpu_torch.train.step import TrainStep, make_microbatch_loss

    dev = torch.device("cuda")
    for name, stage in (("fine train step", "fine"),
                        ("coarse train step", "coarse"),
                        ("distillation train step", "fine")):
        ucfg, cfg, _ = stage_config(exp, stage)
        g = torch.Generator(device=dev).manual_seed(3)
        k, canvas = cfg.pool_cases_per_device, tuple(cfg.pool_shape)
        rng = np.random.default_rng(3)
        pool = types.SimpleNamespace(
            image=torch.randn((k,) + canvas + (4,), generator=g,
                              device=dev).bfloat16(),
            seg=torch.randint(0, 4, (k,) + canvas, generator=g, device=dev,
                              dtype=torch.uint8),
            fg_host=np.stack([np.stack([rng.integers(0, c, 4096) for c in canvas],
                                       -1).astype(np.int32) for _ in range(k)]))
        model, opt = init_stage(ucfg, cfg, dev)
        if name.startswith("distillation"):
            teachers = distill.build_teachers(ucfg, tparams, dev)
            loss_fn = distill.make_kd_microbatch_loss(
                distill.teacher_replicas(teachers, [dev]), cfg, distill.KDConfig())
        else:
            loss_fn = make_microbatch_loss(cfg, ucfg.stem_downsample, lowres=True)
        yield name, TrainStep(model, cfg, loss_fn, opt), pool


def postproc_ms(exp, reps: int) -> float:
    """Median ms (CUDA events) of ``postprocess_device`` on a 128^3 ROI of
    uint8 labels: the synthetic case's tumour around its centre and 300
    seeded single voxels of label 2 (each its own small component)."""
    import numpy as np
    import torch

    from brats2019_tpu_torch.data.constants import VOLUME_SHAPE
    from brats2019_tpu_torch.data.synthetic import make_case_arrays
    from brats2019_tpu_torch.ops.connected_components import postprocess_device

    seg = make_case_arrays(seed=0, shape=VOLUME_SHAPE)[1]
    roi = tuple(exp.infer.roi_shape)
    centre = np.argwhere(seg > 0).mean(0).astype(int)
    lo = [int(np.clip(c - r // 2, 0, n - r)) for c, r, n in zip(centre, roi, seg.shape)]
    labels = seg[tuple(slice(a, a + r) for a, r in zip(lo, roi))].copy()
    rng = np.random.default_rng(0)
    labels[tuple(rng.integers(0, r, 300) for r in roi)] = 2
    t = torch.from_numpy(labels).cuda()
    args = (exp.infer.min_component_voxels, exp.infer.et_min_voxels)
    with torch.inference_mode():
        for _ in range(2):
            postprocess_device(t, *args)
        ms = []
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            postprocess_device(t, *args)
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
    return med(ms)


def one_run(tree: str, reps: int) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import brats2019_tpu_torch
    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.configs.presets import get_preset
    from brats2019_tpu_torch.data.constants import VOLUME_SHAPE
    from brats2019_tpu_torch.data.synthetic import make_case_arrays
    from brats2019_tpu_torch.utils.weights import init_params

    out = {"tree": os.path.dirname(brats2019_tpu_torch.__file__),
           "card": card_line()}
    exp = get_preset("cascade")
    pf, pc = init_params(exp.unet, 0), init_params(exp.coarse_unet, 1)
    image = make_case_arrays(seed=0, shape=VOLUME_SHAPE)[0].astype("float32")
    for name, backend, pred in predictors(exp, pf, pc):
        ops.set_backend(backend)
        try:
            canvas = pred.prepare(image)[0]
            for _ in range(2):
                pred.predict_device(canvas)
            torch.cuda.synchronize()
            dev_ms, host_ms = [], []
            for _ in range(reps):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                t0 = time.perf_counter()
                ev[0].record()
                pred.predict_device(canvas)
                ev[1].record()
                host_ms.append(1e3 * (time.perf_counter() - t0))
                torch.cuda.synchronize()
                dev_ms.append(ev[0].elapsed_time(ev[1]))
        finally:
            ops.set_backend("direct")
        out[f"{name}: device ms/vol"] = med(dev_ms)
        out[f"{name}: host ms until the call returns"] = med(host_ms)
        del pred
        torch.cuda.empty_cache()
    out["device postprocessing: ms"] = postproc_ms(exp, reps)
    tparams = [init_params(exp.unet, 5), init_params(exp.unet, 6)]
    for name, step, pool in train_steps(exp, tparams):
        for i in range(3):
            step(pool, i)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for i in range(3, 3 + reps):
            aux = step(pool, i)
        ev[1].record()
        torch.cuda.synchronize()
        if not torch.isfinite(torch.as_tensor(float(aux["loss"]))):
            raise RuntimeError(f"{name}: loss {float(aux['loss'])}")
        out[f"{name}: ms/step"] = ev[0].elapsed_time(ev[1]) / reps
        del step, pool
        torch.cuda.empty_cache()
    return out


def _op_table():
    """(operator name, the module holding its global, the global's name, a
    maker of small card inputs)."""
    import torch

    from brats2019_tpu_torch.ops import conv, norm, resize, winograd

    dev, bf = torch.device("cuda"), torch.bfloat16
    x = lambda *s: torch.randn(*s, device=dev).to(bf)
    # the weight requires a gradient, as a training step's does
    w = lambda: (0.05 * torch.randn(3, 3, 3, 32, 32, device=dev)).to(
        bf).requires_grad_()

    def in_args():
        with torch.no_grad():
            _, part = conv.conv3d_stats_op(x(1, 8, 8, 8, 32), w())
        s = torch.ones(32, device=dev, requires_grad=True)
        return (x(1, 8, 8, 8, 32), s, torch.zeros_like(s), 1e-5, "relu", part)

    xw = lambda: (x(1, 8, 8, 8, 32), w())
    return [
        ("conv3d", conv, "conv3d_op", xw),
        ("conv3d_stats", conv, "conv3d_stats_op", xw),
        ("conv3d_winograd", winograd, "conv3d_winograd_op", xw),
        ("instance_norm_act", norm, "instance_norm_act_op", in_args),
        ("downsample2x", resize, "downsample2x_op", lambda: (x(1, 8, 8, 8, 32),)),
        ("upsample2x", resize, "upsample2x_op", lambda: (x(1, 4, 4, 4, 32),)),
        ("upsample2x_concat", resize, "upsample2x_concat_op",
         lambda: (x(1, 4, 4, 4, 32), x(1, 8, 8, 8, 32))),
    ]


def dispatch_run() -> dict:
    sys.path.insert(0, HERE)
    import torch

    from brats2019_tpu_torch import ops
    from brats2019_tpu_torch.configs.presets import get_preset
    from brats2019_tpu_torch.data.constants import VOLUME_SHAPE
    from brats2019_tpu_torch.data.synthetic import make_case_arrays
    from brats2019_tpu_torch.ops import conv
    from brats2019_tpu_torch.utils.weights import init_params

    out = {"card": card_line()}
    table = _op_table()
    n, rounds = 2000, 15

    def best_us(fns, args):
        """Best host µs a call of each of ``fns`` over rounds taken in
        turns."""
        best = [float("inf")] * len(fns)
        for _ in range(rounds):
            for i, fn in enumerate(fns):
                t0 = time.perf_counter()
                for _ in range(n):
                    fn(*args)
                best[i] = min(best[i], (time.perf_counter() - t0) / n * 1e6)
        return best

    # each operator's schema on a probe operator whose CUDA implementation
    # returns the real operator's outputs, made once: the dispatcher's cost
    # alone, with no kernel launch in either arm
    probe = torch.library.Library("brats_probe", "DEF")
    cost = {}
    for name, mod, glob, make in table:
        op = getattr(mod, glob)
        args = make()
        with torch.no_grad():
            res = op(*args)
        schema = str(op._schema)
        probe.define(name + schema[schema.index("("):])
        impl = (lambda *a, _r=res: _r)
        probe.impl(name, impl, "CUDA")
        probe_op = getattr(torch.ops.brats_probe, name).default
        for mode, ctx in (("no_grad", torch.no_grad),
                          ("inference_mode", torch.inference_mode)):
            with ctx():
                via_op, direct = best_us((probe_op, impl), args)
            out[f"dispatch {name} ({mode}): us/call"] = via_op - direct
            cost[(mode, name)] = via_op - direct
    x, _ = table[0][3]()
    for mode, ctx in (("no_grad", torch.no_grad),
                      ("inference_mode", torch.inference_mode)):
        with ctx():
            out[f"_stats_route ({mode}): us/call"] = best_us(
                (conv._stats_route,), (x, 32))[0]
    torch.cuda.synchronize()

    # operator calls of one volume of each program and of one train step
    calls = collections.Counter()

    def counting(name, op):
        def call(*a):
            calls[name] += 1
            return op(*a)
        return call

    for name, mod, glob, _ in table:
        setattr(mod, glob, counting(name, getattr(mod, glob)))
    exp = get_preset("cascade")
    pf, pc = init_params(exp.unet, 0), init_params(exp.coarse_unet, 1)
    image = make_case_arrays(seed=0, shape=VOLUME_SHAPE)[0].astype("float32")
    per = {}
    for name, backend, pred in predictors(exp, pf, pc):
        ops.set_backend(backend)
        try:
            canvas = pred.prepare(image)[0]
            calls.clear()
            pred.predict_device(canvas)
            per[name] = ("inference_mode", dict(calls))
        finally:
            ops.set_backend("direct")
    tparams = [init_params(exp.unet, 5), init_params(exp.unet, 6)]
    for name, step, pool in train_steps(exp, tparams):
        step(pool, 0)
        calls.clear()
        step(pool, 1)
        per[name] = ("no_grad", dict(calls))
    torch.cuda.synchronize()
    for name, (mode, c) in per.items():
        us = sum(k * cost[(mode, op)] for op, k in c.items())
        us += c.get("conv3d_stats", 0) * out[f"_stats_route ({mode}): us/call"]
        out[f"{name}: operator calls"] = c
        out[f"{name}: dispatcher host ms (with _stats_route)"] = us / 1e3
    return out


def verdict(p, c) -> str:
    if min(c) > max(p):
        return "regressed"
    if max(c) < min(p):
        return "improved"
    return "held" if min(p) <= med(c) <= max(p) else "unresolved"


def ab(parent: str, rounds: int, reps: int) -> dict:
    def run(tree, label):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", tree, "--reps", str(reps)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            raise SystemExit(f"{label} run failed (rc {res.returncode})")
        r = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"  {label} run, {time.perf_counter() - t0:.1f} s: "
              + json.dumps(r), flush=True)
        return r

    trees = {"parent": os.path.abspath(parent), "change": HERE}
    for side, tree in trees.items():
        run(tree, f"{side} warm-up (not counted)")
    order = (["parent", "change", "change", "parent"] * rounds)[:2 * rounds]
    got = {"parent": [], "change": []}
    for side in order:
        got[side].append(run(trees[side], side))
    out = {"card": card_line(), "order": order, "rounds": rounds, "reps": reps}
    for key in got["parent"][0]:
        if key in ("tree", "card"):
            continue
        p = [r[key] for r in got["parent"]]
        c = [r[key] for r in got["change"]]
        v = verdict(p, c)
        out[key] = {"parent": p, "change": c, "verdict": v}
        print(f"{key}: parent median {med(p):.3f} ({min(p):.3f}-{max(p):.3f}), "
              f"change median {med(c):.3f} ({min(c):.3f}-{max(c):.3f}): {v}",
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the parent tree: run the A/B")
    ap.add_argument("--tree", help="root of the tree for one run")
    ap.add_argument("--dispatch", action="store_true",
                    help="time the dispatcher's cost per operator, this tree")
    ap.add_argument("--rounds", type=int, default=5,
                    help="processes a side (default 5)")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed volumes or steps a program or step a process")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 1
    if args.tree:
        out = one_run(args.tree, args.reps)
    elif args.dispatch:
        out = dispatch_run()
    elif args.parent:
        print(card_line(), flush=True)
        out = ab(args.parent, args.rounds, args.reps)
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--dispatch"], capture_output=True, text=True)
        sys.stderr.write(res.stderr[-4000:])
        if res.returncode != 0:
            raise SystemExit(f"--dispatch failed (rc {res.returncode})")
        d = json.loads(res.stdout.strip().splitlines()[-1])
        for k, v in d.items():
            print(f"{k}: {v if isinstance(v, (str, dict)) else f'{v:.3f}'}",
                  flush=True)
        out["dispatch"] = d
    else:
        ap.error("give --parent, --tree or --dispatch")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
