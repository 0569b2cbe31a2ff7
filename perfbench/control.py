"""Readings that the limits of ``correct`` are set from, at a cell's own
size, on many seeds in one process (the benchmark's own runs never run
this):

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--out FILE]

For each seed, one JSON line: the program's readings (a predict cell: one
call of the cohort, the sampled answers judged as a run judges them; a
training cell: its first steps against the reference's), the control's (the
reference in the precision below the configuration's -- fp8 operands with
per-tensor scales -- in the program's place, judged alike) and a fault's: a
predict cell's program with its postprocessing skipped (the labels served
as the argmax left them), a training cell's half of each batch left out (the
mean taken over the rest). A state left unchanged reads 1 on ``update_gap``
by its definition and needs no run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def served(kind, ctx):
    """One call of the cohort: (the sample of answers, volumes, weights)."""
    pred, keeper, vols, fine, coarse = kind.setup(ctx)
    sample = kind._Sample(ctx.mix["check_volumes"], ctx.seed, kind._largest_brain(vols))
    sample.offer(pred.predict_arrays_many(vols), keeper.taken)
    return pred, keeper, sample, vols, fine, coarse


def predict_readings(ctx, kind, drivers, segment, unet):
    from brats2019_tpu_torch.models import cascade

    pred, keeper, sample, vols, fine, coarse = served(kind, ctx)
    del pred, keeper
    drivers.free(ctx.device)
    program = kind.judge(ctx, sample, vols, fine, coarse)
    ref = segment.Segmenter(ctx.config, fine, coarse, ctx.device)
    ctl = segment.Segmenter(ctx.config, fine, coarse, ctx.device, quant=unet.Quant())
    control = [dict(segment.judge_control(ref, ctl, vols[i]), volume=i)
               for i, _, _ in sample.items()]
    del ref, ctl
    drivers.free(ctx.device)
    real = cascade.postprocess_device
    cascade.postprocess_device = lambda labels, *a: labels
    try:
        pred, keeper, sample, vols, fine, coarse = served(kind, ctx)
    finally:
        cascade.postprocess_device = real
    del pred, keeper
    drivers.free(ctx.device)
    skipped = kind.judge(ctx, sample, vols, fine, coarse)
    return {"program": program, "control": control, "postprocess_skipped": skipped}


def train_readings(ctx, kind, drivers, rt, unet):
    step, pool, p0, tdict, got = kind.setup(ctx)
    del step
    drivers.free(ctx.device)
    run = lambda **kw: rt.run_steps(p0, ctx.config["unet"], tdict, pool, ctx.seed,
                                    steps=ctx.mix["checked_steps"], device=ctx.device, **kw)
    ref = run()
    half = list(range(tdict["batch_per_device"] // 2))
    return {"program": rt.compare(got, ref),
            "control": rt.compare(run(quant=unet.Quant()), ref),
            "half_batch": rt.compare(run(keep=half), ref)}


def main(argv=None, root=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--out", default=None, help="also append the lines here")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import cache_dirs
    cache_dirs(ROOT)
    import torch

    from perfbench import drivers, harness
    from perfbench.reference import segment, train as rt, unet

    root = Path(root or ROOT)
    spec = harness.load_spec(root)
    cell, config, mix, _ = harness.cell_parts(root, spec, args.workload)
    kind = drivers.load(root, mix["kind"])
    dev = torch.device(device or "cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = drivers.Context(exp=harness.experiment(config), config=config["experiment"],
                              mix=mix, seed=seed, seconds=0.0, traced=False,
                              device=dev, t0=t)
        if mix["kind"] == "train":
            out = train_readings(ctx, kind, drivers, rt, unet)
        else:
            out = predict_readings(ctx, kind, drivers, segment, unet)
        line = json.dumps(dict(out, workload=args.workload, seed=seed,
                               seconds=time.perf_counter() - t))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        drivers.free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
