#!/usr/bin/env python3
"""The readings that a predict cell's ``gap`` limit is set from, on many
seeds in one process, without ``perfbench/control.py``'s third run (the
program with its postprocessing skipped):

    python3 tools/gap_readings.py --workload swin_unetr.cohort --seeds 1,2,3 \\
        [--program] [--control] [--out FILE] [--root DIR]

For each seed, one JSON line with the entries that ``perfbench/control.py``
computes the same way, from its own functions: ``program`` (one call of the
cohort, the sampled answers judged as a run judges them) with ``--program``,
and ``control`` (the reference in fp8 operands with per-tensor scales, in
the program's place, judged alike) with ``--control``; each entry's largest
``gap`` as ``program_gap`` and ``control_gap``. ``--root`` names the
checkout whose benchmark files are read (default: this one).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--out", default=None, help="also append the lines here")
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import cache_dirs

    cache_dirs(ROOT)
    import torch

    from perfbench import control, drivers, harness
    from perfbench.reference import segment, unet

    root = Path(args.root)
    spec = harness.load_spec(root)
    _, config, mix, _ = harness.cell_parts(root, spec, args.workload)
    if mix["kind"] != "predict_closed_loop":
        raise SystemExit(f"{args.workload}: not a predict cell")
    kind = drivers.load(root, mix["kind"])
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = drivers.Context(exp=harness.experiment(config), config=config["experiment"],
                              mix=mix, seed=seed, seconds=0.0, traced=False,
                              device=dev, t0=t)
        out = {}
        pred, keeper, sample, vols, fine, coarse = control.served(kind, ctx)
        del pred, keeper
        drivers.free(dev)
        if args.program:
            out["program"] = kind.judge(ctx, sample, vols, fine, coarse)
        if args.control:
            ref = segment.Segmenter(ctx.config, fine, coarse, dev)
            ctl = segment.Segmenter(ctx.config, fine, coarse, dev, quant=unet.Quant())
            out["control"] = [dict(segment.judge_control(ref, ctl, vols[i]), volume=i)
                              for i, _, _ in sample.items()]
            del ref, ctl
        for k in list(out):
            out[f"{k}_gap"] = max(r["gap"] for r in out[k])
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
