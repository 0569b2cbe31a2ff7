"""``export`` for the PyTorch port (reference: ``brats2019_tpu/cli/export.py``).

Usage:
    python -m brats2019_tpu_torch.cli.export --preset cascade [--workdir DIR]
        [--stage fine|coarse|all] [--format npz|safetensors]
        [--average K | --ema] [--stablehlo [--stablehlo-check]]
        [--device cuda|cpu]

Writes the inference-only parameters of each stage's checkpoints to
``<workdir>/<stage>/params.{npz,safetensors}``: the flat format
``utils/weights.py`` reads (the JAX package's names), which ``predict`` and
``serve`` load before any checkpoint as long as it is at least as new.
Without ``--average``/``--ema`` that is the best checkpoint, else the
latest step's, read from the checkpoints only (never a previous export).
``--average K`` writes the f32 mean of the last K retained step checkpoints
(SWA-style: one averaged model), ``--ema`` the weight EMA a ``train
--ema-decay`` run records in every step checkpoint. ``.safetensors`` is
written by the port's own writer (the card's host has no ``safetensors``
package).

``--stablehlo`` (the reference's flag name) also writes the predict program
as ``torch.export`` programs (``.pt2``, weight-agnostic: the weights are
inputs) and their ``manifest.json`` into ``<workdir>/torch_export/``, so a
JAX export into the same workdir is never overwritten
(``infer/export_hlo.py``); the weights are the serving ones
(``load_serving_params``), the device ``--device`` (the card unless the
caller asks for the CPU), the conv backend the process has set.
``--stablehlo-check`` also loads them and asserts exact label equality with
the eager program on a synthetic canvas.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..configs.presets import PRESETS
from ..utils.weights import save_params
from .common import (
    average_stage_params,
    ema_stage_params,
    load_stage_params,
    resolve_experiment,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="brats2019_tpu_torch.export",
                                description=__doc__)
    p.add_argument("--preset", default="cascade", choices=sorted(PRESETS))
    p.add_argument("--workdir", default=None)
    p.add_argument("--stage", default="all", choices=("all", "fine", "coarse"))
    p.add_argument("--format", default="npz", choices=("npz", "safetensors"))
    p.add_argument("--average", type=int, default=None, metavar="K",
                   help="export the uniform weight average of the last K "
                        "retained step checkpoints instead of the "
                        "best/latest params")
    p.add_argument("--ema", action="store_true",
                   help="export the weight EMA recorded by a `train "
                        "--ema-decay` run (in the latest step checkpoint's "
                        "optimizer state) instead of the best/latest params")
    p.add_argument("--stablehlo", action="store_true",
                   help="ALSO export the predict program as torch.export "
                        "programs (.pt2, + manifest.json) under "
                        "<workdir>/torch_export/: weight-agnostic, every "
                        "kernel a brats_torch:: operator node "
                        "(infer/export_hlo.py)")
    p.add_argument("--stablehlo-check", action="store_true",
                   help="after --stablehlo, load the programs and assert "
                        "exact label equality with the eager program on a "
                        "synthetic canvas")
    p.add_argument("--device", default="cuda",
                   help="the device the --stablehlo programs are exported "
                        "for (default: the card; cpu runs the plain torch "
                        "path)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    exp = resolve_experiment(args)
    stages = []
    if args.stage in ("all", "fine"):
        stages.append("fine")
    if args.stage in ("all", "coarse") and exp.coarse_unet is not None:
        stages.append("coarse")
    if not stages:
        # --stage coarse on a cascade-less preset: exporting nothing while
        # exiting 0 would read as success
        print(f"error: preset '{exp.name}' has no coarse stage to export",
              file=sys.stderr)
        return 2
    if args.average is not None and args.average < 1:
        print("error: --average must be >= 1", file=sys.stderr)
        return 2
    if args.average and args.ema:
        print("error: --average and --ema are mutually exclusive",
              file=sys.stderr)
        return 2
    rc = 0
    for stage in stages:
        try:
            if args.ema:
                params = ema_stage_params(exp, stage)
            elif args.average:
                params = average_stage_params(exp, stage, args.average)
            else:
                params = load_stage_params(exp, stage,
                                           from_checkpoint_only=True)
        except FileNotFoundError as e:
            print(f"warning: {e}", file=sys.stderr)
            rc = 1
            continue
        out = os.path.join(exp.workdir, stage, f"params.{args.format}")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        save_params(out, params)
        print(f"[export] {stage} -> {out}", flush=True)
    if args.stablehlo and rc == 0:
        from ..infer.export_hlo import export_predict_program
        from ..infer.predictor import Predictor
        from .common import load_serving_params

        try:
            exp, pf, pc = load_serving_params(exp)
        except FileNotFoundError as e:
            print(f"warning: --stablehlo skipped: {e}", file=sys.stderr)
            return 1
        written = export_predict_program(
            Predictor(exp, pf, pc, device=args.device),
            os.path.join(exp.workdir, "torch_export"),
            check=args.stablehlo_check,
        )
        for w in written:
            print(f"[export] torch.export -> {w}", flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
