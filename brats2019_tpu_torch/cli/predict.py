"""``predict <case_dir>`` for the PyTorch port (reference:
``brats2019_tpu/cli/predict.py:256-370``).

Usage:
    python -m brats2019_tpu_torch.cli.predict <case_dir_or_root>
        [--preset cascade] [--workdir DIR] [--output PATH] [--device cuda]
        [--no-tta] [--no-cascade]

Loads each stage's params from ``<workdir>/{fine,coarse}/`` (an exported
``params.npz`` in the JAX package's format, or the port's own training
checkpoints: ``cli/common.py`` load_stage_params) and writes
``<case>_pred.nii.gz`` with BraTS disk labels {0,1,2,4} next to each case,
with the input header. ``--device cuda`` on a host
without a card is an error; ``--device cpu`` runs the plain torch ops.
Every preset predicts: ``models/cascade.py`` ``make_predict_fn`` picks the
split cascade, the staged multi-tile sweep or the monolithic program.
``--no-tta`` (one forward per tile) and ``--no-cascade`` (no coarse stage,
the whole canvas swept) change the preset's inference config as the
reference's flags do.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from ..configs.presets import PRESETS
from ..data.case import discover_cases
from .common import load_stage_params, resolve_experiment


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="brats2019_tpu_torch.predict",
                                description=__doc__)
    p.add_argument("case_dir", help="BraTS case directory (or root of cases)")
    p.add_argument("--preset", default="cascade", choices=sorted(PRESETS))
    p.add_argument("--workdir", default=None)
    p.add_argument("--output", default=None,
                   help="output path (single-case mode only)")
    p.add_argument("--no-tta", action="store_true",
                   help="one forward per tile, no 8-flip TTA")
    p.add_argument("--no-cascade", action="store_true",
                   help="no coarse stage: sweep the whole canvas")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (hand-written kernels) or cpu "
                        "(plain torch ops)")
    p.add_argument("--min-component-voxels", type=int, default=None,
                   help="override the preset's small-component filter "
                        "(0 disables)")
    p.add_argument("--et-min-voxels", type=int, default=None,
                   help="override the preset's tiny-ET relabel threshold "
                        "(0 disables)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    exp = resolve_experiment(args)
    if args.no_tta:
        exp = dataclasses.replace(
            exp, infer=dataclasses.replace(exp.infer, tta_flips=False))
    if args.no_cascade:
        exp = dataclasses.replace(
            exp, infer=dataclasses.replace(exp.infer, cascade=False))
    cases = discover_cases(args.case_dir)
    if not cases:
        print(f"error: no BraTS case found at {args.case_dir}", file=sys.stderr)
        return 2
    if args.output and len(cases) > 1:
        print("error: --output only valid for a single case", file=sys.stderr)
        return 2
    try:
        params_fine = load_stage_params(exp, "fine")
        params_coarse = (
            load_stage_params(exp, "coarse")
            if exp.infer.cascade and exp.coarse_unet is not None else None
        )
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    from ..infer.predictor import Predictor

    predictor = Predictor(exp, params_fine, params_coarse, device=args.device)
    t0 = time.time()
    for d in cases:
        out, stats = predictor.predict_dir(
            d, args.output if len(cases) == 1 else None
        )
        print(f"[predict] {d} -> {out} (load {stats.load_s:.2f}s, device "
              f"{stats.device_s:.2f}s, post {stats.post_s:.2f}s)", flush=True)
    dt = time.time() - t0
    print(f"[predict] {len(cases)} case(s) in {dt:.2f}s "
          f"({len(cases) / dt:.3f} volumes/sec on {predictor.device})",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
