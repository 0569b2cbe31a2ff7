"""``train`` for the PyTorch port (reference: ``brats2019_tpu/cli/train.py``).

Usage:
    python -m brats2019_tpu_torch.cli.train --data <BraTS_root>
        [--preset cascade] [--stage all|fine|coarse] [--device cuda|cpu]
        [--val-frac 0.2 | --folds K --fold I] [--steps N] [--workdir DIR]
        [--synthetic N [--synthetic-shape X Y Z] [--synthetic-hard]]
        [--distill-from WORKDIR ... [--kd-weight W] [--kd-temperature T]]
        [--init-from PATH] [--prep-cache DIR] [--debug-nans] [--debug-checks]
        [--profile]

Trains the preset's stages (coarse first when cascaded) and leaves
``<workdir>/<stage>/checkpoints/`` that ``cli.predict`` serves. On ``--device
cuda`` the run is data-parallel over every local card, as the reference's
over its mesh (``parallel/mesh.py``, ``train/step.py``); on one card that is
the one-device run.
``--distill-from`` trains the fine stage as the KD student of those
workdirs' fine params (``train/distill.py``); ``--init-from`` warm-starts
one stage from exported params or a reference torch checkpoint.
``--device cuda`` runs the hand-written kernels and is an error on a host
without a card; ``--device cpu`` runs the plain torch ops. Exit code 3
means SIGTERM stopped the run with a resumable checkpoint.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..configs.presets import PRESETS
from ..data.case import discover_cases, kfold_split
from .common import resolve_experiment


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="brats2019_tpu_torch.train",
                                description=__doc__)
    p.add_argument("--data", help="BraTS root (dir of case dirs)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic cases under --data first")
    p.add_argument("--synthetic-shape", type=int, nargs=3, default=(96, 96, 80),
                   help="synthetic volume shape (240 240 155 for realistic runs)")
    p.add_argument("--synthetic-hard", action="store_true",
                   help="generate the v2 (hard) synthetic cases: irregular "
                        "multi-component tumors, low-contrast ET rims, bias "
                        "fields, empty-ET cases (data/synthetic.py "
                        "make_hard_case_arrays)")
    p.add_argument("--preset", default="cascade", choices=sorted(PRESETS))
    p.add_argument("--stage", default="all", choices=("all", "fine", "coarse"))
    p.add_argument("--val-frac", type=float, default=0.2)
    p.add_argument("--folds", type=int, default=None,
                   help="K-fold mode: deterministic K-way split; needs --fold")
    p.add_argument("--fold", type=int, default=None,
                   help="which fold [0, K) is this run's validation set")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--eval-every", type=int, default=None)
    p.add_argument("--log-every", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--workdir", default=None)
    p.add_argument("--ema-decay", type=float, default=None,
                   help="track an exponential moving average of the weights "
                        "(e.g. 0.999) in the optimizer state")
    p.add_argument("--rot90", dest="rot90_axial", action="store_true",
                   default=None,
                   help="augmentation extra: exact axial 90-degree rotations")
    p.add_argument("--gamma", dest="gamma_range", type=float, default=None,
                   metavar="R",
                   help="augmentation extra: per-channel gamma in "
                        "[1/(1+R), 1+R] (0 disables)")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace of steps 10-20 into "
                        "<workdir>/<stage>/profile")
    p.add_argument("--distill-from", nargs="*", default=None, metavar="WORKDIR",
                   help="teacher experiment workdir(s): train the fine stage "
                        "as a KD student of those fine checkpoints")
    p.add_argument("--kd-weight", type=float, default=1.0)
    p.add_argument("--kd-temperature", type=float, default=2.0)
    p.add_argument("--init-from", default=None, metavar="PATH",
                   help="warm-start the trained stage's params from an "
                        "exported params.{npz,safetensors} or a reference "
                        "torch checkpoint (.pt/.pth, imported by "
                        "utils/torch_import). Fresh optimizer state; an "
                        "existing resumable checkpoint wins. Requires an "
                        "explicit --stage fine|coarse (one file cannot seed "
                        "both stages)")
    p.add_argument("--prep-cache", dest="prep_cache_dir", default=None,
                   metavar="DIR",
                   help="on-disk cache of prepped cases: skips the NIfTI "
                        "decode, z-score and bbox when the pool revisits a "
                        "case (one canvas-sized npz per case; the JAX "
                        "package's file names, so one DIR serves both)")
    p.add_argument("--debug-nans", action="store_true",
                   help="stop with FloatingPointError at the first step whose "
                        "loss or gradient norm is not finite")
    p.add_argument("--debug-checks", action="store_true",
                   help="check the pool's foreground tables and patch bounds "
                        "at start-up")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (hand-written kernels) or cpu (plain torch ops)")
    return p


def _split(cases, args):
    if args.folds is not None or args.fold is not None:
        if args.folds is None or args.fold is None:
            raise ValueError("--folds and --fold must be given together")
        train_dirs, val_dirs = kfold_split(cases, args.folds, args.fold)
        return train_dirs, val_dirs, f"fold {args.fold}/{args.folds}"
    n_val = max(1, int(len(cases) * args.val_frac)) if len(cases) > 1 else 0
    return cases[n_val:] or cases, cases[:n_val], f"val-frac {args.val_frac}"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.ema_decay is not None and not 0.0 < args.ema_decay < 1.0:
        print(f"error: --ema-decay must be in (0, 1), got {args.ema_decay}",
              file=sys.stderr)
        return 2
    try:
        from ..infer.predictor import resolve_device

        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    exp = resolve_experiment(args)
    t = exp.train
    if t.rot90_axial and (t.patch[0] != t.patch[1]
                          or t.coarse_patch[0] != t.coarse_patch[1]):
        print("error: --rot90 needs square (X, Y) patch planes "
              f"(patch={t.patch}, coarse={t.coarse_patch})", file=sys.stderr)
        return 2
    if not args.data:
        print("error: --data is required (a BraTS root, or --synthetic N "
              "--data <dir> to generate data)", file=sys.stderr)
        return 2
    if args.synthetic > 0:
        from ..data.synthetic import write_dataset

        os.makedirs(args.data, exist_ok=True)
        write_dataset(args.data, args.synthetic, shape=tuple(args.synthetic_shape),
                      hard=args.synthetic_hard)
    cases = discover_cases(args.data)
    if not cases:
        print(f"error: no BraTS cases found under {args.data}", file=sys.stderr)
        return 2
    try:
        train_dirs, val_dirs, split = _split(cases, args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"[train] {len(train_dirs)} train / {len(val_dirs)} val cases "
          f"({split}); preset={exp.name} workdir={exp.workdir} "
          f"device={device}", flush=True)

    from ..train.loop import train_stage

    stages = []
    if args.stage in ("all", "coarse") and exp.coarse_unet is not None:
        stages.append("coarse")
    if args.stage in ("all", "fine"):
        stages.append("fine")
    if args.init_from and len(stages) != 1:
        print("error: --init-from requires an explicit --stage "
              "fine|coarse (one weights file cannot seed both cascade "
              "stages)", file=sys.stderr)
        return 2
    kd_teachers = kd_config = None
    if args.distill_from:
        import dataclasses

        from ..train.distill import KDConfig, build_teachers
        from .common import load_stage_params

        kd_teachers = build_teachers(
            exp.unet, [load_stage_params(dataclasses.replace(exp, workdir=wd),
                                         "fine") for wd in args.distill_from],
            device)
        kd_config = KDConfig(kd_weight=args.kd_weight,
                             temperature=args.kd_temperature)
        print(f"[train] distilling from {len(kd_teachers)} teacher(s)",
              flush=True)
    env = None
    if device.type == "cuda":
        from ..parallel.mesh import make_mesh

        env = make_mesh()
        if env.n_data > 1:
            print(f"[train] data-parallel over {env.n_data} cards", flush=True)
    for stage in stages:
        res = train_stage(exp, train_dirs, stage=stage, val_dirs=val_dirs,
                          device=device, env=env, profile=args.profile,
                          kd_teachers=kd_teachers if stage == "fine" else None,
                          kd_config=kd_config, init_from=args.init_from,
                          debug_nans=args.debug_nans)
        if res.preempted:
            print(f"[train] stage {stage} PREEMPTED (SIGTERM): resumable "
                  "checkpoint saved; rerun the same command to continue",
                  flush=True)
            return 3
        print(f"[train] stage {stage} done: {res.final_metrics}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
