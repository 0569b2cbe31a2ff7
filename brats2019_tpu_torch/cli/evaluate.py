"""``evaluate`` for the PyTorch port (reference:
``brats2019_tpu/cli/evaluate.py`` :31-255).

Usage:
    python -m brats2019_tpu_torch.cli.evaluate <root> [--preset cascade]
        [--workdir DIR] [--device cuda] [--use-existing] [--out metrics.json]
        [--hd95] [--sens-spec] [--folds K --fold I] [--shard I/N]
        [--ensemble WORKDIR ...] [--multichip spatial|sweep|cascade]

Predicts every case under <root> that has ground-truth labels (``*_seg``)
and reports per-case and mean Dice for the BraTS regions WT/TC/ET (and with
``--hd95`` the Hausdorff95 in mm, with ``--sens-spec`` the sensitivity and
specificity): the offline stand-in for the official online evaluator. The
JSON of ``--out`` is the reference's: ``{"mean", "per_case", "n_cases"}``.
``--use-existing`` scores the ``*_pred.nii.gz`` files already written instead
of predicting. ``--ensemble`` evaluates the checkpoint ensemble of the primary
``--workdir`` model and each listed workdir's model (mean probabilities).
``--device cuda`` (the default) on a host without a card is an error;
``--device cpu`` runs the plain torch ops. ``--multichip MODE`` predicts
each case over a mesh of shards (``infer/multichip.py``; the mesh is
``--device``: ``cuda`` every local card, or a comma-separated list of shard
devices), with ``--ensemble`` in ``cascade`` mode only; it cannot be combined
with ``--use-existing``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from ..configs.presets import PRESETS
from ..data.case import discover_cases, kfold_split, load_case, seg_path
from ..data.constants import disk_to_internal
from ..train.metrics import region_dice_np, region_hd95_np, region_sens_spec_np
from .common import (
    filter_shard,
    load_ensemble_members,
    load_stage_params,
    mesh_from_device_arg,
    multichip_mode_notes,
    resolve_experiment,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="brats2019_tpu_torch.evaluate",
                                description=__doc__)
    p.add_argument("root", help="BraTS root (or one case dir) with *_seg labels")
    p.add_argument("--preset", default="cascade", choices=sorted(PRESETS))
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (hand-written kernels) or cpu "
                        "(plain torch ops)")
    p.add_argument("--use-existing", action="store_true",
                   help="score existing *_pred.nii.gz instead of predicting")
    p.add_argument("--out", default=None, help="write JSON metrics here")
    p.add_argument("--hd95", action="store_true",
                   help="also report Hausdorff95 (mm) per region; an "
                        "empty-vs-nonempty region scores the volume diagonal "
                        "(the online evaluator's convention)")
    p.add_argument("--sens-spec", action="store_true",
                   help="also report per-region sensitivity/specificity")
    p.add_argument("--folds", type=int, default=None,
                   help="score only fold I of the deterministic K-way split "
                        "that train --folds uses; requires --fold")
    p.add_argument("--fold", type=int, default=None)
    p.add_argument("--ensemble", default=None, nargs="+", metavar="WORKDIR",
                   help="evaluate the checkpoint ensemble of the primary "
                        "--workdir model and each listed workdir's model "
                        "(mean probabilities, as predict --ensemble)")
    p.add_argument("--multichip", default=None,
                   choices=("spatial", "sweep", "cascade"),
                   help="predict each case over a mesh of shards "
                        "(infer/multichip.py); the mesh is --device")
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="process only the cases whose stable name-hash lands "
                        "in shard I of N (the assignment of serve --shard)")
    p.add_argument("--min-component-voxels", type=int, default=None,
                   help="override the preset's small-component filter "
                        "(0 disables)")
    p.add_argument("--et-min-voxels", type=int, default=None,
                   help="override the preset's tiny-ET relabel threshold "
                        "(tiny ET -> NCR; 0 disables)")
    p.add_argument("--seed", type=int, default=None)
    return p


class _Refused(Exception):
    """A usage error: printed, exit code 2."""


def _select_cases(args):
    """The labelled cases to score: the fold (of the unfiltered list, as
    train --folds indexes it) or the shard."""
    cases = discover_cases(args.root)
    if args.folds is not None or args.fold is not None:
        if args.folds is None or args.fold is None:
            raise _Refused("--folds and --fold must be given together")
        try:
            _, cases = kfold_split(cases, args.folds, args.fold)
        except ValueError as e:
            raise _Refused(str(e))
        print(f"[evaluate] fold {args.fold}/{args.folds}: {len(cases)} "
              f"case(s)", flush=True)
    if args.shard:
        if args.folds is not None:
            raise _Refused("--shard and --folds are different partitions of "
                           "the same list; use one")
        try:
            cases = filter_shard(cases, args.shard)
        except ValueError as e:
            raise _Refused(str(e))
        print(f"[evaluate] shard {args.shard}: {len(cases)} case(s)",
              flush=True)
    cases = [d for d in cases if seg_path(d)]
    if not cases:
        raise _Refused(f"no labelled cases under {args.root}"
                       + (f" in fold {args.fold}/{args.folds}"
                          if args.folds is not None else ""))
    return cases


def _predictor(args, exp):
    """The Predictor or EnsemblePredictor of the experiment."""
    try:
        params_fine = load_stage_params(exp, "fine")
    except FileNotFoundError as e:
        raise _Refused(str(e))
    params_coarse = None
    if exp.infer.cascade and exp.coarse_unet is not None:
        try:
            params_coarse = load_stage_params(exp, "coarse")
        except FileNotFoundError:
            exp = dataclasses.replace(
                exp, infer=dataclasses.replace(exp.infer, cascade=False))
    members = None
    if args.ensemble:
        try:
            members = load_ensemble_members(exp, args.ensemble,
                                            (params_fine, params_coarse))
        except FileNotFoundError as e:
            raise _Refused(str(e))
    if args.multichip:
        from ..infer.multichip import MultichipPredictor

        multichip_mode_notes(args.multichip, exp)
        try:
            pred = MultichipPredictor(exp, params_fine, mode=args.multichip,
                                      env=mesh_from_device_arg(args.device),
                                      params_coarse=params_coarse,
                                      members=members)
        except (ValueError, RuntimeError) as e:
            raise _Refused(str(e))
        print(f"[evaluate] multichip mode={args.multichip} over "
              f"{pred.env.n_data} shards"
              + (f", ensemble of {pred.num_members} members" if members
                 else ""), flush=True)
        return pred
    if "," in args.device:
        raise _Refused("a list of devices is a --multichip mesh")
    if members is not None:
        from ..infer.ensemble import EnsemblePredictor

        pred = EnsemblePredictor(exp, members, device=args.device)
        print(f"[evaluate] ensemble of {pred.num_members} members", flush=True)
        return pred
    from ..infer.predictor import Predictor

    return Predictor(exp, params_fine, params_coarse, device=args.device)


def score_case(pred, seg, header, hd95: bool, sens_spec: bool) -> dict:
    """The metrics of one case's internal labels against its ground truth,
    rounded as the reference rounds them."""
    scores = {k: round(float(v), 5) for k, v in region_dice_np(pred, seg).items()}
    if hd95:
        spacing = tuple(header.pixdim[1:4]) if header else (1.0,) * 3
        spacing = tuple(s if s > 0 else 1.0 for s in spacing)
        hd = region_hd95_np(pred, seg, spacing)
        # empty-vs-nonempty -> the volume diagonal (BraTS convention)
        diag = float(np.linalg.norm(np.asarray(pred.shape) * spacing))
        scores.update({f"HD95_{k}": round(float(diag if np.isinf(v) else v), 3)
                       for k, v in hd.items()})
    if sens_spec:
        scores.update({k: round(float(v), 5)
                       for k, v in region_sens_spec_np(pred, seg).items()})
    return scores


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    exp = resolve_experiment(args)
    try:
        cases = _select_cases(args)
        if args.ensemble and args.use_existing:
            raise _Refused("--ensemble re-predicts; it cannot be combined "
                           "with --use-existing")
        if args.multichip and args.use_existing:
            raise _Refused("--multichip re-predicts; it cannot be combined "
                           "with --use-existing")
        if args.multichip and args.ensemble and args.multichip != "cascade":
            raise _Refused("--ensemble composes only with --multichip cascade "
                           "(spatial/sweep are single-stage whole-canvas "
                           "programs)")
        predictor = None if args.use_existing else _predictor(args, exp)
    except _Refused as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    per_case = {}
    for d in cases:
        case = load_case(d, load_seg=True)
        if args.use_existing:
            from ..utils.nifti import read_nifti

            pred_path = os.path.join(d, f"{case.name}_pred.nii.gz")
            if not os.path.exists(pred_path):
                print(f"warning: missing {pred_path}; skipping", file=sys.stderr)
                continue
            pred = disk_to_internal(read_nifti(pred_path, apply_scaling=False)[0])
        else:
            pred, _ = predictor.predict_case(case)
        per_case[case.name] = score_case(pred, case.seg, case.header,
                                         args.hd95, args.sens_spec)
        print(f"[evaluate] {case.name}: " + " ".join(
            f"{k}={v:.4f}" for k, v in per_case[case.name].items()), flush=True)

    if not per_case:
        print("error: nothing evaluated", file=sys.stderr)
        return 2
    keys = next(iter(per_case.values())).keys()
    mean = {k: round(float(np.mean([c[k] for c in per_case.values()])), 5)
            for k in keys}
    print(f"[evaluate] mean over {len(per_case)} case(s): " +
          " ".join(f"{k}={v:.4f}" for k, v in mean.items()), flush=True)
    result = {"mean": mean, "per_case": per_case, "n_cases": len(per_case)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
        print(f"[evaluate] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
