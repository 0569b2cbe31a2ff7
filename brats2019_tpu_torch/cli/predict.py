"""``predict <case_dir>`` for the PyTorch port (reference:
``brats2019_tpu/cli/predict.py``).

Usage:
    python -m brats2019_tpu_torch.cli.predict <case_dir_or_root>
        [--preset cascade] [--workdir DIR] [--output PATH] [--device cuda]
        [--no-tta] [--no-cascade] [--postproc host|device]
        [--transfer-dtype bfloat16|int8] [--batch-volumes 1|2]
        [--prep-cache DIR] [--serving-depth N] [--shard I/N] [--seed N]
        [--save-probs] [--save-uncertainty] [--ensemble WORKDIR ...]
        [--multichip spatial|sweep|cascade] [--profile DIR]

Loads each stage's params from ``<workdir>/{fine,coarse}/`` (an exported
``params.{npz,safetensors}`` in the JAX package's format, or the port's own
training checkpoints: ``cli/common.py`` load_stage_params) and writes
``<case>_pred.nii.gz`` with BraTS disk labels {0,1,2,4} next to each case,
with the input header. One case goes through ``Predictor.predict_dir``, a
root of cases through the pipelined ``predict_dirs`` (decode, the device
program and postprocess + write overlap). ``--device cuda`` on a host
without a card is an error; ``--device cpu`` runs the plain torch ops.
Every preset predicts: ``models/cascade.py`` ``make_predict_fn`` picks the
split cascade, the staged multi-tile sweep or the monolithic program.
``--no-tta`` (one forward per tile) and ``--no-cascade`` (no coarse stage,
the whole canvas swept) change the preset's inference config as the
reference's flags do. ``--transfer-dtype int8`` ships the brain crop
quantized per modality to int8 (half the host->device bytes; lossy),
``--batch-volumes 2`` pairs consecutive cases of a root into one fine forward
at batch 16 (the split cascade only; ``infer/predictor.py``).

``--save-probs`` also writes ``<case>_probs.npz`` (float16 (X, Y, Z, 4) mean
class probabilities, BraTS disk class order [0, 1, 2, 4]) and
``--save-uncertainty`` the QU-BraTS maps ``<case>_unc_{whole,core,enhance}
.nii.gz``, from one probability pass per case. ``--ensemble W ...`` averages
the class probabilities of the primary ``--workdir`` model and each listed
workdir's model, then takes the argmax (``infer/ensemble.py``).
``--profile DIR`` writes a torch.profiler trace of the predict calls to
``DIR/trace.json``.

``--multichip MODE`` runs each case over a mesh of shards
(``infer/multichip.py``): ``cascade`` the flagship program distributed (the
cascade predictor's masks), ``spatial`` one whole-volume forward with the X
axis split over the shards, ``sweep`` the single-stage tile x flip sweep
striped over them. The mesh is ``--device``: ``cuda`` every local card, or a
comma-separated list of shard devices (``cuda:0,cuda:0``: two shards on one
card; ``cpu,cpu``). ``--save-probs``/``--save-uncertainty`` are refused with
it, and ``--ensemble`` with any mode but ``cascade``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from ..configs.presets import PRESETS
from ..data.case import discover_cases
from ..utils.profile import start_trace, stop_trace
from .common import (
    filter_shard,
    load_ensemble_members,
    load_serving_params,
    mesh_from_device_arg,
    multichip_mode_notes,
    resolve_experiment,
)


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
                        "(plain torch ops); with --multichip, cuda (every "
                        "local card) or a comma-separated list of shard "
                        "devices")
    p.add_argument("--transfer-dtype", default=None,
                   choices=("bfloat16", "int8"),
                   help="host->device encoding: int8 halves the link bytes "
                        "(lossy: the masks may differ from the bf16 path's)")
    p.add_argument("--postproc", default=None, choices=("host", "device"),
                   help="where the connected-component filter runs")
    p.add_argument("--min-component-voxels", type=int, default=None,
                   help="override the preset's small-component filter "
                        "(0 disables)")
    p.add_argument("--et-min-voxels", type=int, default=None,
                   help="override the preset's tiny-ET relabel threshold "
                        "(0 disables)")
    p.add_argument("--prep-cache", default=None, metavar="DIR",
                   help="on-disk transfer-payload cache: a repeat of the same "
                        "case files skips NIfTI decode, brain bbox and "
                        "crop/cast")
    p.add_argument("--serving-depth", type=int, default=None,
                   help="volumes concurrently in host prep / postprocess on "
                        "a root of cases")
    p.add_argument("--batch-volumes", type=int, default=None, choices=(1, 2),
                   help="2 = pair two volumes' fine TTA stages into one "
                        "device program at batch 16 (the split cascade only; "
                        "an odd tail runs alone)")
    p.add_argument("--save-probs", action="store_true",
                   help="also write <case>_probs.npz: the TTA (and ensemble) "
                        "mean class probabilities, float16 (X,Y,Z,4), BraTS "
                        "disk class order [0,1,2,4] (one more device pass "
                        "per case)")
    p.add_argument("--save-uncertainty", action="store_true",
                   help="also write the QU-BraTS uncertainty maps "
                        "<case>_unc_{whole,core,enhance}.nii.gz (uint8 "
                        "[0,100], 0 = certain: the binary entropy of each "
                        "region's mean probability; shares the probability "
                        "pass with --save-probs)")
    p.add_argument("--ensemble", default=None, nargs="+", metavar="WORKDIR",
                   help="checkpoint ensemble: average the class "
                        "probabilities of the primary --workdir model and "
                        "each listed workdir's model, then argmax")
    p.add_argument("--multichip", default=None,
                   choices=("spatial", "sweep", "cascade"),
                   help="run inference over a mesh of shards: 'cascade' = "
                        "the flagship program distributed (coarse stage "
                        "replicated, fine ROI tile x flip items striped, "
                        "low-res TTA reduce, one ROI psum): the cascade "
                        "predictor's masks; 'spatial' = one whole-volume "
                        "forward, X axis sharded with halo exchange; "
                        "'sweep' = tile x flip items striped (single-stage)")
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="process only the cases whose stable name-hash lands "
                        "in shard I of N (the assignment of serve --shard)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the predict calls "
                        "into DIR/trace.json")
    return p


def _emit_probs_artifacts(pred, cases, save_probs, save_unc,
                          output_dir=None) -> None:
    """One probability pass per case feeds both opt-in artifacts (the probs
    npz and the uncertainty maps), for ``Predictor`` and
    ``EnsemblePredictor`` alike; ``serve`` calls it with its output dir. It
    goes through ``probs_for_dir``, so the decode rides the payload cache."""
    if not (save_probs or save_unc):
        return
    from ..infer.predictor import save_probs_npz
    from ..infer.uncertainty import region_uncertainty_maps
    from ..utils.nifti import write_nifti

    for d in cases:
        case_name, header, probs = pred.probs_for_dir(d)
        dst = output_dir or d
        if save_probs:
            out = save_probs_npz(os.path.join(dst, f"{case_name}_probs.npz"),
                                 probs)
            print(f"[predict] {d} probs -> {out}", flush=True)
        if save_unc:
            for name, u in region_uncertainty_maps(probs).items():
                out = os.path.join(dst, f"{case_name}_unc_{name}.nii.gz")
                write_nifti(out, u, like=header)
                print(f"[predict] {d} uncertainty -> {out}", flush=True)


def _ensemble_predictor(args, exp, primary):
    """--ensemble: the mean-probability checkpoint ensemble (FileNotFoundError
    when a member's workdir has no params)."""
    from ..infer.ensemble import EnsemblePredictor

    members = load_ensemble_members(exp, args.ensemble, primary)
    if exp.infer.postproc == "device":
        print("note: --postproc device has no effect with --ensemble: it "
              "postprocesses on the host (the device connected components "
              "live in the label program, which the ensemble's probability "
              "path bypasses)", file=sys.stderr)
    for flag, name in ((args.batch_volumes, "--batch-volumes"),
                       (args.serving_depth, "--serving-depth")):
        if flag and flag > 1:
            print(f"note: {name} has no effect with --ensemble",
                  file=sys.stderr)
    pred = EnsemblePredictor(exp, members, device=args.device)
    print(f"[predict] ensemble of {pred.num_members} members", flush=True)
    return pred


def _predict_multichip(args, exp, params_fine, params_coarse, cases) -> int:
    """--multichip {cascade,spatial,sweep}: whole-volume inference over the
    mesh of ``--device`` (``infer/multichip.py``)."""
    from ..infer.multichip import MultichipPredictor

    multichip_mode_notes(args.multichip, exp, batch_volumes=args.batch_volumes,
                         serving_depth=args.serving_depth)
    members = None
    try:
        if args.ensemble:
            members = load_ensemble_members(exp, args.ensemble,
                                            (params_fine, params_coarse))
        mp = MultichipPredictor(exp, params_fine, mode=args.multichip,
                                env=mesh_from_device_arg(args.device),
                                params_coarse=params_coarse, members=members)
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"[predict] multichip mode={args.multichip} over {mp.env.n_data} "
          f"shards" + (f", ensemble of {mp.num_members} members"
                       if members else ""), flush=True)
    prof = start_trace(mp.device) if args.profile else None
    t0 = time.time()
    try:
        for d in cases:
            out = mp.predict_dir(d, args.output if len(cases) == 1 else None)
            print(f"[predict] {d} -> {out}", flush=True)
    finally:
        if prof is not None:
            path = stop_trace(prof, mp.device, args.profile)
            print(f"[predict] profiler trace written to {path}", flush=True)
    dt = time.time() - t0
    print(f"[predict] {len(cases)} case(s) in {dt:.2f}s "
          f"({len(cases) / dt:.3f} volumes/sec, multichip)", flush=True)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    exp = resolve_experiment(args)
    infer = exp.infer
    if args.no_tta:
        infer = dataclasses.replace(infer, tta_flips=False)
    if args.no_cascade:
        infer = dataclasses.replace(infer, cascade=False)
    if args.transfer_dtype:
        infer = dataclasses.replace(infer, transfer_dtype=args.transfer_dtype)
    if args.postproc:
        infer = dataclasses.replace(infer, postproc=args.postproc)
    if args.serving_depth:
        infer = dataclasses.replace(infer, serving_depth=args.serving_depth)
    if args.prep_cache:
        infer = dataclasses.replace(infer, prep_cache_dir=args.prep_cache)
    if args.batch_volumes:
        infer = dataclasses.replace(infer, batch_volumes=args.batch_volumes)
    exp = dataclasses.replace(exp, infer=infer)

    cases = discover_cases(args.case_dir)
    if args.shard:
        try:
            cases = filter_shard(cases, args.shard)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"[predict] shard {args.shard}: {len(cases)} case(s)", flush=True)
        if not cases:
            return 0     # a legitimately empty shard is not an error
    if not cases:
        print(f"error: no BraTS case found at {args.case_dir}", file=sys.stderr)
        return 2
    if args.output and len(cases) > 1:
        print("error: --output only valid for a single case", file=sys.stderr)
        return 2
    if args.multichip:
        if args.save_probs or args.save_uncertainty:
            print("error: --save-probs/--save-uncertainty are not available "
                  "with --multichip (the probs pass is a single-device "
                  "program)", file=sys.stderr)
            return 2
        if args.ensemble and args.multichip != "cascade":
            print("error: --ensemble composes only with --multichip cascade "
                  "(spatial/sweep are single-stage whole-canvas programs)",
                  file=sys.stderr)
            return 2
        try:
            exp, params_fine, params_coarse = load_serving_params(exp)
        except FileNotFoundError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return _predict_multichip(args, exp, params_fine, params_coarse, cases)
    if "," in args.device:
        print("error: a list of devices is a --multichip mesh", file=sys.stderr)
        return 2
    try:
        exp, params_fine, params_coarse = load_serving_params(exp)
        if args.ensemble:
            pred = _ensemble_predictor(args, exp, (params_fine, params_coarse))
        else:
            from ..infer.predictor import Predictor

            pred = Predictor(exp, params_fine, params_coarse, device=args.device)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    prof = start_trace(pred.device) if args.profile else None
    t0 = time.time()
    try:
        if len(cases) == 1:
            out, stats = pred.predict_dir(cases[0], args.output)
            print(f"[predict] {cases[0]} -> {out} (load {stats.load_s:.2f}s, "
                  f"device {stats.device_s:.2f}s, post {stats.post_s:.2f}s)",
                  flush=True)
        else:
            for d, out in zip(cases, pred.predict_dirs(cases)):
                print(f"[predict] {d} -> {out}", flush=True)
        _emit_probs_artifacts(pred, cases, args.save_probs,
                              args.save_uncertainty)
    finally:
        if prof is not None:
            path = stop_trace(prof, pred.device, args.profile)
            print(f"[predict] profiler trace written to {path}", flush=True)
    dt = time.time() - t0
    print(f"[predict] {len(cases)} case(s) in {dt:.2f}s "
          f"({len(cases) / dt:.3f} volumes/sec on {pred.device}"
          f"{', ensemble' if args.ensemble else ''})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
