"""Shared CLI plumbing (reference: ``brats2019_tpu/cli/common.py``): preset
overrides, the trained params of a stage (exported, best, latest, the weight
EMA, the average of the retained steps), the serving weights, the members of
a checkpoint ensemble, the shard assignment of scale-out runs, and the
``--multichip`` mesh and operator notes."""

from __future__ import annotations

import dataclasses
import os
import sys
import zlib
from typing import Dict

import numpy as np

from ..configs.presets import ExperimentConfig, get_preset
from ..utils.weights import load_params

_TRAIN_FLAGS = ("steps", "checkpoint_every", "eval_every", "log_every",
                "ema_decay", "prep_cache_dir", "rot90_axial", "gamma_range",
                "seed")


def resolve_experiment(args) -> ExperimentConfig:
    exp = get_preset(args.preset)
    if getattr(args, "workdir", None):
        exp = dataclasses.replace(exp, workdir=args.workdir)
    for flag in _TRAIN_FLAGS:
        v = getattr(args, flag, None)
        if v is not None and not (flag == "steps" and v == 0):
            exp = dataclasses.replace(
                exp, train=dataclasses.replace(exp.train, **{flag: v})
            )
    for flag in ("min_component_voxels", "et_min_voxels"):
        v = getattr(args, flag, None)
        if v is not None:
            exp = dataclasses.replace(
                exp, infer=dataclasses.replace(exp.infer, **{flag: v})
            )
    if getattr(args, "debug_checks", False):
        exp = dataclasses.replace(
            exp, train=dataclasses.replace(exp.train, debug_checks=True))
    return exp


def _latest_checkpoint_mtime(workdir: str) -> float:
    """Newest mtime among the step checkpoints and ``best/`` under
    ``<workdir>/checkpoints`` (0.0 when none exist)."""
    root = os.path.join(workdir, "checkpoints")
    newest = 0.0
    try:
        for name in os.listdir(root):
            p = os.path.join(root, name)
            if name.isdigit() or (name == "best" and os.path.exists(
                    os.path.join(p, "state.pt"))):
                newest = max(newest, os.path.getmtime(p))
    except OSError:
        pass
    return newest


def load_stage_params(exp: ExperimentConfig, stage: str,
                      from_checkpoint_only: bool = False,
                      ) -> Dict[str, np.ndarray]:
    """Trained params of ``stage`` ("fine" or "coarse") as a flat export
    dict, by the reference's priority (:335-393): the newer of the exported
    ``<workdir>/<stage>/params.{safetensors,npz}`` while it is at least as
    new as the newest checkpoint; else ``checkpoints/best/``; else the
    latest step checkpoint. With ``from_checkpoint_only`` the exported
    files are skipped, so a re-export (``cli/export.py``) reads the current
    checkpoint, never a previous export. FileNotFoundError when the workdir
    has none of them."""
    from ..train.checkpoint import CheckpointManager, flat_numpy

    workdir = os.path.join(exp.workdir, stage)
    exported = os.path.join(workdir, "params.npz")
    found = [] if from_checkpoint_only else [
        p for p in (os.path.join(workdir, "params.safetensors"), exported)
        if os.path.exists(p)]
    if found:
        newest = max(found, key=os.path.getmtime)
        if _latest_checkpoint_mtime(workdir) > os.path.getmtime(newest):
            print(f"[params] {stage}: checkpoint is NEWER than {newest}; "
                  "loading the checkpoint", file=sys.stderr, flush=True)
        else:
            return load_params(newest)
    if not os.path.isdir(os.path.join(workdir, "checkpoints")):
        raise FileNotFoundError(
            f"No params for stage '{stage}': neither {exported} nor "
            f"checkpoints under {workdir}")
    ckpt = CheckpointManager(workdir)
    best = ckpt.restore_best_params()
    if best is not None:
        return best
    restored = ckpt.restore()
    if restored is None:
        raise FileNotFoundError(
            f"No params for stage '{stage}': neither {exported} nor a "
            f"checkpoint under {workdir}")
    return flat_numpy(restored["params"])


def _stage_checkpoints(exp: ExperimentConfig, stage: str):
    """The CheckpointManager of a stage's step checkpoints
    (FileNotFoundError when the stage has no checkpoint directory; none is
    created)."""
    from ..train.checkpoint import CheckpointManager

    workdir = os.path.join(exp.workdir, stage)
    if not os.path.isdir(os.path.join(workdir, "checkpoints")):
        raise FileNotFoundError(f"No checkpoint for stage '{stage}' under "
                                f"{workdir}")
    return CheckpointManager(workdir), workdir


def ema_stage_params(exp: ExperimentConfig, stage: str) -> Dict[str, np.ndarray]:
    """The weight EMA of a stage's latest step checkpoint as a flat export
    dict (:129-168): the tracker rides in the optimizer state
    (``opt_state["ema"]``, train/step.py). FileNotFoundError when there is no
    checkpoint or the run was trained without ``--ema-decay``."""
    ckpt, workdir = _stage_checkpoints(exp, stage)
    if ckpt.latest_step() is None:
        raise FileNotFoundError(f"No checkpoint for stage '{stage}' under "
                                f"{workdir}")
    ema = ckpt.restore()["opt_state"].get("ema")
    if ema is None:
        raise FileNotFoundError(
            f"No EMA state in stage '{stage}' checkpoints under {workdir} "
            "(train with --ema-decay to record one)")
    return {"params/" + k.replace(".", "/"): v.detach().cpu().numpy()
            for k, v in ema.items()}


def average_stage_params(exp: ExperimentConfig, stage: str,
                         last_k: int) -> Dict[str, np.ndarray]:
    """Uniform weight average of the last ``last_k`` retained step
    checkpoints of a stage (:171-238; SWA-style: one averaged model, one
    forward at serving time). Every tensor is summed in f32 in step order,
    scaled by 1/len and cast back to its stored dtype. FileNotFoundError
    when no step checkpoint exists; fewer than ``last_k`` retained (the
    ``keep`` window) are averaged with a note."""
    ckpt, workdir = _stage_checkpoints(exp, stage)
    steps = ckpt.all_steps()
    if not steps:
        raise FileNotFoundError(f"No step checkpoints to average for stage "
                                f"'{stage}' under {workdir}")
    steps = steps[-last_k:]
    if len(steps) < last_k:
        print(f"[average] {stage}: only {len(steps)} retained checkpoint(s) "
              f"(requested {last_k}) — averaging those", file=sys.stderr,
              flush=True)
    acc, like = None, None
    for s in steps:
        p = ckpt.restore_params_at(s)
        like = like or p
        p32 = {k: np.asarray(v, np.float32) for k, v in p.items()}
        acc = p32 if acc is None else {k: acc[k] + p32[k] for k in acc}
    inv = 1.0 / len(steps)
    mean = {k: np.asarray(a * inv, like[k].dtype) for k, a in acc.items()}
    print(f"[average] {stage}: averaged steps {steps}", file=sys.stderr,
          flush=True)
    return mean


def load_ensemble_members(exp: ExperimentConfig, workdirs, primary):
    """The primary model plus one member per extra workdir, for
    ``EnsemblePredictor`` (:241-277). Each member workdir is read with the
    primary's preset and stage rules (:func:`load_stage_params`); a member
    without coarse params reuses the primary's coarse stage (the cascade only
    localises the ROI), with a warning. A workdir named twice (or the
    primary's own) is warned about: its probabilities count twice in the
    mean."""
    seen = {os.path.abspath(exp.workdir)}
    for w in workdirs:
        a = os.path.abspath(w)
        if a in seen:
            print(f"warning: ensemble member {w} appears more than once "
                  f"(or is the primary --workdir); its probabilities are "
                  f"double-weighted in the mean", file=sys.stderr)
        seen.add(a)
    members = [primary]
    for w in workdirs:
        exp_w = dataclasses.replace(exp, workdir=w)
        pf = load_stage_params(exp_w, "fine")
        pc = None
        if exp.infer.cascade and exp.coarse_unet is not None:
            try:
                pc = load_stage_params(exp_w, "coarse")
            except FileNotFoundError:
                print(f"warning: no coarse checkpoint under {w}; this "
                      f"member reuses the primary coarse stage",
                      file=sys.stderr)
                pc = primary[1]
        members.append((pf, pc))
    return members


def shard_of(name: str, n: int) -> int:
    """Stable shard assignment by case name, the same on every host and in
    every run (Python's ``hash()`` is salted per process)."""
    return zlib.crc32(name.encode()) % n


def parse_shard(spec: str):
    try:
        i_s, n_s = spec.split("/")
        i, n = int(i_s), int(n_s)
    except ValueError:
        raise ValueError(f"--shard must be I/N (got {spec!r})")
    if not (n >= 1 and 0 <= i < n):
        raise ValueError(f"--shard needs 0 <= I < N (got {spec!r})")
    return i, n


def filter_shard(case_dirs, spec):
    """Apply an ``I/N`` shard spec to a case list (None: all of it): the
    batch CLIs' scale-out filter, the assignment ``serve --shard`` uses."""
    if not spec:
        return list(case_dirs)
    i, n = parse_shard(spec)
    return [d for d in case_dirs
            if shard_of(os.path.basename(os.path.normpath(d)), n) == i]


def load_serving_params(exp: ExperimentConfig):
    """The serving weights of an experiment: fine always, coarse when the
    cascade wants it, degrading to ``cascade=False`` (in the returned exp)
    when no coarse params exist. ``serve``'s SIGHUP reload does not use
    this: turning the cascade off there would change the served program."""
    params_fine = load_stage_params(exp, "fine")
    params_coarse = None
    if exp.infer.cascade and exp.coarse_unet is not None:
        try:
            params_coarse = load_stage_params(exp, "coarse")
        except FileNotFoundError:
            print("warning: no coarse checkpoint; cascade off", file=sys.stderr)
            exp = dataclasses.replace(
                exp, infer=dataclasses.replace(exp.infer, cascade=False)
            )
    return exp, params_fine, params_coarse


def mesh_from_device_arg(spec: str):
    """The mesh of a ``--multichip`` run from ``--device``: ``cuda`` every
    local card, ``cpu`` one CPU shard, or a comma-separated list of shard
    devices (``cpu,cpu`` two CPU shards, ``cuda:0,cuda:0`` two shards on
    card 0)."""
    from ..parallel.mesh import make_mesh

    if spec == "cuda":
        return make_mesh()
    return make_mesh([d.strip() for d in spec.split(",") if d.strip()])


def multichip_mode_notes(mode: str, exp: ExperimentConfig,
                         batch_volumes=None, serving_depth=None) -> None:
    """Operator notes of the three ``--multichip`` CLIs (predict, serve,
    evaluate), in one place (:396-423): the single-stage modes bypass a
    cascade preset's coarse stage, postprocessing runs on the host, and the
    single-device serving knobs do not apply."""
    if mode != "cascade" and exp.infer.cascade and exp.coarse_unet is not None:
        print("note: --multichip spatial/sweep run a single-stage "
              "whole-canvas decomposition; the preset's coarse/fine "
              "cascade is bypassed (use --multichip cascade for "
              "the cascade predictor's masks)", file=sys.stderr)
    if exp.infer.postproc == "device":
        print("note: --multichip postprocesses on the host (the device "
              "connected components live in the single-device label "
              "program)", file=sys.stderr)
    for flag, name in ((batch_volumes, "--batch-volumes"),
                       (serving_depth, "--serving-depth")):
        if flag and flag > 1:
            print(f"note: {name} has no effect with --multichip (cases run "
                  "one at a time over the whole mesh)", file=sys.stderr)
    if exp.infer.prep_cache_dir:
        print("note: --prep-cache has no effect with --multichip (the "
              "payload cache serves the single-device transfer encoding)",
              file=sys.stderr)
