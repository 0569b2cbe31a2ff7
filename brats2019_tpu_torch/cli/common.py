"""Shared CLI plumbing (reference: ``brats2019_tpu/cli/common.py``): preset
overrides and stage params. Params load from the JAX package's export
format, ``<workdir>/<stage>/params.npz``; reading orbax checkpoints is
later work (ROADMAP queue 1 item 8)."""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np

from ..configs.presets import ExperimentConfig, get_preset
from ..utils.weights import load_params_npz


def resolve_experiment(args) -> ExperimentConfig:
    exp = get_preset(args.preset)
    if getattr(args, "workdir", None):
        exp = dataclasses.replace(exp, workdir=args.workdir)
    for flag in ("min_component_voxels", "et_min_voxels"):
        v = getattr(args, flag, None)
        if v is not None:
            exp = dataclasses.replace(
                exp, infer=dataclasses.replace(exp.infer, **{flag: v})
            )
    return exp


def load_stage_params(exp: ExperimentConfig, stage: str) -> Dict[str, np.ndarray]:
    """The exported params of ``stage`` ("fine" or "coarse") as a flat dict;
    FileNotFoundError when the workdir has none."""
    path = os.path.join(exp.workdir, stage, "params.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"No exported params for stage '{stage}' at {path} (export them "
            f"with the JAX package's export CLI)"
        )
    return load_params_npz(path)
