"""``info`` for the PyTorch port (reference: ``brats2019_tpu/cli/info.py``,
:19-114) — environment and deployment diagnostics.

Usage:
    python -m brats2019_tpu_torch.cli.info [--preset cascade]

Prints one JSON document: torch and CUDA (the cards' names, count and
compute capability, where the JAX one reports JAX devices), the kernels'
build directory and whether ``nvcc`` is found, the resolved preset's key
shapes and FLOPs, which weights predict / serve would load per stage, and
the manifest of a program export (``stablehlo_manifest``).
The first thing to run when a deployment misbehaves.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="brats2019_tpu_torch.info",
                                description=__doc__)
    p.add_argument("--preset", default="cascade")
    return p


def gather(preset: str = "cascade") -> dict:
    import torch

    from .. import __name__ as pkg
    from ..configs.presets import PRESETS, get_preset
    from ..ops import _build
    from ..utils.flops import train_step_flops, unet_forward_flops

    info: dict = {"package": pkg}
    cuda: dict = {"available": torch.cuda.is_available(),
                  "version": torch.version.cuda}
    if cuda["available"]:
        n = torch.cuda.device_count()
        cuda["device_count"] = n
        cuda["devices"] = [
            {"name": torch.cuda.get_device_name(i),
             "capability": list(torch.cuda.get_device_capability(i))}
            for i in range(n)]
    info["torch"] = {"version": torch.__version__, "cuda": cuda}
    try:
        nvcc = _build.find_nvcc()
    except RuntimeError as e:   # no toolkit is the diagnosis
        nvcc = f"not found: {e}"
    info["kernels"] = {"nvcc": nvcc, "build_dir": str(_build.BUILD_DIR)}
    info["presets"] = sorted(PRESETS)
    if preset in PRESETS:
        exp = get_preset(preset)
        info["preset"] = {
            "name": exp.name,
            "cascade": exp.infer.cascade,
            "canvas": exp.infer.canvas,
            "tile": exp.infer.tile,
            "roi_shape": exp.infer.roi_shape,
            "tta_flips": exp.infer.tta_flips,
            "transfer_bucket": exp.infer.transfer_bucket,
            "transfer_dtype": exp.infer.transfer_dtype,
            "postproc": exp.infer.postproc,
            "unet": dataclasses.asdict(exp.unet),
            "workdir": exp.workdir,
        }
        info["flops"] = {
            "fine_forward_per_patch": unet_forward_flops(
                exp.unet, tuple(exp.train.patch)),
            "fine_train_step": train_step_flops(exp.unet, exp.train),
        }
        info["artifacts"] = _artifact_status(exp)
    return info


def _artifact_status(exp) -> dict:
    """Which weights predict / serve would load per stage, whether an
    export is staler than the newest checkpoint (the trap
    ``load_stage_params`` warns about), and the program export's manifest
    (``export --stablehlo``) when there is one."""
    from .common import _latest_checkpoint_mtime

    out: dict = {}
    for stage in ("fine", "coarse"):
        sdir = os.path.join(exp.workdir, stage)
        entry: dict = {}
        exported = [p for p in (os.path.join(sdir, "params.safetensors"),
                                os.path.join(sdir, "params.npz"))
                    if os.path.exists(p)]
        ckpt_mtime = _latest_checkpoint_mtime(sdir)
        entry["has_checkpoint"] = ckpt_mtime > 0
        if exported:
            newest = max(exported, key=os.path.getmtime)
            entry["export"] = newest
            entry["export_stale"] = ckpt_mtime > os.path.getmtime(newest)
        if entry.get("has_checkpoint") or exported:
            out[stage] = entry
    # the program export of ``export --stablehlo`` (reference key)
    man = os.path.join(exp.workdir, "torch_export", "manifest.json")
    if os.path.exists(man):
        out["stablehlo_manifest"] = man
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    json.dump(gather(args.preset), sys.stdout, indent=2, default=str)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
