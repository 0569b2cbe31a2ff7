"""``import-torch`` for the PyTorch port (reference:
``brats2019_tpu/cli/import_torch.py``, :39-129): bring the weights of a
network trained with the original PyTorch code over.

Usage:
    python -m brats2019_tpu_torch.cli.import_torch checkpoint.pt
        [--preset reference_parity] [--stage fine|coarse] [--workdir DIR]
        [--out PATH | --format npz|safetensors] [--map mapping.json] [--list]

Reads a ``torch.save``'d state dict of a reference-topology U-Net (double
3^3 conv + InstanceNorm + act blocks, 2x down / up, a 1^3 head) and writes
the port's flat params export to ``<workdir>/<stage>/params.{npz,
safetensors}``, the file predict / serve / evaluate prefer
(``cli/common.py`` ``load_stage_params``), so the imported model serves at
once:

    python -m brats2019_tpu_torch.cli.import_torch ref.pt --preset reference_parity
    python -m brats2019_tpu_torch.cli.predict <case_dir> --preset reference_parity

The mapping is structural (registration order + shape checks,
``utils/torch_import.py``); ``--list`` prints both inventories and ``--map``
takes an explicit {slot: torch_key} JSON. The space-to-depth presets
(``cascade``, ``inference``) have no torch counterpart (their first conv
takes space-to-depth'd input) and are refused: import into a plain-stem
preset, then distill onto the flagship (``train --distill-from``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from ..configs.presets import PRESETS, get_preset
from ..utils import torch_import as ti
from ..utils.weights import param_template, save_params


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="brats2019_tpu_torch.import_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src", help="torch checkpoint (.pt/.pth: state dict, "
                               "wrapper dict, or pickled module; or "
                               ".safetensors)")
    p.add_argument("--preset", default="reference_parity",
                   choices=sorted(PRESETS))
    p.add_argument("--stage", default="fine", choices=("fine", "coarse"))
    p.add_argument("--workdir", default=None, help="override the preset workdir")
    p.add_argument("--out", default=None,
                   help="explicit output path (.npz/.safetensors); default "
                        "<workdir>/<stage>/params.<format>")
    p.add_argument("--format", default="npz", choices=("npz", "safetensors"))
    p.add_argument("--map", dest="map_file", default=None,
                   help="explicit {slot: torch_key} JSON mapping")
    p.add_argument("--list", action="store_true",
                   help="print both inventories (target slots + torch "
                        "tensors) and exit without writing")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    exp = get_preset(args.preset)
    if args.workdir:
        exp = dataclasses.replace(exp, workdir=args.workdir)
    unet_cfg = exp.unet if args.stage == "fine" else exp.coarse_unet
    if unet_cfg is None:
        print(f"error: preset {args.preset!r} has no {args.stage} stage",
              file=sys.stderr)
        return 2
    if unet_cfg.stem_downsample != 1:
        print(f"error: preset {args.preset!r} uses the space-to-depth stem "
              f"(stem_downsample={unet_cfg.stem_downsample}): its first conv "
              "has no torch counterpart. Import into a plain-stem preset "
              "(--preset reference_parity), then distill onto the flagship "
              "(train --distill-from).", file=sys.stderr)
        return 2

    like = param_template(unet_cfg)
    state = ti.load_torch_state(args.src)
    if args.list:
        print(f"target slots ({args.preset}/{args.stage}):")
        print(ti.describe_slots(like))
        print(f"\ntorch tensors in {args.src}:")
        print(ti.describe_state(state))
        return 0

    try:
        mapping = ti.load_mapping(args.map_file) if args.map_file else None
        params, notes = ti.import_torch_params(state, like, mapping)
    except ti.TorchImportError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    for n in notes:
        print(f"note: {n}", file=sys.stderr)

    out = args.out
    if out is None:
        stage_dir = os.path.join(exp.workdir, args.stage)
        os.makedirs(stage_dir, exist_ok=True)
        out = os.path.join(stage_dir, f"params.{args.format}")
    else:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_params(out, params)
    n_params = sum(int(v.size) for v in params.values())
    print(f"imported {n_params:,} params from {args.src} -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
