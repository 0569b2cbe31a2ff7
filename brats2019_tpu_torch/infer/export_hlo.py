"""The predict program as ``torch.export`` programs (reference:
``brats2019_tpu/infer/export_hlo.py``, whose artifact is serialized
StableHLO; the file keeps its name so the two are found side by side).

``export --stablehlo`` writes the deployable form of the serving program:
``torch.export`` ``ExportedProgram``s saved as ``.pt2``, in which every
hand-written kernel of the predict path is a ``brats_torch::`` operator node
(``ops/library.py``). Loaded and run on a card, those nodes launch the same
CUDA C++ and Triton kernels as the eager program; on the CPU, their plain
versions. A program is exported for the device of the predictor it was
traced from, with the conv backend (``ops.set_backend``) set at that time.

Artifacts, written to ``<out_dir>`` (the CLI's ``<workdir>/torch_export/``):

* the split cascade (the flagship serving program): two programs,
  ``stage_roi.pt2``   (params_coarse, image) -> (tiles, start) and
  ``stage_fine.pt2``  (params_fine, tiles, start) -> (labels_roi, start);
* every other program (the staged sweep, the monolithic one): one
  ``predict.pt2`` (params_fine, params_coarse or None, image) ->
  (labels_roi, start);
* ``manifest.json``: the torch version, preset, canvas, tile, device (and
  the card's name and the SM count its conv plans assume), conv backend,
  postprocessing, the pipeline, and per program its file, bytes and
  flat input signature (name, shape, dtype in input order), so a consumer
  can wire buffers without tracing anything.

Weights are runtime INPUTS, as in the reference (:24-25): each net's flat
parameter dict under the JAX package's names (``params/DoubleConv_0/...``,
``utils/weights.py``), keys in sorted order, f32, then the canvas image
(bf16). The programs hold no weight values (their signatures have no
parameter or buffer input); pair them with the ``params.{npz,safetensors}``
export of the same CLI.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

PREFIX = "params/"
STAGE_ROI, STAGE_FINE, PREDICT = "stage_roi.pt2", "stage_fine.pt2", "predict.pt2"


def flat_params(net) -> dict:
    """``net``'s weights as a program input: the flat dict under the JAX
    package's names, in sorted key order, on the net's device."""
    sd = net.state_dict()
    return {PREFIX + k.replace(".", "/"): sd[k]
            for k in sorted(sd)}


def params_input(params, device) -> Optional[dict]:
    """A flat params dict (NumPy arrays or tensors, e.g. a loaded
    ``params.npz``) as a program input: f32 tensors on ``device``, keys
    sorted as at export; None stays None."""
    if params is None:
        return None
    out = {}
    for k in sorted(params):
        v = params[k]
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.asarray(v, dtype=np.float32))
        out[k] = v.to(device=device, dtype=torch.float32)
    return out


class _Bound(torch.nn.Module):
    """A program's method with the nets it runs as submodules, so
    ``functional_call`` can swap their weights for the program's inputs."""

    def __init__(self, program, method: str, nets: dict):
        super().__init__()
        for name, net in nets.items():
            self.add_module(name, net)
        self._call = getattr(program, method)

    def forward(self, *args):
        return self._call(*args)


class _Exported(torch.nn.Module):
    """What is exported: the leading arguments are the flat params of the
    nets named in ``nets`` (or None), the rest go to the bound method. The
    bound module is not a submodule, so none of its weights is captured as a
    parameter: every weight the method reads is an input."""

    def __init__(self, bound: _Bound, nets):
        super().__init__()
        object.__setattr__(self, "_bound", bound)
        self._nets = tuple(nets)

    def forward(self, *args):
        k = len(self._nets)
        swap = {}
        for name, flat in zip(self._nets, args[:k]):
            if flat is None:
                continue
            for key, v in flat.items():
                swap[f"{name}.{key[len(PREFIX):].replace('/', '.')}"] = v
        want = {name for name, _ in self._bound.named_parameters()}
        if set(swap) != want:
            raise KeyError(f"the params inputs miss {sorted(want - set(swap))} "
                           f"and have no net for {sorted(set(swap) - want)}")
        # the cached compute-dtype kernels (non-persistent buffers) are not
        # read when traced: each conv casts its kernel input in the program
        return torch.func.functional_call(self._bound, swap, tuple(args[k:]))


def _signature(names, args) -> list:
    """[{name, shape, dtype}] of the program's flat inputs, in input order:
    a params dict's tensors by key, then the tensors."""
    out = []
    for name, arg in zip(names, args):
        if arg is None:
            continue
        items = ([(f"{name}/{k}", v) for k, v in arg.items()]
                 if isinstance(arg, dict) else [(name, arg)])
        out += [{"name": n, "shape": list(t.shape),
                 "dtype": str(t.dtype).replace("torch.", "")} for n, t in items]
    return out


def _export(program, method, nets: dict, names, args, path: str) -> dict:
    """Export ``program.method`` over ``args`` (the flat params of each net
    in ``nets`` first, None where the net is None) to ``path``; returns its
    manifest entry and the ``ExportedProgram``."""
    mod = _Exported(_Bound(program, method,
                          {k: v for k, v in nets.items() if v is not None}),
                   list(nets))
    with torch.no_grad():
        ep = torch.export.export(mod, tuple(args), strict=False)
    held = [s.kind.name for s in ep.graph_signature.input_specs
            if s.kind.name in ("PARAMETER", "BUFFER")]
    if held:
        raise RuntimeError(f"{os.path.basename(path)}: the program holds "
                           f"{len(held)} parameter or buffer inputs")
    # the example inputs would be saved with the program: the weights among
    # them, and the canvas
    ep.example_inputs = None
    torch.export.save(ep, path)
    sig = _signature(names, args)
    n_user = sum(1 for s in ep.graph_signature.input_specs
                 if s.kind.name == "USER_INPUT"
                 and isinstance(s.arg, torch.export.graph_signature.TensorArgument))
    if n_user != len(sig):
        raise RuntimeError(f"{os.path.basename(path)}: {n_user} user inputs, "
                           f"the signature names {len(sig)}")
    return {"file": os.path.basename(path), "bytes": os.path.getsize(path),
            "inputs_flat": sig}, ep


def _zero_outputs(ep, device) -> list:
    """Zero tensors of the shapes and dtypes of ``ep``'s outputs (the next
    stage's example inputs), without running the program."""
    out = ep.graph.find_nodes(op="output")[0].args[0]
    return [torch.zeros(tuple(n.meta["val"].shape), dtype=n.meta["val"].dtype,
                        device=device) for n in out]


def export_predict_program(predictor, out_dir: str,
                           check: bool = False) -> List[str]:
    """Export ``predictor``'s device program(s) as ``torch.export`` programs
    (``.pt2``) and a ``manifest.json`` into ``out_dir``; returns the paths
    written. ``check=True`` loads them, runs them on the linspace canvas and
    asserts the labels and start equal the eager program's exactly."""
    from .. import ops

    os.makedirs(out_dir, exist_ok=True)
    # remove stale artifacts first: run_exported dispatches on file
    # existence, so a leftover stage_roi.pt2 of an earlier cascade export
    # would shadow a freshly written predict.pt2
    for old in os.listdir(out_dir):
        if old.endswith(".pt2") or old == "manifest.json":
            os.remove(os.path.join(out_dir, old))
    program = predictor.program
    dev = predictor.device
    canvas = tuple(predictor.canvas)
    image = torch.zeros(canvas + (4,), dtype=torch.bfloat16, device=dev)
    pf = flat_params(predictor.fine)
    pc = None if predictor.coarse is None else flat_params(predictor.coarse)
    exp = predictor.exp
    manifest: dict = {
        "torch_version": torch.__version__,
        "preset": exp.name,
        "canvas": list(canvas),
        "tile": list(exp.infer.tile),
        "device": str(dev),
        "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else None),
        "sm_count": _plan_sms(dev),
        "backend": ops.get_backend(),
        "postproc": exp.infer.postproc,
        "modules": {},
    }
    written: List[str] = []
    if hasattr(program, "stage_finish"):
        roi_path = os.path.join(out_dir, STAGE_ROI)
        manifest["modules"]["stage_roi"], ep = _export(
            program, "stage_roi", {"coarse": predictor.coarse},
            ("params_coarse", "image"), (pc, image), roi_path)
        written.append(roi_path)
        tiles, start = _zero_outputs(ep, dev)
        fine_path = os.path.join(out_dir, STAGE_FINE)
        manifest["modules"]["stage_fine"], _ = _export(
            program, "stage_finish", {"fine": predictor.fine},
            ("params_fine", "tiles", "start"), (pf, tiles, start), fine_path)
        written.append(fine_path)
        manifest["pipeline"] = [
            "stage_roi(params_coarse, image) -> (tiles, start)",
            "stage_fine(params_fine, tiles, start) -> (labels_roi, start)",
        ]
    else:
        nets = {"fine": predictor.fine, "coarse": program.coarse}
        pred_path = os.path.join(out_dir, PREDICT)
        manifest["modules"]["predict"], _ = _export(
            program, "__call__", nets,
            ("params_fine", "params_coarse", "image"),
            (pf, pc if program.coarse is not None else None, image), pred_path)
        written.append(pred_path)
        manifest["pipeline"] = [
            "predict(params_fine, params_coarse_or_none, image)"
            " -> (labels_roi, start)"
        ]
    man_path = os.path.join(out_dir, "manifest.json")
    manifest["checked"] = False
    _write_json(man_path, manifest)
    if check:   # the loader reads the manifest just written
        _roundtrip_check(predictor, out_dir)
        manifest["checked"] = True
        _write_json(man_path, manifest)
    written.append(man_path)
    return written


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _plan_sms(device) -> int:
    """The SM count the conv plans of ``device`` assume: the card's, or off
    a card the H100's that ``ops.conv`` plans for."""
    from ..ops import conv

    device = torch.device(device)
    return conv.SM_COUNT if device.type != "cuda" else conv._sm_count(device)


def load_exported(out_dir: str):
    """The exported program(s) of ``out_dir`` as one callable
    ``(params_fine, params_coarse, image) -> (labels_roi, start)``, loaded
    once. Like :func:`run_exported` it needs the ``brats_torch::`` operator
    definitions (``brats2019_tpu_torch.ops``) and none of the model code.

    A program holds the shapes of the conv's InstanceNorm partials, which a
    card's plan sizes by its SM count, so a call on a device whose SM count
    differs from the manifest's (another card model) raises: export the
    program again there."""
    from .. import ops  # noqa: F401  (defines the brats_torch:: operators)

    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)

    def load(name):
        return torch.export.load(os.path.join(out_dir, name)).module()

    if os.path.exists(os.path.join(out_dir, STAGE_ROI)):
        roi, fine = load(STAGE_ROI), load(STAGE_FINE)

        def run(params_fine, params_coarse, image):
            tiles, start = roi(params_input(params_coarse, image.device), image)
            return fine(params_input(params_fine, image.device), tiles, start)
    else:
        pred = load(PREDICT)

        def run(params_fine, params_coarse, image):
            return pred(params_input(params_fine, image.device),
                        params_input(params_coarse, image.device), image)

    def call(params_fine, params_coarse, image):
        sms = _plan_sms(image.device)
        if sms != manifest["sm_count"]:
            raise RuntimeError(
                f"{out_dir} was exported for {manifest['device']} "
                f"({manifest['card'] or 'no card'}, plans for "
                f"{manifest['sm_count']} SMs); {image.device} plans for {sms} "
                f"SMs: export the program again on this device")
        with torch.no_grad():
            return run(params_fine, params_coarse, image)

    return call


def run_exported(out_dir: str, params_fine, params_coarse, image):
    """Load and run the exported program(s) of ``out_dir``: (labels_roi,
    start). ``params_*`` are flat params dicts (NumPy arrays or tensors,
    under the JAX package's names; ``params_coarse`` None without a
    cascade), ``image`` the bf16 canvas on the device the programs were
    exported for. This is what a consumer of the artifact does: it needs
    the port's operator definitions (``import brats2019_tpu_torch.ops``, which
    this function does) and none of its model code."""
    return load_exported(out_dir)(params_fine, params_coarse, image)


def linspace_canvas(canvas, device) -> torch.Tensor:
    """The check's input (reference :144-159): a deterministic non-trivial
    bf16 canvas, linspace(-1, 1) over every value, so the argmax paths are
    exercised."""
    n = int(np.prod(canvas)) * 4
    image = np.linspace(-1, 1, n).astype(np.float32).reshape(tuple(canvas) + (4,))
    return torch.from_numpy(image).to(device=device, dtype=torch.bfloat16)


def _roundtrip_check(predictor, out_dir: str) -> None:
    image = linspace_canvas(predictor.canvas, predictor.device)
    live_labels, live_start = predictor.predict_device(image)
    pc = None if predictor.coarse is None else flat_params(predictor.coarse)
    got_labels, got_start = run_exported(
        out_dir, flat_params(predictor.fine), pc, image)
    for what, a, b in (("labels", live_labels, got_labels),
                       ("start", live_start, got_start)):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(
                f"exported program's {what} differ from the eager program's "
                f"({tuple(b.shape)} {b.dtype} against {tuple(a.shape)} "
                f"{a.dtype}; {int((a != b).sum()) if a.shape == b.shape else '?'}"
                f" values differ)")
