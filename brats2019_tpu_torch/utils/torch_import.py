"""Import reference-style PyTorch checkpoints into the port (reference:
``brats2019_tpu/utils/torch_import.py``, :47-386).

The migration path for groups that trained the original PyTorch network: a
``torch.save``'d state dict of a plain-stem U-Net of the cascade's topology
(double 3^3 conv + InstanceNorm(affine) + activation blocks, 2x down / up,
a 1^3 head) becomes the port's flat params, the ``export_params`` format
(``utils/weights.py``), which predict, serve, evaluate and ``train
--init-from`` load directly.

The mapping is structural, as the reference's: by registration order plus
shape checks, never by key names. A torch ``state_dict`` keeps registration
order, and the reference topology registers blocks encoder -> decoder ->
head, the order of the port's ``DoubleConv_<i>`` / ``head``. Every slot's
shape is verified. Two torch-isms are handled:

* a conv bias feeding an InstanceNorm is dropped, with a note: the norm
  subtracts the per-channel mean, so the imported net is the same function;
* an InstanceNorm without affine tensors fills its slot with scale 1 and
  bias 0, the same function.

Running statistics are ignored (the port's InstanceNorm always uses
per-sample statistics). ``--map`` gives an explicit {slot: torch key}
mapping instead. The target is the port's flat params (keys
``params/DoubleConv_0/ConvNormAct_0/Conv_0/kernel`` ...), so, unlike the
reference, nothing here rebuilds a JAX tree.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .weights import load_safetensors

# wrapper keys commonly used around a state dict in torch checkpoints
_WRAPPER_KEYS = ("state_dict", "model_state_dict", "model", "net", "weights")
_STAT_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")
_PREFIX = "params/"

Slot = Tuple[Tuple[str, ...], str, tuple]


class TorchImportError(ValueError):
    """Structural mismatch between the torch checkpoint and the target net."""


def load_torch_state(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint file as an ordered {key: np.ndarray}: a
    ``torch.save`` pickle (state dict, wrapper dict or module; read with
    ``weights_only=True`` first) or a ``.safetensors`` file (whose writers
    usually sort keys, so it mostly needs ``--map``). Wrappers and
    ``module.`` prefixes are unwrapped, running statistics dropped."""
    if path.endswith(".safetensors"):
        state = {k: v for k, v in load_safetensors(path).items()
                 if k.split(".")[-1] not in _STAT_SUFFIXES}
        if not state:
            raise TorchImportError("safetensors file has no tensors")
        return {(k[len("module."):] if k.startswith("module.") else k): v
                for k, v in state.items()}
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # full-pickle checkpoints (torch.save(model)) need the unrestricted
        # unpickler; only for a file the user pointed the importer at
        obj = torch.load(path, map_location="cpu", weights_only=False)
    return flatten_state_dict(obj)


def flatten_state_dict(obj: Any) -> Dict[str, np.ndarray]:
    if isinstance(obj, torch.nn.Module):
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        raise TorchImportError(
            f"expected a state dict (or a wrapper dict), got {type(obj)!r}")
    if not any(isinstance(v, torch.Tensor) for v in obj.values()):
        for wk in _WRAPPER_KEYS:
            inner = obj.get(wk)
            if isinstance(inner, dict) and any(
                    isinstance(v, torch.Tensor) for v in inner.values()):
                obj = inner
                break
        else:
            raise TorchImportError(
                "no tensors found; top-level keys: "
                + ", ".join(map(repr, list(obj)[:10])))
    out: Dict[str, np.ndarray] = {}
    for k, v in obj.items():
        if not isinstance(v, torch.Tensor):
            continue
        if k.split(".")[-1] in _STAT_SUFFIXES:
            continue
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v.detach().cpu().numpy()
    if not out:
        raise TorchImportError("state dict contained no parameter tensors")
    return out


# ------------------------------------------------------------ target slots --

def enumerate_slots(params_like: Dict[str, Any]) -> List[Slot]:
    """Ordered (path, kind, shape) slots of the port's flat params: the
    ``DoubleConv`` blocks by index, within each ConvNormAct_0 then
    ConvNormAct_1, each [conv kernel, IN scale, IN bias]; then the head's
    kernel and bias. kind in {conv, in_scale, in_bias, head_kernel,
    head_bias}."""
    groups = {k[len(_PREFIX):].split("/")[0] for k in params_like}
    unknown = [g for g in groups if not (g.startswith("DoubleConv_") or g == "head")]
    if unknown:
        raise TorchImportError(
            "target net has parameter groups the torch importer does not "
            f"map (deep-supervision aux heads?): {sorted(unknown)} — "
            "import targets plain inference topologies "
            "(e.g. --preset reference_parity)")
    shape = lambda *path: tuple(np.shape(params_like[_PREFIX + "/".join(path)]))
    slots: List[Slot] = []
    for name in sorted((g for g in groups if g.startswith("DoubleConv_")),
                       key=lambda s: int(s.split("_")[1])):
        for cna in ("ConvNormAct_0", "ConvNormAct_1"):
            for path, kind in (((name, cna, "Conv_0", "kernel"), "conv"),
                               ((name, cna, "in_scale"), "in_scale"),
                               ((name, cna, "in_bias"), "in_bias")):
                slots.append((path, kind, shape(*path)))
    slots.append((("head", "kernel"), "head_kernel", shape("head", "kernel")))
    slots.append((("head", "bias"), "head_bias", shape("head", "bias")))
    return slots


def _torch_conv_to_dhwio(w: np.ndarray) -> np.ndarray:
    """(O, I, kd, kh, kw) -> (kd, kh, kw, I, O)."""
    return np.ascontiguousarray(w.transpose(2, 3, 4, 1, 0))


def _prefix(key: str) -> str:
    return key.rsplit(".", 1)[0] if "." in key else key


# ------------------------------------------------------ structural matcher --

def match_state(state: Dict[str, np.ndarray], slots: List[Slot],
                mapping: Optional[Dict[str, str]] = None):
    """Assign torch tensors to target slots: (assignment, notes). With
    ``mapping`` (``{"DoubleConv_0/ConvNormAct_0/Conv_0/kernel": "<torch
    key>", ...}``) every slot is looked up explicitly; otherwise tensors are
    consumed in state-dict order with shape checks."""
    if mapping is not None:
        return _match_explicit(state, slots, mapping)
    return _match_structural(state, slots)


def _match_explicit(state, slots, mapping):
    notes: List[str] = []
    out = {}
    for path, kind, shape in slots:
        spath = "/".join(path)
        if spath not in mapping:
            raise TorchImportError(f"--map file is missing slot {spath!r}")
        tkey = mapping[spath]
        if tkey not in state:
            raise TorchImportError(
                f"--map: torch key {tkey!r} (for {spath}) not in checkpoint")
        out[path] = _coerce(state[tkey], kind, shape, tkey)
    extra = set(mapping) - {"/".join(p) for p, _, _ in slots}
    if extra:
        notes.append(f"--map entries ignored (no such slot): {sorted(extra)}")
    return out, notes


def _coerce(arr: np.ndarray, kind: str, shape: tuple, tkey: str) -> np.ndarray:
    if kind in ("conv", "head_kernel"):
        if arr.ndim != 5:
            raise TorchImportError(
                f"{tkey}: expected a 5-D conv weight, got shape {arr.shape}")
        arr = _torch_conv_to_dhwio(arr)
    if tuple(arr.shape) != shape:
        raise TorchImportError(
            f"{tkey}: shape {tuple(arr.shape)} does not match target slot "
            f"{shape} (after layout transpose for convs) — wrong preset/"
            "stage, or a different topology; run with --list to inspect")
    return arr


def _match_structural(state, slots):
    items = list(state.items())
    notes: List[str] = []
    out = {}
    ti = 0

    def peek():
        return items[ti] if ti < len(items) else (None, None)

    i = 0
    while i < len(slots):
        path, kind, shape = slots[i]
        spath = "/".join(path)
        key, arr = peek()
        if key is None:
            raise TorchImportError(
                f"torch checkpoint ran out of tensors at slot {spath} "
                f"({len(items)} tensors for {len(slots)} slots) — "
                "different topology? run with --list to inspect")
        if kind in ("conv", "head_kernel"):
            out[path] = _coerce(arr, kind, shape, key)
            ti += 1
            # a conv bias registered right after its weight: absorbed by the
            # InstanceNorm after a 3^3 conv; the head's becomes head/bias
            nkey, narr = peek()
            if (nkey is not None and narr.ndim == 1
                    and _prefix(nkey) == _prefix(key) and nkey.endswith("bias")):
                if kind == "head_kernel":
                    hpath, hkind, hshape = slots[i + 1]
                    out[hpath] = _coerce(narr, hkind, hshape, nkey)
                    ti += 1
                    i += 2
                    continue
                notes.append(f"{nkey}: conv bias dropped (absorbed by the "
                             "following InstanceNorm — exactly equivalent)")
                ti += 1
            i += 1
        elif kind in ("in_scale", "in_bias"):
            if arr is not None and arr.ndim == 1:
                out[path] = _coerce(arr, kind, shape, key)
                ti += 1
            else:
                out[path] = (np.ones(shape, np.float32) if kind == "in_scale"
                             else np.zeros(shape, np.float32))
                notes.append(f"slot {spath}: no affine tensors in checkpoint "
                             "(InstanceNorm affine=False) — filled with identity")
            i += 1
        else:   # head_bias
            if arr is not None and arr.ndim == 1:
                out[path] = _coerce(arr, kind, shape, key)
                ti += 1
            else:
                out[path] = np.zeros(shape, np.float32)
                notes.append("head bias missing — filled with zeros")
            i += 1
    if ti < len(items):
        leftover = [k for k, _ in items[ti:]]
        raise TorchImportError(
            f"{len(leftover)} torch tensors left over after filling every "
            f"slot (first: {leftover[:4]}) — different topology? "
            "run with --list to inspect")
    return out, notes


# ------------------------------------------------------------------- top --

def import_torch_params(state: Dict[str, np.ndarray],
                        params_like: Dict[str, Any],
                        mapping: Optional[Dict[str, str]] = None):
    """Flat params with ``params_like``'s keys and dtypes (the port's
    export format) from a torch state dict: (params, notes)."""
    assignment, notes = match_state(state, enumerate_slots(params_like), mapping)
    flat = {_PREFIX + "/".join(path): arr for path, arr in assignment.items()}
    if set(flat) != set(params_like):
        raise TorchImportError(
            "internal: imported keys do not match the template "
            f"({sorted(set(flat) ^ set(params_like))[:4]})")
    return {k: np.asarray(flat[k], dtype=np.asarray(v).dtype)
            for k, v in params_like.items()}, notes


def describe_slots(params_like: Dict[str, Any]) -> str:
    return "\n".join(f"  {'/'.join(path):58s} {kind:11s} {shape}"
                     for path, kind, shape in enumerate_slots(params_like))


def describe_state(state: Dict[str, np.ndarray]) -> str:
    return "\n".join(f"  {k:58s} {tuple(v.shape)}" for k, v in state.items())


def load_mapping(path: str) -> Dict[str, str]:
    with open(path) as f:
        m = json.load(f)
    if not isinstance(m, dict) or not all(
            isinstance(k, str) and isinstance(v, str) for k, v in m.items()):
        raise TorchImportError("--map file must be a flat {slot: torch_key} "
                               "JSON object")
    return m
