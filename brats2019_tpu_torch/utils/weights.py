"""The weight bridge between the JAX package's exported params and the
port's modules.

The exchange format is ``brats2019_tpu/train/checkpoint.py`` export_params
(:172-205): a flat dict of numpy arrays keyed by the flax variable path,
e.g. ``params/DoubleConv_0/ConvNormAct_1/Conv_0/kernel`` (DHWIO),
``.../in_scale``, ``.../in_bias``, ``params/head/kernel`` (1,1,1,Ci,Co),
``params/head/bias`` (and ``params/aux_head_<lvl>/{kernel,bias}`` for a
deep-supervision net); on disk ``<workdir>/<stage>/params.npz`` or
``params.safetensors``, chosen by extension as ``export_params`` does. The
port's modules carry the same names, so a key maps to a state-dict key by
dropping ``params/`` and turning ``/`` into ``.``; tensors keep the JAX
layouts. A Swin UNETR (``models/swin_unetr.py``, which the JAX package does
not have) is named the same way after its module tree
(``params/swinViT/layers1/blocks_0/attn/qkv/kernel``, ...);
:func:`build_network` builds either network from its config's class.

The card's machine has no ``safetensors`` package, so the format is read
and written here in NumPy: a little-endian u64 header length, a JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (offsets into
the byte buffer that follows; an optional ``__metadata__`` entry), padded
with spaces to a multiple of 8 bytes, then the raw little-endian bytes.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Dict, Union

import numpy as np
import torch

from ..configs.presets import UNetConfig
from ..configs.swin_unetr import SwinUNETRConfig
from ..models.swin_unetr import SwinUNETR
from ..models.unet3d import UNet3D

_PREFIX = "params/"


def state_dict_from_flat(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in flat.items():
        if not k.startswith(_PREFIX):
            raise KeyError(f"not an exported param key: {k!r}")
        out[k[len(_PREFIX):].replace("/", ".")] = torch.from_numpy(
            np.array(v, dtype=np.float32)
        )
    return out


def flat_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {
        _PREFIX + k.replace(".", "/"): v.detach().cpu().float().numpy()
        for k, v in sd.items()
    }


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_params_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    np.savez(path, **flat)


# safetensors dtype names <-> little-endian NumPy dtypes (BF16 is read as
# its f32 value: NumPy has no bf16)
_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
              "I32": "<i4", "I16": "<i2", "I8": "i1", "U64": "<u8",
              "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?"}
_NP_TO_ST = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of a ``.safetensors`` file, in the header's order."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: not a safetensors file (too short)")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header of {n} bytes runs past the file")
    header = json.loads(raw[8:8 + n].decode("utf-8"))
    buf = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if not 0 <= begin <= end <= len(buf):
            raise ValueError(f"{path}: {name} lies outside the byte buffer")
        dt = info["dtype"]
        if dt == "BF16":
            bits = np.frombuffer(buf[begin:end], "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif dt in _ST_DTYPES:
            arr = np.frombuffer(buf[begin:end], _ST_DTYPES[dt]).copy()
        else:
            raise ValueError(f"{path}: {name} has unsupported dtype {dt}")
        if arr.size != math.prod(shape):
            raise ValueError(f"{path}: {name} holds {arr.size} values, "
                             f"shape {shape} needs {math.prod(shape)}")
        out[name] = arr.reshape(shape)
    return out


def save_safetensors(path: str, flat: Dict[str, np.ndarray]) -> None:
    """Write ``flat`` as a ``.safetensors`` file (names sorted, tensors
    packed in that order)."""
    header, chunks, offset = {}, [], 0
    for name in sorted(flat):
        arr = np.asarray(flat[name])
        if not arr.flags.c_contiguous:      # (ascontiguousarray makes 0-d 1-d)
            arr = arr.copy(order="C")
        dt = arr.dtype.newbyteorder("<") if arr.dtype.itemsize > 1 else arr.dtype
        if dt not in _NP_TO_ST:
            raise ValueError(f"{name}: no safetensors dtype for {arr.dtype}")
        data = arr.astype(dt, copy=False).tobytes()
        header[name] = {"dtype": _NP_TO_ST[dt], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for data in chunks:
            f.write(data)


def load_params(path: str) -> Dict[str, np.ndarray]:
    """Exported flat params from ``.npz`` or ``.safetensors`` (by extension)."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    return load_params_npz(path)


def save_params(path: str, flat: Dict[str, np.ndarray]) -> None:
    """``export_params``'s formats: ``.safetensors`` by extension, else npz."""
    if path.endswith(".safetensors"):
        save_safetensors(path, flat)
    else:
        save_params_npz(path, flat)


def param_template(cfg: UNetConfig) -> Dict[str, np.ndarray]:
    """Zeroed flat params of ``cfg``'s net: the keys, shapes and dtypes a
    loaded file must match."""
    return flat_from_state_dict(UNet3D(cfg).state_dict())


def import_params(path: str, like: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Exported params (``.npz`` / ``.safetensors``) against a template, as
    the JAX package's ``import_params``: every template key must be there
    (KeyError) with the template's shape (ValueError); cast to its dtype;
    keys the template lacks are ignored."""
    data = load_params(path)
    out = {}
    for key, ref in like.items():
        arr = np.asarray(data[key])
        if arr.shape != np.shape(ref):
            raise ValueError(f"{key}: {arr.shape} != {np.shape(ref)}")
        out[key] = arr.astype(np.asarray(ref).dtype)
    return out


def init_params(cfg: UNetConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded random params in the export format: flax's defaults —
    lecun-normal (truncated normal, fan_in) kernels, IN scale 1 and bias 0,
    zero head bias. Draws go in state-dict order from one torch.Generator
    (the numbers differ from jax.random's for the same seed)."""
    require_unet(cfg, "init_params")
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in UNet3D(cfg).named_parameters():
        t = torch.empty(p.shape)
        if name.endswith("kernel"):
            fan_in = math.prod(p.shape[:-1])
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)
        elif name.endswith("in_scale"):
            t.fill_(1.0)
        else:
            t.zero_()
        sd[name] = t
    return flat_from_state_dict(sd)


def require_unet(cfg, what: str) -> None:
    """Refuse, in one line, a network other than the U-Net on a path that
    runs the U-Net only."""
    if not isinstance(cfg, UNetConfig):
        raise TypeError(f"{what} runs the U-Net only, not a {type(cfg).__name__}")


def build_network(
    cfg: Union[UNetConfig, SwinUNETRConfig],
    params: Union[str, Dict[str, np.ndarray]],
    device: Union[str, torch.device] = "cpu",
) -> torch.nn.Module:
    """The network of ``cfg``'s class (``UNet3D`` or ``SwinUNETR``) in eval
    mode on ``device`` holding ``params`` (a flat export dict or a
    ``params.{npz,safetensors}`` path); every key must match (strict load)."""
    model = SwinUNETR(cfg) if isinstance(cfg, SwinUNETRConfig) else UNet3D(cfg)
    flat = load_params(params) if isinstance(params, str) else params
    model.load_state_dict(state_dict_from_flat(flat), strict=True)
    return model.to(device).eval().requires_grad_(False)


# the name the U-Net paths and tests build by; a path that runs the U-Net
# only refuses another network once, with :func:`require_unet`, first
build_unet = build_network
