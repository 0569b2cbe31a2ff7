"""The weight bridge between the JAX package's exported params and the
port's modules.

The exchange format is ``brats2019_tpu/train/checkpoint.py`` export_params
(:172-205): a flat dict of numpy arrays keyed by the flax variable path,
e.g. ``params/DoubleConv_0/ConvNormAct_1/Conv_0/kernel`` (DHWIO),
``.../in_scale``, ``.../in_bias``, ``params/head/kernel`` (1,1,1,Ci,Co),
``params/head/bias``; on disk ``<workdir>/<stage>/params.npz``. The port's
modules carry the same names, so a key maps to a state-dict key by dropping
``params/`` and turning ``/`` into ``.``; tensors keep the JAX layouts.
"""

from __future__ import annotations

import math
from typing import Dict, Union

import numpy as np
import torch

from ..configs.presets import UNetConfig
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


def init_params(cfg: UNetConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded random params in the export format: flax's defaults —
    lecun-normal (truncated normal, fan_in) kernels, IN scale 1 and bias 0,
    zero head bias. Draws go in state-dict order from one torch.Generator
    (the numbers differ from jax.random's for the same seed)."""
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


def build_unet(
    cfg: UNetConfig,
    params: Union[str, Dict[str, np.ndarray]],
    device: Union[str, torch.device] = "cpu",
) -> UNet3D:
    """A UNet3D in eval mode on ``device`` holding ``params`` (a flat export
    dict or a ``params.npz`` path); every key must match (strict load)."""
    flat = load_params_npz(params) if isinstance(params, str) else params
    model = UNet3D(cfg)
    model.load_state_dict(state_dict_from_flat(flat), strict=True)
    return model.to(device).eval().requires_grad_(False)
