"""The fine network of a configuration, found by the names in its file.

A configuration file's ``experiment`` may carry one section

    "network": {"config": "<module>:<Class>", "reference": "<name>"}

``config`` names the program's frozen dataclass that ``experiment.unet``,
the fine network's section, fills field by field (the harness builds it);
``reference`` names the module ``perfbench/reference/<name>.py``, which
gives three plain float32 PyTorch functions and imports nothing of the
program:

* ``param_shapes(cfg) -> {name: shape}``: the weights in the flat export
  naming that the program loads (``cfg``: the ``unet`` section);
* ``forward(params, cfg, x, quant=None)``: (N, D, H, W, C) -> logits
  (N, D, H, W, K) without TF32, ``quant`` a :class:`unet.Quant` control;
* ``program_flops(exp) -> float``: the FLOPs of one volume's predict
  program (``exp``: the file's ``experiment``).

Without the section the network is the U-Net. A cascade's coarse net
(``coarse_unet``) is the U-Net whatever the section says.
"""

from __future__ import annotations

import importlib
import re

DEFAULT = {"config": "brats2019_tpu_torch.configs.presets:UNetConfig", "reference": "unet"}


def section(exp: dict) -> dict:
    """The ``network`` section of ``exp``, the U-Net's where it has none."""
    net = exp.get("network")
    if net is None:
        return dict(DEFAULT)
    if set(net) != set(DEFAULT):
        raise KeyError(f"network takes the keys {sorted(DEFAULT)}, not {sorted(net)}")
    return dict(net)


def reference(exp: dict):
    """The reference module of ``exp``'s fine network."""
    name = section(exp)["reference"]
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"network.reference {name!r} is not a module name")
    return importlib.import_module(f"{__package__}.{name}")
