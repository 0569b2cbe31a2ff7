"""Checkpoint / resume on ``torch.save`` (reference:
``brats2019_tpu/train/checkpoint.py``).

``<workdir>/checkpoints/<step>/state.pt`` holds the params (the flat
export-format dict, ``params/...`` keys), the optimizer state (count, Adam
moments, EMA), the step and the case cursor; the newest ``keep`` are kept.
``checkpoints/best/`` holds ``state.pt`` (params and step) and
``metric.json``, replaced at every eval whose mean Dice beats the recorded
best (``maybe_save_best`` :63). Every write goes to a temporary directory
renamed into place, and ``metric.json`` is written after the params, so a
crash never leaves a best metric ahead of its weights. Resume needs no
generator state: step RNG derives from (seed, step) (train/step.py).

:func:`export_params` writes the flat npz (or safetensors) that
``utils/weights.py`` reads.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

STATE = "state.pt"


def params_flat(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's params as CPU f32 tensors under export-format keys."""
    return {"params/" + k.replace(".", "/"): v.detach().float().cpu().clone()
            for k, v in model.state_dict().items()}


def flat_numpy(flat: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in flat.items()}


def export_params(path: str, model: torch.nn.Module) -> None:
    """Inference-only params as ``params.npz``, or ``.safetensors`` by
    extension (``utils/weights.py`` ``save_params``)."""
    from ..utils.weights import save_params

    save_params(path, flat_numpy(params_flat(model)))


def _atomic_save(obj: Any, final_dir: str) -> None:
    tmp = final_dir + f".tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(obj, os.path.join(tmp, STATE))
    if os.path.exists(final_dir):
        shutil.rmtree(final_dir)
    os.replace(tmp, final_dir)


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


class CheckpointManager:
    def __init__(self, workdir: str, keep: int = 3):
        self.dir = os.path.abspath(os.path.join(workdir, "checkpoints"))
        os.makedirs(self.dir, exist_ok=True)
        self.keep = max(keep, 1)
        self.best_dir = os.path.join(self.dir, "best")
        self._best_metric: Optional[float] = self._read_best_metric()

    def _read_best_metric(self) -> Optional[float]:
        p = os.path.join(self.best_dir, "metric.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)["metric"]
        return None

    def all_steps(self):
        """Retained checkpoint steps, ascending."""
        return sorted(int(n) for n in os.listdir(self.dir)
                      if n.isdigit()
                      and os.path.exists(os.path.join(self.dir, n, STATE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: torch.nn.Module, opt_state: dict,
             cursor: Dict[str, int]) -> None:
        state = {"params": params_flat(model), "opt_state": _cpu(opt_state),
                 "step": int(step), "cursor": dict(cursor)}
        _atomic_save(state, os.path.join(self.dir, str(step)))
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, str(s)), ignore_errors=True)

    def maybe_save_best(self, step: int, model: torch.nn.Module,
                        metric: float) -> bool:
        """Replace ``best/`` when ``metric`` beats the recorded best."""
        if self._best_metric is not None and not metric > self._best_metric:
            return False
        self._best_metric = metric
        _atomic_save({"params": params_flat(model), "step": int(step)},
                     self.best_dir)
        tmp = os.path.join(self.best_dir, "metric.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"metric": metric, "step": int(step)}, f)
        os.replace(tmp, os.path.join(self.best_dir, "metric.json"))
        return True

    def restore(self) -> Optional[dict]:
        """The latest checkpoint's state dict, or None if there is none."""
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(os.path.join(self.dir, str(step), STATE),
                          map_location="cpu", weights_only=True)

    def restore_at(self, step: int) -> dict:
        """The state dict of retained step ``step`` (FileNotFoundError when
        it is not retained)."""
        p = os.path.join(self.dir, str(step), STATE)
        if not os.path.exists(p):
            raise FileNotFoundError(f"no checkpoint of step {step} under "
                                    f"{self.dir} (retained: {self.all_steps()})")
        return torch.load(p, map_location="cpu", weights_only=True)

    def restore_params_at(self, step: int) -> Dict[str, np.ndarray]:
        """The params of retained step ``step`` as a flat export dict, in
        their stored dtype (checkpoint averaging reads every retained step
        through this)."""
        return flat_numpy(self.restore_at(step)["params"])

    def restore_best_params(self) -> Optional[Dict[str, np.ndarray]]:
        p = os.path.join(self.best_dir, STATE)
        if not os.path.exists(p):
            return None
        state = torch.load(p, map_location="cpu", weights_only=True)
        return flat_numpy(state["params"])
