"""Metrics logging (copy of ``brats2019_tpu/utils/logging.py``; the
original asks jax whether it is the primary process).

Console lines, a plain JSONL metrics file per stage, and TensorBoard scalars
when tensorboardX is importable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


def _is_primary_process() -> bool:
    """The port runs one process; it is the primary."""
    return True


class MetricsLogger:
    def __init__(self, workdir: str, name: str = "train"):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, f"{name}_metrics.jsonl")
        self._primary = _is_primary_process()
        self._f = open(self.path, "a", buffering=1) if self._primary else None
        self._tb = None
        if self._primary:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(os.path.join(workdir, "tb"))
            except Exception:
                pass
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        if not self._primary:
            return
        rec = {"step": step, "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            rec[prefix + k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(prefix + k, float(v), step)
        parts = " ".join(f"{prefix}{k}={float(v):.4g}" for k, v in metrics.items())
        print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
