"""``--profile`` on train and predict: a ``torch.profiler`` trace (host and,
on a card, CUDA activity) written in Chrome trace format as
``<dir>/trace.json`` (reference: ``jax.profiler.start_trace`` /
``stop_trace`` in ``brats2019_tpu/train/loop.py`` and ``cli/predict.py``)."""

from __future__ import annotations

import os

import torch


def start_trace(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof, device: torch.device, out_dir: str) -> str:
    """Wait for the card, stop the trace and write ``<out_dir>/trace.json``."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path
