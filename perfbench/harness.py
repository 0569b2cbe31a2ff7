"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is found by name under the benchmark's folder of the checkout
(``root``):

* ``BENCHMARK.json``: the cells, the metrics and which cells report them;
* ``perfbench/configs/<config>.json`` (the file ``BENCHMARK.json`` names):
  the configuration as it is run, under ``experiment``, whose optional
  ``network`` section names the fine network's config class and plain
  reference (``perfbench/reference/networks.py``);
* ``perfbench/traffic/<mix>.json``: the mix's parameters, whose ``kind``
  names the driver that reads them, ``perfbench/traffic/<kind>.py``;
* ``perfbench/metrics/<metric>.py``: a per-layer metric's reader, a function
  ``read(readings, profile) -> float | None``;
* ``perfbench/limits/<cell>.json``: the limit of each number that decides
  ``correct``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, Optional

import torch

from . import drivers
from .reference import networks

FORBIDDEN = ("jax", "jaxlib", "flax", "brats2019_tpu")


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_parts(root: Path, spec: dict, name: str):
    """(cell, configuration file, mix, limits) of the cell ``name``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "perfbench" / "limits" / f"{name}.json").read_text())
    return cell, config, mix, limits


def reports(metric: dict, cell: str, spec: dict) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed, or the metric lists
    no cells (and, per layer, the cell reports the metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = {m["name"]: m for m in spec["end_to_end"]}[metric["moves"]]
        return reports(moved, cell, spec)
    return True


def reader(root: Path, metric: str):
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _section(cls, values: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - names
    if unknown:
        raise KeyError(f"{cls.__name__} has no field {sorted(unknown)}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in values.items()})


def network_class(e: dict):
    """The program's config class of the fine network that ``e`` (a file's
    ``experiment``) names, refused before its import where its top-level
    package is forbidden."""
    module, _, name = networks.section(e)["config"].partition(":")
    if module.split(".")[0] in FORBIDDEN:
        raise ValueError(f"network.config {module!r} is in a forbidden package {FORBIDDEN}")
    return getattr(importlib.import_module(module), name)


def experiment(config: dict):
    """The program's ExperimentConfig built from the file's ``experiment``
    (every section, field by field; ``unet`` is the fine network's section,
    of the class that ``network.config`` names)."""
    from brats2019_tpu_torch.configs.presets import (ExperimentConfig, InferenceConfig,
                                                     TrainConfig, UNetConfig)

    e = config["experiment"]
    return ExperimentConfig(
        name=e.get("name", config["preset"]),
        unet=_section(network_class(e), e["unet"]),
        coarse_unet=_section(UNetConfig, e["coarse_unet"]) if e.get("coarse_unet") else None,
        train=_section(TrainConfig, e["train"]),
        infer=_section(InferenceConfig, e["infer"]),
        workdir=e.get("workdir", "runs/perfbench"))


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run(root: Path, name: str, seed: int, seconds: float, traced: bool,
        t0: float, device: Optional[str] = None, out=None) -> int:
    """One run of cell ``name``: prints the result line and returns 0, or
    returns another code and prints no result. ``device`` (tests only)
    skips the look for a card and runs where it says."""
    spec = load_spec(root)
    cell, config, mix, limits = cell_parts(root, spec, name)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"perfbench: cell {name} needs {cell['chips']} CUDA card(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ctx = drivers.Context(exp=experiment(config), config=config["experiment"], mix=mix,
                          seed=int(seed), seconds=float(seconds), traced=traced,
                          device=dev, t0=t0)
    outcome = drivers.load(root, mix["kind"]).run(ctx)

    metrics: Dict[str, dict] = {}
    if not traced:
        for m in spec["end_to_end"]:
            if reports(m, name, spec):
                metrics[m["name"]] = {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in spec["per_layer"]:
            if reports(m, name, spec):
                value = reader(root, m["name"])(outcome.readings, outcome.profile)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": outcome.memory_peak_bytes}
    checks = {k: {"value": float(outcome.checks[k]), "limit": float(v)}
              for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": device_info}
    if traced and outcome.profile is not None:
        device_info.update(busy_s=outcome.profile.busy_s,
                           window_s=outcome.profile.window_s)
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in outcome.profile.device_ops],
            "idle_gaps": [[n, s] for n, s in outcome.profile.idle_gaps]}
    result["checks"] = checks

    found = forbidden_modules()
    if found:
        print(f"perfbench: the run imported {found}", file=sys.stderr)
        return 3
    for r in outcome.readings.get("judged", []):
        print(f"judged volume {r['volume']}: " + " ".join(
            f"{k} {v}" for k, v in r.items() if k != "volume"), file=sys.stderr)
    calls = outcome.readings.get("call_s")
    if calls:
        print(f"window: {len(calls)} calls, seconds each: first "
              f"{[round(c, 3) for c in calls[:3]]} last {[round(c, 3) for c in calls[-3:]]}",
              file=sys.stderr)
    for k, v in outcome.checks.items():
        if k not in checks:
            print(f"reading {k} {v!r}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out or sys.stdout, flush=True)
    return 0
