"""Fixtures of the benchmark's CPU tests: a checkout-like root whose cells
are the benchmark's own, cut to a size the CPU runs in seconds (2-level
U-Nets of 4 to 8 features on 16^3 tiles, 36x36x28 cases)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SMALL = dict(levels=2, base_features=4, max_features=8)


def shrink(config: dict, f32: bool = False) -> dict:
    e = config["experiment"]
    for net in ("unet", "coarse_unet"):
        if e.get(net):
            e[net].update(SMALL)
            if f32:
                e[net]["compute_dtype"] = "float32"
    e["infer"].update(canvas=[32, 32, 32], coarse_shape=[16, 16, 16],
                      roi_shape=[16, 16, 16], tile=[16, 16, 16])
    if f32:
        e["infer"].update(tta_precision="float32", compute_dtype="float32")
    e["train"].update(patch=[16, 16, 16], pool_shape=[32, 32, 32])
    return config


def preset_config(name: str) -> dict:
    """A configuration file as ``perfbench/configs`` holds one, built from the
    program's preset ``name`` (for the reference's paths that no committed
    cell runs, such as the cascade's)."""
    import dataclasses

    from brats2019_tpu_torch.configs import get_preset

    e = json.loads(json.dumps(dataclasses.asdict(get_preset(name))))
    e["infer"]["postproc"] = "device"
    return {"preset": name, "experiment": e}


def make_root(dst: Path, f32: bool = False) -> Path:
    """``dst`` holding BENCHMARK.json and perfbench's data files, drivers and
    metric readers, the configurations and mixes cut to the tiny size."""
    (dst / "perfbench").mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for sub in ("metrics", "limits", "configs", "traffic"):
        shutil.copytree(REPO / "perfbench" / sub, dst / "perfbench" / sub,
                        dirs_exist_ok=True, ignore=shutil.ignore_patterns("__pycache__"))
    for f in (dst / "perfbench" / "configs").glob("*.json"):
        f.write_text(json.dumps(shrink(json.loads(f.read_text()), f32)))
    mixes = dst / "perfbench" / "traffic"
    cohort = json.loads((mixes / "cohort.json").read_text())
    cohort.update(volumes=3, shape=[36, 36, 28], check_volumes=2, trace_calls=1)
    (mixes / "cohort.json").write_text(json.dumps(cohort))
    train = json.loads((mixes / "train_b16.json").read_text())
    train.update(batch_per_device=4, raw_shape=[36, 36, 28], trace_timed_steps=2,
                 trace_profiled_steps=1)
    (mixes / "train_b16.json").write_text(json.dumps(train))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path / "checkout")


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
