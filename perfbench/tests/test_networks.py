"""CPU tests of the fine network that a configuration file names
(``perfbench/reference/networks.py``): the config class the harness builds,
the weights, the judge's forward and the FLOPs all follow the file's
``network`` section, and a file without one runs the U-Net as before.

Run from the checkout's root: ``python -m pytest perfbench/tests -q``.
"""

import importlib
import json
import sys
import types

import numpy as np
import pytest
import torch

from conftest import REPO, shrink
from perfbench import drivers, harness, synth, yardstick
from perfbench.reference import networks, segment, unet as ref_unet

STUB_CONFIG = '''
import dataclasses


@dataclasses.dataclass(frozen=True)
class StubNetConfig:
    in_channels: int = 4
    num_classes: int = 4
    embed_dim: int = 8
    depths: tuple = (2, 2)
'''
STUB_LABEL = 2


def _single_chip() -> dict:
    return json.loads((REPO / "perfbench/configs/single_chip.json").read_text())


def _stub_reference() -> types.ModuleType:
    """A network's reference module by the contract: one weight, logits
    that favour class ``STUB_LABEL`` everywhere."""
    mod = types.ModuleType("perfbench.reference.stubnet")
    mod.param_shapes = lambda cfg: {"params/embed/kernel": (1, 1, 1, cfg["in_channels"],
                                                            cfg["embed_dim"]),
                                    "params/norm/scale": (cfg["embed_dim"],)}

    def forward(params, cfg, x, quant=None):
        logits = torch.zeros(x.shape[:4] + (cfg["num_classes"],), device=x.device)
        logits[..., STUB_LABEL] = 3.0
        return logits

    mod.forward = forward
    mod.program_flops = lambda exp: 1.5e12
    return mod


@pytest.fixture
def stub(monkeypatch, tmp_path):
    """A configuration that names the stub network: its config class in a
    module on the path, its reference in the reference package."""
    (tmp_path / "stubnet_config.py").write_text(STUB_CONFIG)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setitem(sys.modules, "perfbench.reference.stubnet", _stub_reference())
    cfg = shrink(_single_chip())
    e = cfg["experiment"]
    e["network"] = {"config": "stubnet_config:StubNetConfig", "reference": "stubnet"}
    e["unet"] = {"in_channels": 4, "num_classes": 4, "embed_dim": 8, "depths": [2, 2]}
    return cfg


def test_default_is_the_unet_built_field_by_field():
    from brats2019_tpu_torch.configs.presets import (ExperimentConfig, InferenceConfig,
                                                     TrainConfig, UNetConfig)

    cfg = _single_chip()
    e = cfg["experiment"]
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    want = ExperimentConfig(name=e["name"], unet=UNetConfig(**tup(e["unet"])),
                            coarse_unet=None, train=TrainConfig(**tup(e["train"])),
                            infer=InferenceConfig(**tup(e["infer"])), workdir=e["workdir"])
    got = harness.experiment(cfg)
    assert got == want and type(got.unet) is UNetConfig
    assert "network" not in e and networks.section(e) == networks.DEFAULT
    assert networks.reference(e) is ref_unet


def test_a_named_network_config_is_built_field_by_field(stub):
    exp = harness.experiment(stub)
    assert type(exp.unet).__name__ == "StubNetConfig"
    assert (exp.unet.embed_dim, exp.unet.depths) == (8, (2, 2))
    stub["experiment"]["unet"]["window"] = 7
    with pytest.raises(KeyError, match="window"):
        harness.experiment(stub)


def test_a_network_section_with_other_keys_is_refused(stub):
    stub["experiment"]["network"]["classes"] = 4
    with pytest.raises(KeyError, match="network takes the keys"):
        harness.experiment(stub)


@pytest.mark.parametrize("config", ["jax.numpy:ndarray", "flax.linen:Module",
                                    "brats2019_tpu.configs.presets:ExperimentConfig"])
def test_a_forbidden_network_config_is_refused_before_import(stub, monkeypatch, config):
    def imported(name, *a, **k):
        raise AssertionError(f"imported {name}")

    monkeypatch.setattr(importlib, "import_module", imported)
    stub["experiment"]["network"]["config"] = config
    with pytest.raises(ValueError, match="forbidden"):
        harness.experiment(stub)


def test_default_flat_params_are_the_unets():
    e = shrink(_single_chip())["experiment"]
    got = drivers.flat_params(e, 7, "cpu")
    want = synth.params(ref_unet.param_shapes(e["unet"]), 7, "fine", "cpu")
    assert list(got) == list(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v.numpy()), k


def test_named_network_weights_from_its_reference(stub):
    e = stub["experiment"]
    got = drivers.flat_params(e, 7, "cpu")
    assert {k: v.shape for k, v in got.items()} == {"params/embed/kernel": (1, 1, 1, 4, 8),
                                                    "params/norm/scale": (8,)}
    assert abs(float(got["params/norm/scale"].mean()) - 1.0) < 0.2   # a norm scale: 1 + 0.1 N


def test_segmenter_runs_the_named_network(stub):
    e = stub["experiment"]
    fine = drivers.flat_params(e, 3, "cpu")
    ref = segment.Segmenter(e, fine, None, "cpu")
    vol = synth.volumes(1, (36, 36, 28), 3, "cpu")[0]
    z, _ = ref.prepare(vol)
    labels = ref.labels(ref.probs(z, ref.start(None)))
    assert labels.shape == tuple(e["infer"]["canvas"])
    assert (labels == STUB_LABEL).all()


def test_program_flops_follow_the_network(stub):
    e = _single_chip()["experiment"]
    assert networks.reference(e).program_flops(e) == yardstick.predict_program_flops(e)
    assert networks.reference(stub["experiment"]).program_flops(stub["experiment"]) == 1.5e12


def test_the_train_driver_refuses_another_network(stub):
    ctx = drivers.Context(exp=harness.experiment(stub), config=stub["experiment"], mix={},
                          seed=1, seconds=0, traced=False, device=torch.device("cpu"),
                          t0=0.0)
    with pytest.raises(ValueError, match="U-Net only"):
        drivers.load(REPO, "train").setup(ctx)
