"""PyTorch port: volume pairing (``InferenceConfig.batch_volumes`` 2,
``infer/predictor.py``) against the JAX package's, on the fixture of
``tests/test_inference.py``'s ``test_paired_volume_batching_matches_single``
(the split cascade with a stem-1 fine net, 16^3 ROI, three 32^3 volumes: one
pair and an odd tail), in f32 on the CPU.

* ``predict_arrays_many`` and ``predict_dirs`` with pairing: labels equal
  the JAX package's paired labels except on ties (top-2 gap of the JAX
  single-volume mean probabilities < 1e-5), and the port's unpaired labels
  likewise;
* the pair dispatcher: one ``stage_finish_pair`` and one ``stage_finish``
  (the odd tail) for three volumes, a pair on one lane (case i on lane
  (i // 2) mod n), and ``warmup(stage="rest")`` runs the paired stage and the
  odd tail's program.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.configs import presets as jax_presets
from brats2019_tpu.data.synthetic import make_case_arrays
from brats2019_tpu.infer.predictor import Predictor as JaxPredictor
from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.train.checkpoint import export_params
from brats2019_tpu.utils.nifti import read_nifti
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.data import synthetic
from brats2019_tpu_torch.infer.predictor import Predictor, _PairDispatcher

UCFG = dict(levels=2, base_features=4, compute_dtype="float32")
SHAPE = (32, 32, 32)
SEEDS = (3, 4, 5)
TIE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _exp(mod, **infer):
    return mod.ExperimentConfig(
        name="pair", unet=mod.UNetConfig(**UCFG), coarse_unet=mod.UNetConfig(**UCFG),
        train=mod.TrainConfig(pool_shape=SHAPE),
        infer=mod.InferenceConfig(**dict(
            dict(canvas=None, tile=(16, 16, 16), cascade=True, tta_flips=True,
                 coarse_shape=(16, 16, 16), roi_shape=(16, 16, 16),
                 min_component_voxels=0, et_min_voxels=0,
                 compute_dtype="float32", tta_precision="float32"), **infer)),
    )


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's paired labels on the arrays and on case
    directories, its single-volume probabilities (the tie reference), the
    weights as npz files and the case directories."""
    tmp = tmp_path_factory.mktemp("pair")
    params = [JaxUNet3D(jax_presets.UNetConfig(**UCFG)).init(
        jax.random.PRNGKey(k), jnp.zeros((1, 16, 16, 16, 4))) for k in (0, 1)]
    npz = []
    for name, p in zip(("fine", "coarse"), params):
        npz.append(str(tmp / f"{name}.npz"))
        export_params(npz[-1], p)
    images = [make_case_arrays(seed=s, shape=SHAPE)[0] for s in SEEDS]
    dirs = [synthetic.write_case(str(tmp / "cases" / f"BraTS19_P_{s}"), seed=s,
                                 shape=SHAPE) for s in SEEDS]
    paired = JaxPredictor(_exp(jax_presets, batch_volumes=2), *params)
    assert paired._pair_dispatcher() is not None
    single = JaxPredictor(_exp(jax_presets), *params)
    outs = paired.predict_dirs(dirs, [str(tmp / f"jax_{i}.nii.gz")
                                      for i in range(len(dirs))])
    return {
        "npz": npz, "dirs": dirs, "images": images,
        "arrays": paired.predict_arrays_many(images),
        "array_probs": [single.predict_probs_arrays(im)[0] for im in images],
        "files": [read_nifti(o, apply_scaling=False)[0] for o in outs],
        "file_probs": [single.probs_for_dir(d)[2] for d in dirs],
    }


def _port(ref, **infer):
    return Predictor(_exp(presets, **infer), *ref["npz"], device="cpu")


def _equal_but_ties(got, want, probs):
    top2 = np.sort(probs, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < TIE
    diff = got != want
    assert not (diff & ~tie).any(), int((diff & ~tie).sum())
    assert diff.mean() < 1e-3


def test_paired_arrays_match_the_jax_package(ref):
    port = _port(ref, batch_volumes=2)
    got = port.predict_arrays_many(ref["images"])
    unpaired = _port(ref).predict_arrays_many(ref["images"])
    assert len(got) == len(SEEDS)
    for g, u, want, probs in zip(got, unpaired, ref["arrays"], ref["array_probs"]):
        assert g.dtype == np.uint8 and g.shape == SHAPE
        _equal_but_ties(g, want, probs)
        _equal_but_ties(g, u, probs)


def test_paired_dirs_match_the_jax_package(ref, tmp_path):
    port = _port(ref, batch_volumes=2)
    outs = port.predict_dirs(ref["dirs"], [str(tmp_path / f"p{i}.nii.gz")
                                           for i in range(len(SEEDS))])
    for out, want, probs in zip(outs, ref["files"], ref["file_probs"]):
        got = read_nifti(out, apply_scaling=False)[0]
        assert got.shape == SHAPE and set(np.unique(got)) <= {0, 1, 2, 4}
        _equal_but_ties(got, want, probs)


def test_pair_dispatcher_runs_one_pair_and_the_odd_tail(ref, monkeypatch):
    port = _port(ref, batch_volumes=2)
    calls = []
    for name in ("stage_roi", "stage_finish", "stage_finish_pair"):
        real = getattr(port.program, name)
        monkeypatch.setattr(port.program, name,
                            lambda *a, real=real, name=name:
                            calls.append(name) or real(*a))
    port.predict_arrays_many(ref["images"])
    assert sorted(calls) == sorted(["stage_roi"] * 3 + ["stage_finish_pair",
                                                       "stage_finish"])
    assert calls.index("stage_finish_pair") < calls.index("stage_finish")
    # warmup: the paired stage and the odd tail's program under "rest"
    calls.clear()
    assert port.warmup(stage="rest") > 0
    assert calls == ["stage_roi", "stage_finish_pair", "stage_finish"]
    calls.clear()
    port.warmup(stage="primary")
    assert "stage_finish_pair" not in calls
    # a pair shares a lane; without pairing, cases go round-robin
    two = Predictor(_exp(presets, batch_volumes=2), *ref["npz"], device="cpu",
                    devices=["cpu", "cpu"])
    assert two._pairs
    pair = _PairDispatcher(two)
    assert [two._lane_of(i, pair) for i in range(5)] == [0, 0, 1, 1, 0]
    assert [two._lane_of(i) for i in range(5)] == [0, 1, 0, 1, 0]


def test_pairing_stripes_pairs_over_lanes(ref):
    """Two lanes (two CPU shards): the first pair on lane 0, the odd tail on
    lane 1, the labels those of one lane."""
    two = Predictor(_exp(presets, batch_volumes=2), *ref["npz"], device="cpu",
                    devices=["cpu", "cpu"])
    got = two.predict_arrays_many(ref["images"])
    assert set(two._lanes) == {1}
    for g, want, probs in zip(got, ref["arrays"], ref["array_probs"]):
        _equal_but_ties(g, want, probs)


@pytest.mark.parametrize("infer", [dict(batch_volumes=2, cascade=False),
                                   dict(batch_volumes=2, tta_flips=False)])
def test_pairing_needs_the_split_cascade(ref, infer):
    """Without the split cascade pairing has no paired stage: the cases run
    one by one, as in the reference (:408-417)."""
    port = Predictor(_exp(presets, **infer), ref["npz"][0],
                     ref["npz"][1] if infer.get("cascade", True) else None,
                     device="cpu")
    assert not port._pairs
    want = Predictor(dataclasses.replace(
        port.exp, infer=dataclasses.replace(port.exp.infer, batch_volumes=1)),
        ref["npz"][0], ref["npz"][1] if infer.get("cascade", True) else None,
        device="cpu").predict_arrays_many(ref["images"][:2])
    for g, w in zip(port.predict_arrays_many(ref["images"][:2]), want):
        np.testing.assert_array_equal(g, w)
