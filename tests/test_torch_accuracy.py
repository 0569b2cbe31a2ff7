"""PyTorch port: the hard accuracy benchmark (the third clause of the parity
bar). The five arms of ``tests/test_accuracy_benchmark.py`` (single view,
8-flip TTA, the 2-member ensemble, EMA weights, the empty-ET case) run through
the port on the committed fixtures, in f32 on the CPU, on the hard cases made
by the port's copy of the generator; every bound of that file is then held
by the file's own test functions, run on the port's arms. The port's labels
equal the JAX package's on the same cases and weights except on ties (voxels
whose top-2 mean probabilities lie within TIE), which are counted: here the
arms of the TTA program (TTA, EMA weights: one compiled JAX program); the
ensemble is held to the JAX package's in ``tests/test_torch_ensemble.py``,
the single view in ``tests/test_torch_predictor.py`` and
``tests/test_torch_sweep.py``."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.configs import presets as jax_presets
from brats2019_tpu.infer.predictor import Predictor as JaxPredictor
from brats2019_tpu.models import UNet3D as JaxUNet3D
from brats2019_tpu.train.checkpoint import import_params
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.data.synthetic import make_hard_case_arrays
from brats2019_tpu_torch.infer.ensemble import EnsemblePredictor
from brats2019_tpu_torch.infer.predictor import Predictor
from brats2019_tpu_torch.utils.weights import load_params_npz

HERE = os.path.dirname(__file__)
FIXTURES = os.path.join(HERE, "fixtures", "accuracy")
SHAPE = (64, 64, 48)
TIE = 1e-5     # top-2 gap of the port's mean probabilities below which a label may flip
ARMS = ("no_tta", "tta", "ensemble2", "ema", "no_tta_empty_et")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The port's CPU path in two intra-op threads: the suite runs several
    workers on the host's cores at once, and torch's default of a thread per
    core in every worker oversubscribes them (one worker's arms took 50x
    their time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reference_bounds():
    """``tests/test_accuracy_benchmark.py`` as a module: its bound tests take
    the arms as their ``benchmark`` argument."""
    spec = importlib.util.spec_from_file_location(
        "accuracy_benchmark_bounds", os.path.join(HERE, "test_accuracy_benchmark.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BOUNDS = _reference_bounds()
BOUND_TESTS = ("test_fixture_validity", "test_tta_beats_single_view",
               "test_ensemble_beats_member_on_wt_tc", "test_ema_tracks_final_weights",
               "test_empty_et_relabel_flips_the_empty_case",
               "test_small_component_filter_helps_wt")


def _exp(mod, tta=True):
    """The benchmark's configuration (``test_accuracy_benchmark.py:43-56``)
    in either package's config classes."""
    ucfg = mod.UNetConfig(levels=2, base_features=8, compute_dtype="float32")
    return mod.ExperimentConfig(
        name="accuracy_benchmark", unet=ucfg, coarse_unet=None,
        train=mod.TrainConfig(pool_shape=SHAPE),
        infer=mod.InferenceConfig(
            canvas=SHAPE, tile=(32, 32, 32), cascade=False, tta_flips=tta,
            min_component_voxels=0, et_min_voxels=0,
            compute_dtype="float32", tta_precision="float32"),
    )


def _cases():
    hard = [make_hard_case_arrays(seed=s, shape=SHAPE) for s in (10, 11)]
    return hard, [make_hard_case_arrays(seed=13, shape=SHAPE)]


def _params(name):
    return load_params_npz(os.path.join(FIXTURES, f"{name}.npz"))


@pytest.fixture(scope="module")
def port_arms():
    """One prediction pass per arm through the port: the arms (labels, seg)
    and each arm's predictor and images."""
    m0, m1, ema = (_params(n) for n in ("hard_member0", "hard_member1",
                                         "hard_member0_ema"))
    hard, empty = _cases()
    preds = {
        "no_tta": Predictor(_exp(presets, tta=False), m0, device="cpu"),
        "tta": Predictor(_exp(presets), m0, device="cpu"),
        "ensemble2": EnsemblePredictor(_exp(presets), [(m0, None), (m1, None)],
                                       device="cpu"),
        "ema": Predictor(_exp(presets), ema, device="cpu"),
    }
    preds["no_tta_empty_et"] = preds["no_tta"]
    arms, runs = {}, {}
    for arm in ARMS:
        cases = empty if arm == "no_tta_empty_et" else hard
        arms[arm] = [(preds[arm].predict_arrays(img)[0], seg) for img, seg in cases]
        runs[arm] = (preds[arm], [img for img, _ in cases])
    return arms, runs


@pytest.fixture(scope="module")
def jax_arms():
    """The JAX package's labels of the TTA program's arms on the same cases
    (EMA weights reuse the TTA predictor's compiled program)."""
    like = JaxUNet3D(_exp(jax_presets).unet).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 4)))
    m0, ema = (import_params(os.path.join(FIXTURES, f"{n}.npz"), like)
               for n in ("hard_member0", "hard_member0_ema"))
    hard, _ = _cases()
    run = lambda pred: [pred.predict_arrays(img)[0] for img, _ in hard]
    tta = JaxPredictor(_exp(jax_presets), m0)
    out = {"tta": run(tta)}
    tta.reload_params(ema)
    out["ema"] = run(tta)
    return out


@pytest.mark.parametrize("bound", BOUND_TESTS)
def test_port_keeps_the_accuracy_bound(port_arms, bound):
    """Every bound of ``test_accuracy_benchmark.py:108-183``, on the port."""
    getattr(BOUNDS, bound)(port_arms[0])


def test_hard_generator_cases_are_the_benchmark_regime():
    _, empty = _cases()
    assert not (empty[0][1] == 3).any()           # seed 13 is the empty-ET case


@pytest.mark.parametrize("arm", ["tta", "ema"])
def test_port_labels_equal_jax_except_ties(port_arms, jax_arms, arm):
    arms, runs = port_arms
    pred, images = runs[arm]
    ties = 0
    for (got, _seg), want, img in zip(arms[arm], jax_arms[arm], images):
        assert got.shape == want.shape == SHAPE
        diff = got != want
        if diff.any():     # the port's mean probabilities say which are ties
            top2 = np.sort(pred.predict_probs_arrays(img)[0], axis=-1)[..., -2:]
            tie = (top2[..., 1] - top2[..., 0]) < TIE
            assert not (diff & ~tie).any(), int((diff & ~tie).sum())
        ties += int(diff.sum())
    print(f"{arm}: {ties} label(s) differ from the JAX package's, all on ties")
