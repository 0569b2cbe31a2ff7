"""PyTorch port: the probability programs (``models/cascade.py`` ``probs``),
the predictor's probability path and ``infer/ensemble.py``
``EnsemblePredictor`` against the JAX package, in f32 on the CPU, on tiny
cascades whose members localise different ROIs; the uncertainty maps and the
``<case>_probs.npz`` artifact; ``load_ensemble_members``."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.configs import presets as jax_presets
from brats2019_tpu.infer import uncertainty as ref_unc
from brats2019_tpu.infer.ensemble import EnsemblePredictor as JaxEnsemble
from brats2019_tpu.infer.predictor import Predictor as JaxPredictor
from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.models.unet3d import UNetConfig as JaxUNetConfig
from brats2019_tpu.train.checkpoint import export_params, import_params
from brats2019_tpu_torch.cli import common
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.data import synthetic
from brats2019_tpu_torch.infer import uncertainty
from brats2019_tpu_torch.infer.ensemble import EnsemblePredictor
from brats2019_tpu_torch.infer.predictor import Predictor, save_probs_npz
from brats2019_tpu_torch.models import cascade as tcascade

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "accuracy",
                       "hard_member0.npz")
FINE_KW = dict(levels=2, base_features=8, compute_dtype="float32",
               stem_downsample=2)
COARSE_KW = dict(levels=2, base_features=8, compute_dtype="float32")
SHAPE = (72, 70, 52)    # the synthetic volume; the brain bbox is center-cropped
TOL = 1e-5
TIE = 1e-5     # top-2 gap of the mean probabilities below which a label may flip


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


def _exp(mod, fine_kw=FINE_KW, **infer):
    kw = dict(canvas=(64, 64, 48), tile=(32, 32, 32), roi_shape=(32, 32, 32),
              coarse_shape=(32, 32, 24), cascade=True, tta_flips=True,
              tta_precision="float32", compute_dtype="float32",
              postproc="host")
    kw.update(infer)
    return mod.ExperimentConfig(
        name="tiny_cascade", unet=mod.UNetConfig(**fine_kw),
        coarse_unet=mod.UNetConfig(**COARSE_KW),
        train=mod.TrainConfig(pool_shape=(64, 64, 48)),
        infer=mod.InferenceConfig(**kw), workdir="unused")


def _init(kw, seed, path):
    p = JaxUNet3D(JaxUNetConfig(**kw)).init(jax.random.PRNGKey(seed),
                                            jnp.zeros((1, 16, 16, 16, 4)))
    export_params(path, p)


def _jax(path, kw):
    like = JaxUNet3D(JaxUNetConfig(**kw)).init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 16, 16, 16, 4)))
    return import_params(path, like)


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    """Two workdirs of <stage>/params.npz: member 0 localises with the
    trained fixture, member 1 with a random coarse net (another ROI); a
    stem-1 fine net for the full-resolution split path."""
    root = tmp_path_factory.mktemp("members")
    out = []
    for i in range(2):
        w = root / f"w{i}"
        for stage in ("fine", "coarse", "fine1"):
            os.makedirs(w / stage)
        _init(FINE_KW, 5 + i, str(w / "fine" / "params.npz"))
        _init(dict(FINE_KW, stem_downsample=1), 8 + i, str(w / "fine1" / "params.npz"))
        if i == 0:
            shutil.copy(FIXTURE, w / "coarse" / "params.npz")
        else:
            _init(COARSE_KW, 7, str(w / "coarse" / "params.npz"))
        out.append(str(w))
    return out


def _npz(w, stage):
    return os.path.join(w, stage, "params.npz")


def _image(seed=10):
    return synthetic.make_hard_case_arrays(seed=seed, shape=SHAPE)[0]


@pytest.fixture(scope="module")
def default_pair(members):
    """(JAX Predictor, port Predictor) of member 0 at the default tiny
    cascade (the split low-res program): one JAX compile for the tests that
    share it."""
    w = members[0]
    ref = JaxPredictor(_exp(jax_presets), _jax(_npz(w, "fine"), FINE_KW),
                       _jax(_npz(w, "coarse"), COARSE_KW))
    port = Predictor(_exp(presets), _npz(w, "fine"), _npz(w, "coarse"), device="cpu")
    return ref, port


# --------------------------------------------------- the probability programs --

PROGRAMS = {
    # name: (fine params dir, fine config, infer overrides, program class)
    "split_lowres": ("fine", FINE_KW, {}, "SplitCascade"),
    "split_fullres": ("fine1", dict(FINE_KW, stem_downsample=1), {}, "SplitCascade"),
    "staged_sweep": ("fine", FINE_KW, {"cascade": False}, "StagedSweep"),
    "monolithic": ("fine", FINE_KW, {"tta_flips": False}, "Monolithic"),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_probs_program_matches_jax_probs_fn(members, default_pair, name):
    """``program.probs`` against the JAX ``fn.probs_fn`` on the same canvas
    (within 1e-4), and its argmax equal to the label program's labels."""
    stage, kw, infer, cls = PROGRAMS[name]
    w = members[0]
    exp_j, exp_t = _exp(jax_presets, kw, **infer), _exp(presets, kw, **infer)
    pc = _npz(w, "coarse") if exp_t.infer.cascade else None
    if name == "split_lowres":
        ref, port = default_pair
    else:
        ref = JaxPredictor(exp_j, _jax(_npz(w, stage), kw),
                           _jax(pc, COARSE_KW) if pc else None)
        port = Predictor(exp_t, _npz(w, stage), pc, device="cpu")
    assert type(port.program).__name__ == cls
    image = _image()
    canvas_j, _, _ = ref._prep_to(image, ref._default_dev)
    want, want_start = ref._fn.probs_fn(ref.params_fine, ref.params_coarse, canvas_j)
    canvas, _, _ = port.prepare(image)
    got, start = port.probs_device(canvas)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(start.numpy(), np.asarray(want_start))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    labels, _ = port.predict_device(canvas)
    assert torch.equal(torch.argmax(got, -1).to(torch.uint8), labels)


def test_probs_from_blocks_commutes_with_argmax():
    g = torch.Generator().manual_seed(0)
    for r in (1, 2, 3):
        p = torch.rand((3, 4, 2, r, r, r, 4), generator=g)
        got = torch.argmax(tcascade.probs_from_blocks(p, r), -1)
        want = tcascade.labels_from_blocks(torch.argmax(p, -1), r)
        assert got.shape == (3 * r, 4 * r, 2 * r) and torch.equal(got, want)


def test_predict_probs_arrays_matches_jax(default_pair):
    ref, port = default_pair
    image = _image(11)
    want, _ = ref.predict_probs_arrays(image)
    got, stats = port.predict_probs_arrays(image)
    assert got.shape == SHAPE + (4,) and got.dtype == np.float32 and stats.total_s > 0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    outside = got[..., 0] == 1.0          # never written: exact background
    assert outside.sum() > 0 and (got[outside][:, 1:] == 0).all()


# ------------------------------------------------------------------ ensemble --

@pytest.fixture(scope="module")
def ensembles(members):
    """(port ensemble, JAX ensemble) over the two members."""
    jax_members = [(_jax(_npz(w, "fine"), FINE_KW), _jax(_npz(w, "coarse"), COARSE_KW))
                   for w in members]
    port_members = [(_npz(w, "fine"), _npz(w, "coarse")) for w in members]
    return (EnsemblePredictor(_exp(presets), port_members, device="cpu"),
            JaxEnsemble(_exp(jax_presets), jax_members))


def test_members_localise_different_rois(ensembles):
    port, _ = ensembles
    canvas, _, _ = port._p.prepare(_image())
    starts = [p.probs(canvas)[1].tolist() for p in port._programs]
    assert starts[0] != starts[1], starts


def test_ensemble_sum_count_and_mean_match_jax(ensembles):
    port, ref = ensembles
    image = _image()
    canvas_j, _, _ = ref._p._prep_to(image, ref._p._default_dev)
    acc_j, cnt_j = ref._accum_probs_device(canvas_j)
    canvas, _, _ = port._p.prepare(image)
    acc, cnt = port.accumulate(canvas)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    assert set(np.unique(cnt.numpy())) == {0.0, 1.0, 2.0}   # the ROIs overlap in part
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), atol=TOL, rtol=TOL)
    mean = port.mean_device(canvas).numpy()
    np.testing.assert_allclose(mean, np.asarray(ref._mean(acc_j, cnt_j)),
                               atol=TOL, rtol=TOL)
    # member order fixes the reduction order: a repeat is bitwise equal
    acc2, _ = port.accumulate(canvas)
    assert torch.equal(acc, acc2)


def test_ensemble_labels_and_probs_match_jax(ensembles):
    port, ref = ensembles
    for seed in (10, 12):
        image = _image(seed)
        want, _ = ref.predict_arrays(image)
        got, stats = port.predict_arrays(image)
        assert got.shape == SHAPE and stats.total_s > 0
        want_p, _ = ref.predict_probs_arrays(image)
        got_p, _ = port.predict_probs_arrays(image)
        np.testing.assert_allclose(got_p, want_p, atol=TOL, rtol=TOL)
        # labels equal but on ties (top-2 of the mean within TIE)
        top2 = np.sort(got_p, axis=-1)[..., -2:]
        tie = (top2[..., 1] - top2[..., 0]) < TIE
        diff = got != want
        assert not (diff & ~tie).any() and diff.sum() <= 2, int(diff.sum())


def test_ensemble_of_one_model_twice_is_that_model(members):
    """(a + a) / 2 = a: the probabilities equal the Predictor's, the labels
    its host-postprocessed labels; one member is the Predictor's too."""
    w = members[0]
    pair = (_npz(w, "fine"), _npz(w, "coarse"))
    pred = Predictor(_exp(presets), *pair, device="cpu")
    image = _image(11)
    probs, _ = pred.predict_probs_arrays(image)
    labels, _ = pred.predict_arrays(image)
    for k in (1, 2):
        ens = EnsemblePredictor(_exp(presets), [pair] * k, device="cpu")
        got_p, _ = ens.predict_probs_arrays(image)
        np.testing.assert_array_equal(got_p, probs)
        np.testing.assert_array_equal(ens.predict_arrays(image)[0], labels)


def test_ensemble_dirs_probs_artifacts_warmup_and_reload(tmp_path, members, ensembles):
    port, _ = ensembles
    dirs = synthetic.write_dataset(str(tmp_path / "cases"), 3, shape=SHAPE,
                                   seed0=30, hard=True)
    outs = port.predict_dirs(dirs, [str(tmp_path / f"p{i}.nii.gz") for i in range(3)])
    ones = [port.predict_dir(d, str(tmp_path / f"q{i}.nii.gz"))[0]
            for i, d in enumerate(dirs)]
    from brats2019_tpu_torch.utils.nifti import read_nifti

    for a, b in zip(outs, ones):
        np.testing.assert_array_equal(read_nifti(a, apply_scaling=False)[0],
                                      read_nifti(b, apply_scaling=False)[0])
    name, header, probs = port.probs_for_dir(dirs[0])
    assert name == os.path.basename(dirs[0]) and probs.shape == SHAPE + (4,)
    path = port.predict_probs_dir(dirs[0])
    with np.load(path) as z:
        assert z["probs"].dtype == np.float16
        np.testing.assert_array_equal(z["classes"], [0, 1, 2, 4])
        np.testing.assert_allclose(z["probs"].astype(np.float32), probs, atol=1e-3)
    assert port.warmup(probs=True, stage="all") > 0
    assert port.prefill_payload_cache(dirs[0]) is False      # no cache configured
    before = port.predict_arrays(_image())[0]
    port.reload_members([(_npz(members[0], "fine"), _npz(members[0], "coarse"))])
    assert port.num_members == 1
    port.reload_members([(_npz(w, "fine"), _npz(w, "coarse")) for w in members])
    assert port.num_members == 2
    np.testing.assert_array_equal(port.predict_arrays(_image())[0], before)
    with pytest.raises(ValueError):
        EnsemblePredictor(_exp(presets), [], device="cpu")


def test_save_probs_npz_matches_the_reference_contract(tmp_path):
    from brats2019_tpu.infer.predictor import save_probs_npz as ref_save

    probs = np.random.default_rng(0).dirichlet(np.ones(4), size=(5, 6, 7))
    probs = probs.astype(np.float32)
    a = save_probs_npz(str(tmp_path / "a_probs.npz"), probs)
    b = ref_save(str(tmp_path / "b_probs.npz"), probs)
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files) == ["classes", "probs"]
        for k in za.files:
            assert za[k].dtype == zb[k].dtype
            np.testing.assert_array_equal(za[k], zb[k])


def test_uncertainty_dir_matches_jax(tmp_path, default_pair):
    ref, port = default_pair
    d = synthetic.write_case(str(tmp_path / "BraTS19_U_1"), seed=12, shape=SHAPE,
                             hard=True)
    os.makedirs(tmp_path / "ref")
    got = uncertainty.predict_uncertainty_dir(port, d)
    want = ref_unc.predict_uncertainty_dir(ref, d, str(tmp_path / "ref"))
    from brats2019_tpu_torch.utils.nifti import read_nifti

    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        ua = read_nifti(a, apply_scaling=False)[0].astype(int)
        ub = read_nifti(b, apply_scaling=False)[0].astype(int)
        assert ua.shape == SHAPE and ua.max() <= 100
        assert np.abs(ua - ub).max() <= 1          # rint of f32 entropies
        assert (ua != ub).mean() < 1e-3


def test_load_ensemble_members_warns_and_reuses_the_primary_coarse(tmp_path, members,
                                                                   capsys):
    exp = dataclasses.replace(_exp(presets), workdir=members[0])
    primary = (common.load_stage_params(exp, "fine"),
               common.load_stage_params(exp, "coarse"))
    lonely = tmp_path / "lonely"
    shutil.copytree(os.path.join(members[1], "fine"), lonely / "fine")
    got = common.load_ensemble_members(exp, [members[0], str(lonely)], primary)
    err = capsys.readouterr().err
    assert "appears more than once" in err and "reuses the primary coarse" in err
    assert len(got) == 3 and got[0] is primary
    assert got[2][1] is primary[1]
    np.testing.assert_array_equal(got[2][0]["params/head/kernel"],
                                  np.load(_npz(members[1], "fine"))["params/head/kernel"])
    with pytest.raises(FileNotFoundError):
        common.load_ensemble_members(exp, [str(tmp_path / "missing")], primary)
