"""PyTorch port: Predictor.predict_arrays and the port's predict CLI
(--device cpu) against the JAX Predictor on synthetic cases, with weights
written by the JAX package's export_params."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from brats2019_tpu.configs import presets as jax_presets
from brats2019_tpu.data import synthetic
from brats2019_tpu.infer.predictor import Predictor as JaxPredictor
from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.models.unet3d import UNetConfig as JaxUNetConfig
from brats2019_tpu.train.checkpoint import export_params, import_params
from brats2019_tpu.utils.nifti import read_nifti
from brats2019_tpu_torch.cli import predict as port_cli
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.infer.predictor import Predictor

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "accuracy",
                       "hard_member0.npz")
FINE_KW = dict(levels=2, base_features=8, compute_dtype="float32",
               stem_downsample=2)
COARSE_KW = dict(levels=2, base_features=8, compute_dtype="float32")
SHAPE = (72, 70, 52)   # the synthetic volume; the brain bbox is center-cropped


def _exp(mod, tta_precision="float32", **infer):
    return mod.ExperimentConfig(
        name="tiny_cascade",
        unet=mod.UNetConfig(**FINE_KW),
        coarse_unet=mod.UNetConfig(**COARSE_KW),
        train=mod.TrainConfig(pool_shape=(64, 64, 48)),
        infer=mod.InferenceConfig(
            canvas=(64, 64, 48), tile=(32, 32, 32), roi_shape=(32, 32, 32),
            coarse_shape=(32, 32, 24), cascade=True, tta_flips=True,
            tta_precision=tta_precision, compute_dtype="float32", **infer,
        ),
        workdir="unused",
    )


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """<workdir>/{fine,coarse}/params.npz written by the JAX exporter: a
    random stem-2 fine net and the trained fixture as localizer."""
    w = tmp_path_factory.mktemp("workdir")
    for stage in ("fine", "coarse"):
        os.makedirs(w / stage)
    pf = JaxUNet3D(JaxUNetConfig(**FINE_KW)).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 16, 16, 16, 4)))
    export_params(str(w / "fine" / "params.npz"), pf)
    shutil.copy(FIXTURE, w / "coarse" / "params.npz")
    return str(w)


def _jax_params(workdir):
    out = []
    for stage, kw in (("fine", FINE_KW), ("coarse", COARSE_KW)):
        like = JaxUNet3D(JaxUNetConfig(**kw)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 4)))
        out.append(import_params(os.path.join(workdir, stage, "params.npz"), like))
    return out


def _npz(workdir, stage):
    return os.path.join(workdir, stage, "params.npz")


@pytest.mark.parametrize("tta_precision", ["float32", "bfloat16"])
def test_predict_arrays_matches_jax_predictor(workdir, tta_precision):
    pf, pc = _jax_params(workdir)
    ref = JaxPredictor(_exp(jax_presets, tta_precision), pf, pc)
    port = Predictor(_exp(presets, tta_precision), _npz(workdir, "fine"),
                     _npz(workdir, "coarse"), device="cpu")
    for seed in (10, 11):
        image = synthetic.make_hard_case_arrays(seed=seed, shape=SHAPE)[0]
        want, _ = ref.predict_arrays(image)
        got, stats = port.predict_arrays(image)
        assert got.shape == SHAPE and got.dtype == np.uint8
        assert stats.total_s > 0
        assert set(np.unique(got)) <= {0, 1, 2, 3}
        # same math in another summation order: only tie voxels may flip
        assert (got != want).mean() < 1e-4, int((got != want).sum())
        assert (got > 0).sum() > 100   # the localizer found a tumor


def test_port_cli_matches_jax_predictor(tmp_path, workdir, monkeypatch, capsys):
    monkeypatch.setitem(presets.PRESETS, "tiny_cascade", _exp(presets))
    root = tmp_path / "cases"
    dirs = synthetic.write_dataset(str(root), 2, shape=SHAPE, seed0=20,
                                   hard=True)
    rc = port_cli.main([str(root), "--preset", "tiny_cascade",
                        "--workdir", workdir, "--device", "cpu"])
    assert rc == 0
    assert "2 case(s)" in capsys.readouterr().out
    pf, pc = _jax_params(workdir)
    ref = JaxPredictor(_exp(jax_presets), pf, pc)
    for d in dirs:
        name = os.path.basename(d)
        got, hdr = read_nifti(os.path.join(d, f"{name}_pred.nii.gz"),
                              apply_scaling=False)
        want_path, _ = ref.predict_dir(d, str(tmp_path / f"{name}_ref.nii.gz"))
        want, _ = read_nifti(want_path, apply_scaling=False)
        assert got.shape == SHAPE
        assert set(np.unique(got)) <= {0, 1, 2, 4}
        assert (got != want).mean() < 1e-4
        src = read_nifti(os.path.join(d, f"{name}_t1.nii.gz"))[1]
        np.testing.assert_allclose(hdr.affine(), src.affine())


def test_port_cli_errors(tmp_path, workdir, monkeypatch, capsys):
    monkeypatch.setitem(presets.PRESETS, "tiny_cascade", _exp(presets))
    assert port_cli.main([str(tmp_path / "none"), "--preset", "tiny_cascade",
                          "--device", "cpu"]) == 2
    case = synthetic.write_case(str(tmp_path / "BraTS19_E_1"), shape=(40, 40, 32))
    assert port_cli.main([case, "--preset", "tiny_cascade",
                          "--workdir", str(tmp_path / "empty"),
                          "--device", "cpu"]) == 2
    assert "params.npz" in capsys.readouterr().err


def test_predict_dirs_and_output_path(tmp_path, workdir):
    port = Predictor(_exp(presets), _npz(workdir, "fine"),
                     _npz(workdir, "coarse"), device="cpu")
    dirs = synthetic.write_dataset(str(tmp_path), 2, shape=(48, 40, 36))
    outs = port.predict_dirs(dirs, [None, str(tmp_path / "x_pred.nii.gz")])
    assert outs[1] == str(tmp_path / "x_pred.nii.gz")
    for out in outs:
        seg, _ = read_nifti(out, apply_scaling=False)
        assert seg.shape == (48, 40, 36) and set(np.unique(seg)) <= {0, 1, 2, 4}


def test_full_canvas_transfer_matches_bucketed(workdir):
    """transfer_bucket=0 ships the whole canvas; the result is identical."""
    a = Predictor(_exp(presets), _npz(workdir, "fine"), _npz(workdir, "coarse"),
                  device="cpu")
    exp0 = _exp(presets, transfer_bucket=0)
    b = Predictor(exp0, _npz(workdir, "fine"), _npz(workdir, "coarse"),
                  device="cpu")
    image = synthetic.make_hard_case_arrays(seed=12, shape=SHAPE)[0]
    np.testing.assert_array_equal(a.predict_arrays(image)[0],
                                  b.predict_arrays(image)[0])


def test_int8_transfer_not_ported(workdir):
    exp = dataclasses.replace(
        _exp(presets),
        infer=dataclasses.replace(_exp(presets).infer, transfer_dtype="int8"),
    )
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Predictor(exp, _npz(workdir, "fine"), _npz(workdir, "coarse"),
                  device="cpu")
