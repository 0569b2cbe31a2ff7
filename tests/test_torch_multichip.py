"""PyTorch port: ``infer/multichip.py`` ``MultichipPredictor`` in its three
modes against the JAX package's on its 8-virtual-device CPU mesh (the
``tests/test_multichip_cli.py`` configs, bridged weights, 40x36x28 cases),
with the port at 2 and 4 CPU shards; the mesh ensemble; the member-parallel
``EnsemblePredictor``; ``--multichip`` on predict, serve and evaluate with
every refusal of the reference's."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.configs import presets as jax_presets
from brats2019_tpu.infer.multichip import MultichipPredictor as JaxMultichip
from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.models.unet3d import UNetConfig as JaxUNetConfig
from brats2019_tpu.train.checkpoint import export_params
from brats2019_tpu_torch.cli import evaluate as evaluate_cli
from brats2019_tpu_torch.cli import predict as predict_cli
from brats2019_tpu_torch.cli import serve as serve_cli
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.data import synthetic
from brats2019_tpu_torch.infer.ensemble import EnsemblePredictor
from brats2019_tpu_torch.infer.multichip import MultichipPredictor
from brats2019_tpu_torch.infer.predictor import Predictor
from brats2019_tpu_torch.parallel.mesh import make_mesh
from brats2019_tpu_torch.utils.weights import load_params

SHARDS = (2, 4)
UCFG = dict(levels=2, base_features=4, compute_dtype="float32")
CASC_FINE = dict(levels=2, base_features=4, max_features=8, stem_downsample=2,
                 compute_dtype="float32")
CASC_COARSE = dict(levels=2, base_features=4, max_features=8,
                   compute_dtype="float32")
PRESET = "mc_cascade"


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _single_exp(mod, tta):
    return mod.ExperimentConfig(
        name="mc", unet=mod.UNetConfig(**UCFG), coarse_unet=None,
        train=mod.TrainConfig(pool_shape=(32, 32, 32)),
        infer=mod.InferenceConfig(
            canvas=None, tile=(16, 16, 16), cascade=False, tta_flips=tta,
            min_component_voxels=0, et_min_voxels=0, compute_dtype="float32",
            tta_precision="float32"))


def _cascade_exp(mod, workdir="unused"):
    return mod.ExperimentConfig(
        name=PRESET, unet=mod.UNetConfig(**CASC_FINE),
        coarse_unet=mod.UNetConfig(**CASC_COARSE),
        train=mod.TrainConfig(pool_shape=(32, 32, 32)),
        infer=mod.InferenceConfig(
            canvas=None, tile=(16, 16, 16), cascade=True, tta_flips=True,
            roi_shape=(16, 16, 16), coarse_shape=(16, 16, 16),
            min_component_voxels=0, et_min_voxels=0, compute_dtype="float32",
            tta_precision="float32"),
        workdir=workdir)


def _params(kw, seed, path):
    """JAX init of a config, exported: (JAX params, the port's flat dict)."""
    p = JaxUNet3D(JaxUNetConfig(**kw)).init(jax.random.PRNGKey(seed),
                                            jnp.zeros((1, 16, 16, 16, 4)))
    export_params(path, p)
    return p, load_params(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("mc")
    out = {"single": _params(UCFG, 0, str(root / "s.npz"))}
    for i in range(2):
        w = root / f"w{i}"
        for stage in ("fine", "coarse"):
            os.makedirs(w / stage)
        out[f"fine{i}"] = _params(CASC_FINE, 3 + 2 * i, str(w / "fine" / "params.npz"))
        out[f"coarse{i}"] = _params(CASC_COARSE, 4 + 2 * i,
                                    str(w / "coarse" / "params.npz"))
        out[f"workdir{i}"] = str(w)
    return out


@pytest.fixture(scope="module")
def ref_masks(weights):
    """The JAX package's MultichipPredictor masks, once each."""
    out = {}
    pj = weights["single"][0]
    for mode, seed, tta in (("sweep", 21, True), ("spatial", 22, False)):
        image, _ = synthetic.make_case_arrays(seed=seed, shape=(40, 36, 28))
        out[mode] = JaxMultichip(_single_exp(jax_presets, tta), pj,
                                 mode=mode).predict_arrays(image)
    image, _ = synthetic.make_case_arrays(seed=23, shape=(40, 36, 28))
    exp = _cascade_exp(jax_presets)
    out["cascade"] = JaxMultichip(exp, weights["fine0"][0], mode="cascade",
                                  params_coarse=weights["coarse0"][0]
                                  ).predict_arrays(image)
    out["ensemble"] = JaxMultichip(
        exp, weights["fine0"][0], mode="cascade",
        params_coarse=weights["coarse0"][0],
        members=[(weights[f"fine{i}"][0], weights[f"coarse{i}"][0])
                 for i in range(2)]).predict_arrays(image)
    return out


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("mode", ["sweep", "spatial"])
def test_single_stage_modes_match_the_reference(weights, ref_masks, mode, n):
    seed, tta = (21, True) if mode == "sweep" else (22, False)
    image, _ = synthetic.make_case_arrays(seed=seed, shape=(40, 36, 28))
    mp = MultichipPredictor(_single_exp(presets, tta), weights["single"][1],
                            mode=mode, env=make_mesh(["cpu"] * n))
    got = mp.predict_arrays(image)
    ref = ref_masks[mode]
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert (got == ref).mean() > 0.999
    if mode == "sweep":
        # the single-stage predictor's masks (cascade=False)
        single, _ = Predictor(_single_exp(presets, tta), weights["single"][1],
                              device="cpu").predict_arrays(image)
        assert (got == single).mean() > 0.999


@pytest.mark.parametrize("n", SHARDS)
def test_cascade_mode_matches_the_reference_and_the_single_device(weights, ref_masks, n):
    image, _ = synthetic.make_case_arrays(seed=23, shape=(40, 36, 28))
    exp = _cascade_exp(presets)
    mp = MultichipPredictor(exp, weights["fine0"][1], mode="cascade",
                            env=make_mesh(["cpu"] * n),
                            params_coarse=weights["coarse0"][1])
    got = mp.predict_arrays(image)
    assert (got == ref_masks["cascade"]).mean() > 0.999
    single, _ = Predictor(exp, weights["fine0"][1], weights["coarse0"][1],
                          device="cpu").predict_arrays(image)
    assert (got == single).mean() > 0.999
    # warmup, and a reload of the same weights changes nothing
    assert mp.warmup() >= 0.0 and mp.warmup(stage="rest") == 0.0
    mp.reload_params(weights["fine0"][1], weights["coarse0"][1])
    assert np.array_equal(mp.predict_arrays(image), got)
    with pytest.raises(ValueError):
        mp.reload_params(weights["fine0"][1])


@pytest.mark.parametrize("n", SHARDS)
def test_mesh_ensemble_matches_the_reference(weights, ref_masks, n):
    image, _ = synthetic.make_case_arrays(seed=23, shape=(40, 36, 28))
    exp = _cascade_exp(presets)
    members = [(weights[f"fine{i}"][1], weights[f"coarse{i}"][1]) for i in range(2)]
    mp = MultichipPredictor(exp, members[0][0], mode="cascade",
                            env=make_mesh(["cpu"] * n),
                            params_coarse=members[0][1], members=members)
    assert mp.num_members == 2
    got = mp.predict_arrays(image)
    assert (got == ref_masks["ensemble"]).mean() > 0.999
    ens, _ = EnsemblePredictor(exp, members, device="cpu").predict_arrays(image)
    assert (got == ens).mean() > 0.999
    mp.reload_members(members[:1])
    assert mp.num_members == 1


def test_predictor_refusals(weights):
    w = weights["single"][1]
    env = make_mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="spatial|sweep|cascade"):
        MultichipPredictor(_single_exp(presets, False), w, mode="tiles", env=env)
    with pytest.raises(ValueError, match="cascade-mode only"):
        MultichipPredictor(_single_exp(presets, False), w, mode="sweep", env=env,
                           members=[(w, None)])
    with pytest.raises(ValueError, match="cascade preset"):
        MultichipPredictor(_single_exp(presets, False), w, mode="cascade", env=env)
    exp = _single_exp(presets, False)
    exp = dataclasses.replace(exp, infer=dataclasses.replace(exp.infer,
                                                             canvas=(20, 32, 32)))   # 20 % (2 * 4) != 0
    with pytest.raises(ValueError, match="divisible"):
        MultichipPredictor(exp, w, mode="spatial", env=env)


def test_member_parallel_ensemble_is_the_sequential_one(weights):
    """Members on devices i mod n, gathered to the first in member order:
    bitwise the one-device ensemble (here two CPU "devices")."""
    exp = _cascade_exp(presets)
    members = [(weights[f"fine{i}"][1], weights[f"coarse{i}"][1]) for i in range(2)]
    image, _ = synthetic.make_case_arrays(seed=24, shape=(40, 36, 28))
    one = EnsemblePredictor(exp, members, device="cpu")
    two = EnsemblePredictor(exp, members, device="cpu", devices=["cpu", "cpu"])
    a, _ = one.predict_probs_arrays(image)
    b, _ = two.predict_probs_arrays(image)
    assert a.tobytes() == b.tobytes()
    assert len(two._accum_probs_parallel(torch.zeros(32, 32, 32, 4))) == 2


# ----------------------------------------------------------------- the CLIs --

@pytest.fixture(scope="module")
def cli_setup(weights, tmp_path_factory):
    presets.PRESETS[PRESET] = _cascade_exp(presets)
    root = tmp_path_factory.mktemp("mccli")
    data = str(root / "data")
    dirs = synthetic.write_dataset(data, 2, shape=(40, 36, 28), seed0=31)
    yield weights["workdir0"], weights["workdir1"], data, dirs
    presets.PRESETS.pop(PRESET, None)


def _read_pred(d):
    from brats2019_tpu_torch.utils.nifti import read_nifti

    return read_nifti(os.path.join(d, os.path.basename(d) + "_pred.nii.gz"),
                      apply_scaling=False)[0]


def test_predict_cli_multichip(cli_setup, capsys):
    w0, _, data, dirs = cli_setup
    rc = predict_cli.main([data, "--preset", PRESET, "--workdir", w0,
                           "--device", "cpu,cpu", "--multichip", "cascade",
                           "--batch-volumes", "2", "--serving-depth", "2"])
    assert rc == 0
    err = capsys.readouterr().err      # the single-device knobs are noted
    for flag in ("--batch-volumes", "--serving-depth"):
        assert f"{flag} has no effect with --multichip" in err
    from brats2019_tpu_torch.data.case import load_case
    from brats2019_tpu_torch.data.constants import internal_to_disk

    mp = MultichipPredictor(_cascade_exp(presets), os.path.join(w0, "fine", "params.npz"),
                            mode="cascade", env=make_mesh(["cpu"] * 2),
                            params_coarse=os.path.join(w0, "coarse", "params.npz"))
    for d in dirs:
        want = internal_to_disk(mp.predict_arrays(load_case(d).image))
        assert np.array_equal(_read_pred(d), want)


@pytest.mark.parametrize("extra,needle", [
    (["--multichip", "cascade", "--save-probs"], "--save-probs"),
    (["--multichip", "sweep", "--save-uncertainty"], "--save-probs"),
    (["--multichip", "sweep", "--ensemble", "W1"], "composes only"),
    (["--device", "cpu,cpu"], "--multichip mesh"),
])
def test_predict_cli_refusals(cli_setup, capsys, extra, needle):
    w0, w1, data, _ = cli_setup
    extra = [w1 if a == "W1" else a for a in extra]
    rc = predict_cli.main([data, "--preset", PRESET, "--workdir", w0,
                           "--device", "cpu"] + extra if "--device" not in extra
                          else [data, "--preset", PRESET, "--workdir", w0] + extra)
    assert rc == 2
    assert needle in capsys.readouterr().err


def test_serve_cli_multichip(cli_setup, tmp_path, capsys):
    w0, w1, data, dirs = cli_setup
    out = str(tmp_path / "out")
    rc = serve_cli.main([data, "--preset", PRESET, "--workdir", w0, "--once",
                         "--device", "cpu,cpu", "--multichip", "cascade",
                         "--ensemble", w1, "--output-dir", out])
    assert rc == 0
    assert "multichip mode=cascade over 2 shards, ensemble of 2" in capsys.readouterr().out
    log = [json.loads(ln) for ln in open(os.path.join(out, "serve_log.jsonl"))]
    assert sorted(r["case"] for r in log) == sorted(os.path.basename(d) for d in dirs)
    assert all(r.get("error") is None for r in log)
    for flag in ("--save-probs", "--save-uncertainty"):
        assert serve_cli.main([data, "--preset", PRESET, "--workdir", w0,
                               "--once", "--device", "cpu", "--multichip",
                               "cascade", flag]) == 2
    assert serve_cli.main([data, "--preset", PRESET, "--workdir", w0, "--once",
                           "--device", "cpu", "--multichip", "sweep",
                           "--ensemble", w1]) == 2
    assert serve_cli.main([data, "--preset", PRESET, "--workdir", w0, "--once",
                           "--device", "cpu,cpu"]) == 2


def test_evaluate_cli_multichip(cli_setup, tmp_path, capsys):
    w0, w1, data, dirs = cli_setup
    out = str(tmp_path / "m.json")
    rc = evaluate_cli.main([data, "--preset", PRESET, "--workdir", w0,
                            "--device", "cpu,cpu", "--multichip", "sweep",
                            "--out", out])
    assert rc == 0
    res = json.load(open(out))
    assert res["n_cases"] == 2 and set(res["mean"]) == {"WT", "TC", "ET"}
    assert "bypassed" in capsys.readouterr().err    # the mode note
    for extra in (["--multichip", "cascade", "--use-existing"],
                  ["--multichip", "spatial", "--ensemble", w1]):
        assert evaluate_cli.main([data, "--preset", PRESET, "--workdir", w0,
                                  "--device", "cpu"] + extra) == 2


def test_predictor_stripes_cases_over_devices(weights, tmp_path):
    """The multi-case paths stripe case i onto device i mod n (each with its
    own copy of the nets): the labels are the one-device predictor's,
    bitwise (here two CPU "devices")."""
    exp = _cascade_exp(presets)
    pf, pc = weights["fine0"][1], weights["coarse0"][1]
    dirs = synthetic.write_dataset(str(tmp_path / "d"), 3, shape=(40, 36, 28),
                                   seed0=41)
    images = [synthetic.make_case_arrays(seed=41 + i, shape=(40, 36, 28))[0]
              for i in range(3)]
    one = Predictor(exp, pf, pc, device="cpu")
    two = Predictor(exp, pf, pc, device="cpu", devices=["cpu", "cpu"])
    a = one.predict_arrays_many(images)
    b = two.predict_arrays_many(images)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert set(two._lanes) == {1}
    outs = two.predict_dirs(dirs, [str(tmp_path / f"p{i}.nii.gz") for i in range(3)])
    ref = one.predict_dirs(dirs, [str(tmp_path / f"q{i}.nii.gz") for i in range(3)])
    from brats2019_tpu_torch.utils.nifti import read_nifti

    for x, y in zip(outs, ref):
        assert np.array_equal(read_nifti(x, apply_scaling=False)[0],
                              read_nifti(y, apply_scaling=False)[0])
    two.reload_params(pf, pc)      # the other device's copy is rebuilt
    assert not two._lanes
