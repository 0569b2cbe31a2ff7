"""PyTorch port: ``cli/evaluate.py`` against the JAX package's evaluate CLI on
the same synthetic root and weights (the JSON report, with HD95 and
sensitivity / specificity, for one model and for a checkpoint ensemble; the
fold and shard selections), and the new flags of the predict, serve, train
and evaluate CLIs parsing and flowing into what they drive."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.cli import evaluate as ref_cli
from brats2019_tpu.configs import presets as jax_presets
from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.train.checkpoint import export_params
from brats2019_tpu_torch.cli import evaluate as port_cli
from brats2019_tpu_torch.cli import predict as port_predict
from brats2019_tpu_torch.cli import serve as port_serve
from brats2019_tpu_torch.cli import train as port_train
from brats2019_tpu_torch.cli.common import resolve_experiment
from brats2019_tpu_torch.data import synthetic

SHAPE = (40, 40, 32)


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


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Four hard synthetic cases with labels, and two ``unit`` workdirs of
    params exported by the JAX package."""
    base = tmp_path_factory.mktemp("evaluate")
    dirs = synthetic.write_dataset(str(base / "cases"), 4, shape=SHAPE, seed0=40,
                                   hard=True)
    cfg = jax_presets.get_preset("unit").unet
    for i in range(2):
        os.makedirs(base / f"w{i}" / "fine")
        p = JaxUNet3D(cfg).init(jax.random.PRNGKey(3 + i),
                                jnp.zeros((1, 16, 16, 16, 4)))
        export_params(str(base / f"w{i}" / "fine" / "params.npz"), p)
    return base, dirs


def _run(cli, argv, out, extra=()):
    assert cli.main([*argv, "--out", out, *extra]) == 0
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("ensemble", [False, True])
def test_evaluate_json_matches_jax_cli(root, tmp_path, ensemble):
    base, _ = root
    argv = [str(base / "cases"), "--preset", "unit", "--workdir", str(base / "w0"),
            "--hd95", "--sens-spec", "--et-min-voxels", "0"]
    if ensemble:
        argv += ["--ensemble", str(base / "w1")]
    want = _run(ref_cli, argv, str(tmp_path / "ref.json"))
    got = _run(port_cli, argv, str(tmp_path / "port.json"), ("--device", "cpu"))
    assert got["n_cases"] == want["n_cases"] == 4
    assert got["per_case"].keys() == want["per_case"].keys()
    for name, scores in want["per_case"].items():
        assert got["per_case"][name].keys() == scores.keys()
        assert any(k.startswith("HD95_") for k in scores)
        assert any(k.startswith("Sens_") for k in scores)
        for k, v in scores.items():
            assert got["per_case"][name][k] == pytest.approx(v, abs=1e-3), (name, k)
    for k, v in want["mean"].items():
        assert got["mean"][k] == pytest.approx(v, abs=1e-3), k
        if not k.startswith("HD95_"):
            assert 0.0 <= got["mean"][k] <= 1.0


@pytest.mark.parametrize("select", [["--folds", "3", "--fold", "1"],
                                    ["--shard", "1/2"], ["--shard", "0/2"]])
def test_evaluate_selection_and_use_existing_match_jax_cli(root, tmp_path, select):
    base, dirs = root
    assert port_predict.main([str(base / "cases"), "--preset", "unit", "--workdir",
                              str(base / "w0"), "--device", "cpu"]) == 0
    argv = [str(base / "cases"), "--preset", "unit", "--use-existing", *select]
    want = _run(ref_cli, argv, str(tmp_path / "ref.json"))
    got = _run(port_cli, argv, str(tmp_path / "port.json"))
    assert got == want


def test_evaluate_errors(root, tmp_path, capsys):
    base, _ = root
    cases = str(base / "cases")
    assert port_cli.main([cases, "--folds", "3"]) == 2
    assert port_cli.main([cases, "--folds", "3", "--fold", "0", "--shard", "0/2"]) == 2
    assert port_cli.main([cases, "--use-existing", "--ensemble", "x"]) == 2
    assert port_cli.main([str(tmp_path), "--device", "cpu"]) == 2
    assert port_cli.main([cases, "--preset", "unit", "--workdir", str(tmp_path),
                          "--device", "cpu"]) == 2
    assert "error" in capsys.readouterr().err


def test_new_cli_flags_parse_and_flow_into_the_config():
    """The thresholds and --seed flow through resolve_experiment on predict,
    serve and evaluate (0 overrides too); predict's and serve's new flags
    parse; the preset defaults survive when a flag is absent."""
    for mod, pre in ((port_predict, ["case"]), (port_serve, ["watch"]),
                     (port_cli, ["root"])):
        args = mod.build_parser().parse_args(
            pre + ["--preset", "cascade", "--et-min-voxels", "200",
                   "--min-component-voxels", "0", "--seed", "7",
                   "--ensemble", "a", "b"])
        exp = resolve_experiment(args)
        assert exp.infer.et_min_voxels == 200, mod.__name__
        assert exp.infer.min_component_voxels == 0, mod.__name__
        assert exp.train.seed == 7 and args.ensemble == ["a", "b"]
        assert args.device == "cuda"                 # entry points default to the card
        exp = resolve_experiment(mod.build_parser().parse_args(pre + ["--preset",
                                                                     "cascade"]))
        assert exp.infer.et_min_voxels == 32, mod.__name__
        assert exp.infer.min_component_voxels == 16, mod.__name__
    for mod, pre in ((port_predict, ["case"]), (port_serve, ["watch"])):
        args = mod.build_parser().parse_args(pre + ["--save-probs",
                                                    "--save-uncertainty"])
        assert args.save_probs and args.save_uncertainty
    args = port_predict.build_parser().parse_args(
        ["case", "--postproc", "device", "--prep-cache", "c", "--serving-depth", "3",
         "--shard", "1/4"])
    assert (args.postproc, args.prep_cache, args.serving_depth, args.shard) == (
        "device", "c", 3, "1/4")
    assert port_train.build_parser().parse_args(["--synthetic-hard"]).synthetic_hard


def test_predict_flags_flow_end_to_end(root, tmp_path, capsys):
    """--shard, --prep-cache, --serving-depth, --save-probs and
    --save-uncertainty on a root of cases (the pipelined predict_dirs)."""
    base, dirs = root
    cache = tmp_path / "cache"
    argv = [str(base / "cases"), "--preset", "unit", "--workdir", str(base / "w0"),
            "--device", "cpu", "--prep-cache", str(cache), "--serving-depth", "2",
            "--save-probs", "--save-uncertainty", "--postproc", "host"]
    assert port_predict.main([*argv, "--shard", "0/2"]) == 0
    out = capsys.readouterr().out
    from brats2019_tpu_torch.cli.common import filter_shard

    mine = filter_shard(dirs, "0/2")
    assert 0 < len(mine) < len(dirs)
    assert f"shard 0/2: {len(mine)} case(s)" in out
    for d in dirs:
        name = os.path.basename(d)
        has = os.path.exists(os.path.join(d, f"{name}_probs.npz"))
        assert has == (d in mine), d
        if d in mine:
            for region in ("whole", "core", "enhance"):
                assert os.path.exists(os.path.join(d, f"{name}_unc_{region}.nii.gz"))
            with np.load(os.path.join(d, f"{name}_probs.npz")) as z:
                np.testing.assert_allclose(z["probs"].astype(np.float32).sum(-1),
                                           1.0, atol=4e-3)
    assert len(os.listdir(cache)) == len(mine)       # the payload cache was used
    assert port_predict.main([*argv, "--shard", "5/2"]) == 2
    for d in dirs:                                   # leave the root as it was
        for f in os.listdir(d):
            if "_unc_" in f or f.endswith("_probs.npz"):
                os.remove(os.path.join(d, f))
