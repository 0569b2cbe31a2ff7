"""PyTorch port: the params export (``cli/export.py``, ``cli/common.py``
``ema_stage_params`` / ``average_stage_params`` /
``load_stage_params(from_checkpoint_only=)``,
``CheckpointManager.restore_params_at``).

A ``unit`` run trained a few steps with ``--ema-decay`` on the CPU: ``--ema``
exports the tracker's tensors, ``--average 2`` the f32 mean of the two
retained steps, a plain export the latest checkpoint even when an older
export exists; ``predict`` loads each; the JAX package's ``import_params``
reads the files (the format is its own); the refusals and exit codes are the
reference's, and ``--stablehlo --device cpu`` writes the program export
(``tests/test_torch_program_export.py`` tests it in full)."""

import os

import numpy as np
import pytest
import torch

from brats2019_tpu_torch.cli import export as export_cli
from brats2019_tpu_torch.cli import predict as predict_cli
from brats2019_tpu_torch.cli import train as train_cli
from brats2019_tpu_torch.configs.presets import get_preset
from brats2019_tpu_torch.data import synthetic
from brats2019_tpu_torch.train.checkpoint import CheckpointManager
from brats2019_tpu_torch.utils.weights import load_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    data, work = str(root / "data"), str(root / "work")
    synthetic.write_dataset(data, 3, shape=(40, 36, 28), seed0=21)
    rc = train_cli.main(["--preset", "unit", "--data", data, "--workdir", work,
                         "--device", "cpu", "--steps", "4",
                         "--checkpoint-every", "1", "--ema-decay", "0.6"])
    assert rc == 0
    return data, work


def _run_export(work, *extra):
    return export_cli.main(["--preset", "unit", "--workdir", work, *extra])


def test_checkpoints_retained(trained):
    _, work = trained
    ckpt = CheckpointManager(os.path.join(work, "fine"))
    assert ckpt.all_steps() == [2, 3, 4]       # keep_checkpoints = 3
    p = ckpt.restore_params_at(3)
    assert all(v.dtype == np.float32 for v in p.values())
    with pytest.raises(FileNotFoundError):
        ckpt.restore_params_at(1)


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
def test_ema_export_is_the_tracker(trained, fmt):
    data, work = trained
    assert _run_export(work, "--ema", "--format", fmt) == 0
    got = load_params(os.path.join(work, "fine", f"params.{fmt}"))
    state = CheckpointManager(os.path.join(work, "fine")).restore()
    ema = state["opt_state"]["ema"]
    assert len(got) == len(ema) == len(state["params"])
    for k, v in ema.items():
        np.testing.assert_array_equal(got["params/" + k.replace(".", "/")],
                                      v.numpy())
    # the EMA is not the params: it moved more slowly
    assert any(not np.array_equal(got[k], state["params"][k].numpy())
               for k in got)
    _predict_loads(data, work, fmt)


def test_average_export_is_the_mean_of_the_retained_steps(trained):
    data, work = trained
    assert _run_export(work, "--average", "2") == 0
    got = load_params(os.path.join(work, "fine", "params.npz"))
    ckpt = CheckpointManager(os.path.join(work, "fine"))
    a, b = ckpt.restore_params_at(3), ckpt.restore_params_at(4)
    for k in a:
        want = np.asarray((a[k].astype(np.float32) + b[k].astype(np.float32))
                          * 0.5, a[k].dtype)
        np.testing.assert_array_equal(got[k], want)
    # more than retained: all three, with a note
    assert _run_export(work, "--average", "9") == 0
    got = load_params(os.path.join(work, "fine", "params.npz"))
    c = ckpt.restore_params_at(2)
    k0 = next(iter(c))
    np.testing.assert_allclose(got[k0], (a[k0] + b[k0] + c[k0]) / 3, rtol=1e-6)
    _predict_loads(data, work, "npz")


def test_plain_export_reads_the_checkpoint_not_the_last_export(trained):
    _, work = trained
    assert _run_export(work, "--ema") == 0       # an export newer than ckpts
    assert _run_export(work) == 0
    got = load_params(os.path.join(work, "fine", "params.npz"))
    latest = CheckpointManager(os.path.join(work, "fine")).restore()["params"]
    for k, v in latest.items():
        np.testing.assert_array_equal(got[k], v.numpy())


def test_the_jax_package_reads_the_export(trained):
    """The exported files are the JAX package's format: its
    ``import_params`` loads them against the ``unit`` template."""
    import jax

    from brats2019_tpu.cli.common import _stage_param_template
    from brats2019_tpu.configs.presets import get_preset as ref_preset
    from brats2019_tpu.train.checkpoint import import_params

    _, work = trained
    assert _run_export(work, "--average", "2") == 0
    like = _stage_param_template(ref_preset("unit"), "fine")
    tree = import_params(os.path.join(work, "fine", "params.npz"), like)
    got = load_params(os.path.join(work, "fine", "params.npz"))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(got)
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), got[key])


def _predict_loads(data, work, fmt):
    case = synthetic.write_dataset(os.path.join(work, f"pred_{fmt}"), 1,
                                   shape=(40, 36, 28), seed0=30)[0]
    assert predict_cli.main([case, "--preset", "unit", "--workdir", work,
                             "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(case, os.path.basename(case)
                                       + "_pred.nii.gz"))


def test_refusals(trained, tmp_path, capsys):
    _, work = trained
    assert _run_export(work, "--ema", "--average", "2") == 2
    assert _run_export(work, "--average", "0") == 2
    assert export_cli.main(["--preset", "unit", "--workdir", work,
                            "--stage", "coarse"]) == 2
    # --stablehlo runs: the unit program (monolithic) as a torch.export
    # program on the CPU, beside the params export
    assert _run_export(work, "--stablehlo", "--device", "cpu") == 0
    out = os.path.join(work, "torch_export")
    assert sorted(os.listdir(out)) == ["manifest.json", "predict.pt2"]
    empty = str(tmp_path / "none")
    assert _run_export(empty) == 1
    assert _run_export(empty, "--ema") == 1
    assert not os.path.exists(os.path.join(empty, "fine", "checkpoints"))


def test_ema_export_of_a_run_without_ema(tmp_path):
    data = str(tmp_path / "d")
    synthetic.write_dataset(data, 2, shape=(40, 36, 28), seed0=3)
    work = str(tmp_path / "w")
    assert train_cli.main(["--preset", "unit", "--data", data, "--workdir",
                           work, "--device", "cpu", "--steps", "2"]) == 0
    assert _run_export(work, "--ema") == 1
    assert get_preset("unit").train.ema_decay == 0.0
