"""PyTorch port: the importer of foreign torch checkpoints
(``utils/torch_import.py``, ``cli/import_torch.py``) against the JAX
package's (``brats2019_tpu/utils/torch_import.py``), and the port's own
safetensors reader and writer against the ``safetensors`` package.

The reference-topology state dicts are those of ``tests/test_import_torch.py``
(``TorchMirror`` and its biased / affine-free variants); on each, the port's
flat params equal the JAX import's bitwise, with the same notes, and the
port's net on them gives the torch model's logits."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.models.unet3d import UNetConfig as JaxUNetConfig
from brats2019_tpu.utils import torch_import as jax_ti
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.utils import torch_import as ti
from brats2019_tpu_torch.utils import weights
from test_golden_parity import TorchMirror
from test_import_torch import _BiasedMirror, _NoAffineMirror, _mirror_mapping

CFG_KW = dict(levels=3, base_features=8, max_features=32, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_like(kw, size=16):
    return JaxUNet3D(JaxUNetConfig(**kw)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, size, 4)))


def _assert_same_import(state, kw, size=16, mapping=None):
    """The port's import of ``state`` equals the JAX package's, bitwise,
    with the same notes; returns the port's flat params."""
    want, want_notes = jax_ti.import_torch_params(
        state, _jax_like(kw, size),
        None if mapping is None else mapping)
    got, notes = ti.import_torch_params(
        state, weights.param_template(presets.UNetConfig(**kw)), mapping)
    want = _flat(want)
    assert got.keys() == want.keys() and notes == want_notes
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    return got


def _assert_forward_match(kw, flat, tmodel, size=16):
    x = np.random.default_rng(3).normal(size=(1, size, size, size, 4)).astype(np.float32)
    net = weights.build_unet(presets.UNetConfig(**kw), flat, "cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
        want = tmodel(torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()))
    np.testing.assert_allclose(got, want.numpy().transpose(0, 2, 3, 4, 1),
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("variant", ["plain", "biased", "no_affine"])
def test_structural_import_matches_reference(variant):
    torch.manual_seed({"plain": 0, "biased": 2, "no_affine": 4}[variant])
    cls = {"plain": TorchMirror, "biased": _BiasedMirror,
           "no_affine": _NoAffineMirror}[variant]
    tmodel = cls(JaxUNetConfig(**CFG_KW)).eval()
    state = ti.flatten_state_dict(tmodel.state_dict())
    assert list(state) == list(jax_ti.flatten_state_dict(tmodel.state_dict()))
    flat = _assert_same_import(state, CFG_KW)
    _assert_forward_match(CFG_KW, flat, tmodel)


@pytest.mark.parametrize("levels,base,maxf", [(2, 4, 8), (3, 8, 16), (4, 6, 48)])
def test_structural_import_across_topologies(levels, base, maxf):
    kw = dict(levels=levels, base_features=base, max_features=maxf,
              compute_dtype="float32")
    torch.manual_seed(levels * 100 + base)
    tmodel = TorchMirror(JaxUNetConfig(**kw)).eval()
    size = max(16, 2 ** (levels - 1) * 2)
    flat = _assert_same_import(ti.flatten_state_dict(tmodel.state_dict()), kw, size)
    _assert_forward_match(kw, flat, tmodel, size)


def test_wrapper_and_dataparallel_prefix(tmp_path):
    torch.manual_seed(1)
    tmodel = TorchMirror(JaxUNetConfig(**CFG_KW)).eval()
    path = str(tmp_path / "ckpt.pt")
    torch.save({"epoch": 7, "state_dict": {"module." + k: v for k, v in
                                           tmodel.state_dict().items()}}, path)
    state = ti.load_torch_state(path)
    want = jax_ti.load_torch_state(path)
    assert list(state) == list(want)
    assert all(np.array_equal(state[k], want[k]) for k in want)
    _assert_same_import(state, CFG_KW)


def test_explicit_mapping_and_safetensors_checkpoint(tmp_path):
    """A .safetensors checkpoint (keys sorted by its writer) fails the
    structural matcher loudly and imports with --map, as in the reference."""
    from safetensors.numpy import save_file

    torch.manual_seed(9)
    tmodel = TorchMirror(JaxUNetConfig(**CFG_KW)).eval()
    path = str(tmp_path / "ref.safetensors")
    save_file({k: v.numpy() for k, v in tmodel.state_dict().items()}, path)
    state = ti.load_torch_state(path)
    assert sorted(state) == sorted(jax_ti.load_torch_state(path))
    like = weights.param_template(presets.UNetConfig(**CFG_KW))
    with pytest.raises(ti.TorchImportError):
        ti.import_torch_params(state, like)
    mapping = _mirror_mapping(_jax_like(CFG_KW))
    flat = _assert_same_import(state, CFG_KW, mapping=mapping)
    _assert_forward_match(CFG_KW, flat, tmodel)


def test_shape_mismatch_is_a_clear_error():
    torch.manual_seed(5)
    tmodel = TorchMirror(JaxUNetConfig(levels=3, base_features=16, max_features=64))
    with pytest.raises(ti.TorchImportError, match="does not match"):
        ti.import_torch_params(ti.flatten_state_dict(tmodel.state_dict()),
                               weights.param_template(presets.UNetConfig(**CFG_KW)))


def test_aux_heads_and_mapping_file_are_refused(tmp_path):
    ds = weights.param_template(presets.UNetConfig(**dict(CFG_KW, deep_supervision=True)))
    with pytest.raises(ti.TorchImportError, match="aux"):
        ti.enumerate_slots(ds)
    bad = str(tmp_path / "m.json")
    with open(bad, "w") as f:
        json.dump(["not", "a", "dict"], f)
    with pytest.raises(ti.TorchImportError, match="--map"):
        ti.load_mapping(bad)


@pytest.fixture()
def tiny_parity(tmp_path, monkeypatch):
    ref = presets.get_preset("reference_parity")
    tiny = dataclasses.replace(
        ref, unet=presets.UNetConfig(**CFG_KW), workdir=str(tmp_path / "run"),
        infer=dataclasses.replace(ref.infer, canvas=(32, 32, 32),
                                  tile=(32, 32, 32), compute_dtype="float32"))
    monkeypatch.setitem(presets.PRESETS, "reference_parity", tiny)
    return tiny


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
def test_cli_end_to_end_then_predict(tmp_path, tiny_parity, fmt, capsys):
    """import_torch writes the export load_stage_params reads; the port's
    predict CLI serves it on the CPU."""
    from brats2019_tpu_torch.cli import import_torch as cli, predict
    from brats2019_tpu_torch.data import synthetic
    from brats2019_tpu_torch.utils.nifti import read_nifti

    torch.manual_seed(7)
    tmodel = TorchMirror(JaxUNetConfig(**CFG_KW)).eval()
    src = str(tmp_path / "ref.pt")
    torch.save(tmodel.state_dict(), src)
    assert cli.main([src, "--list"]) == 0
    assert "DoubleConv_0/ConvNormAct_0/Conv_0/kernel" in capsys.readouterr().out
    assert cli.main([src, "--preset", "reference_parity", "--format", fmt]) == 0
    out = tmp_path / "run" / "fine" / f"params.{fmt}"
    flat = weights.load_params(str(out))
    _assert_forward_match(CFG_KW, flat, tmodel)
    case = synthetic.write_dataset(str(tmp_path / "d"), 1, shape=(32, 32, 32))[0]
    pred = str(tmp_path / "p.nii.gz")
    rc = predict.main([case, "--preset", "reference_parity", "--device", "cpu",
                       "--output", pred])
    seg = read_nifti(pred, apply_scaling=False)[0]
    assert rc == 0 and seg.shape == (32, 32, 32)
    assert set(np.unique(seg)) <= {0, 1, 2, 4}


def test_cli_rejects_s2d_preset(tmp_path, capsys):
    from brats2019_tpu_torch.cli import import_torch as cli

    src = str(tmp_path / "ref.pt")
    torch.save(TorchMirror(JaxUNetConfig(**CFG_KW)).state_dict(), src)
    for preset in ("inference", "cascade"):
        assert cli.main([src, "--preset", preset, "--stage", "fine"]) == 2
        assert "space-to-depth" in capsys.readouterr().err


# --------------------------------------------------------------- safetensors --

def _arrays():
    rng = np.random.default_rng(0)
    return {"params/DoubleConv_0/ConvNormAct_0/Conv_0/kernel":
            rng.normal(size=(3, 3, 3, 4, 8)).astype(np.float32),
            "params/head/bias": rng.normal(size=(4,)).astype(np.float32),
            "i64": np.arange(7, dtype=np.int64), "u8": np.arange(5, dtype=np.uint8),
            "f16": rng.normal(size=(2, 3)).astype(np.float16),
            "f64": rng.normal(size=(1,)), "flag": np.array([True, False]),
            "scalar": np.array(2.5, np.float32)}


def test_safetensors_writer_is_read_by_the_package(tmp_path):
    from safetensors.numpy import load_file

    src = _arrays()
    path = str(tmp_path / "a.safetensors")
    weights.save_safetensors(path, src)
    got = load_file(path)
    assert got.keys() == src.keys()
    for k, v in src.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert got[k].tobytes() == v.tobytes(), k


def test_safetensors_reader_reads_the_package(tmp_path):
    from safetensors.numpy import save_file

    src = _arrays()
    path = str(tmp_path / "b.safetensors")
    save_file(src, path, metadata={"format": "np"})
    got = weights.load_safetensors(path)
    assert got.keys() == src.keys()
    for k, v in src.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert got[k].tobytes() == v.tobytes(), k


def test_safetensors_bf16_and_bad_files(tmp_path):
    from safetensors.torch import save_file

    t = torch.randn(3, 5).bfloat16()
    path = str(tmp_path / "bf16.safetensors")
    save_file({"w": t}, path)
    got = weights.load_safetensors(path)["w"]
    assert got.dtype == np.float32 and np.array_equal(got, t.float().numpy())
    trunc = str(tmp_path / "t.safetensors")
    with open(path, "rb") as f, open(trunc, "wb") as g:
        g.write(f.read()[:-4])
    with pytest.raises(ValueError):
        weights.load_safetensors(trunc)


def test_params_roundtrip_through_both_formats(tmp_path):
    """``save_params`` / ``load_params`` by extension, and the JAX package's
    ``export_params`` safetensors read back by the port."""
    from brats2019_tpu.train.checkpoint import export_params

    jparams = _jax_like(CFG_KW)
    path = str(tmp_path / "params.safetensors")
    export_params(path, jparams)
    want = _flat(jparams)
    got = weights.load_params(path)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    for ext in ("npz", "safetensors"):
        p = str(tmp_path / f"again.{ext}")
        weights.save_params(p, got)
        back = weights.load_params(p)
        assert all(np.array_equal(back[k], want[k]) for k in want)
