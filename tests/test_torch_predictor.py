"""PyTorch port: Predictor.predict_arrays and the port's predict CLI
(--device cpu) against the JAX Predictor on synthetic cases, with weights
written by the JAX package's export_params."""

import dataclasses
import os
import shutil
import time

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


@pytest.mark.parametrize("flags", [["--no-tta"], ["--no-cascade"],
                                   ["--no-tta", "--no-cascade"]])
def test_port_cli_no_tta_no_cascade_match_jax_predictor(tmp_path, workdir,
                                                        monkeypatch, flags):
    """--no-tta / --no-cascade: the reference's semantics (tta_flips=False,
    cascade=False); the labels equal the JAX Predictor's on the same
    config (monolithic with a cascade, the staged sweep over the canvas, the
    monolithic sweep over the canvas)."""
    from brats2019_tpu_torch.models import cascade as tcascade

    monkeypatch.setitem(presets.PRESETS, "tiny_cascade", _exp(presets))
    d = synthetic.write_case(str(tmp_path / "BraTS19_F_1"), shape=SHAPE, seed=23,
                             hard=True)
    out = str(tmp_path / "pred.nii.gz")
    rc = port_cli.main([d, "--preset", "tiny_cascade", "--workdir", workdir,
                        "--device", "cpu", "--output", out, *flags])
    assert rc == 0
    infer = dict(tta_flips="--no-tta" not in flags,
                 cascade="--no-cascade" not in flags)
    exp_j = _exp(jax_presets)
    exp_j = dataclasses.replace(exp_j, infer=dataclasses.replace(exp_j.infer,
                                                                 **infer))
    pf, pc = _jax_params(workdir)
    want_path, _ = JaxPredictor(exp_j, pf, pc if infer["cascade"] else None
                                ).predict_dir(d, str(tmp_path / "ref.nii.gz"))
    got, _ = read_nifti(out, apply_scaling=False)
    want, _ = read_nifti(want_path, apply_scaling=False)
    assert got.shape == SHAPE and set(np.unique(got)) <= {0, 1, 2, 4}
    assert (got != want).mean() < 1e-4, int((got != want).sum())
    exp_t = _exp(presets)
    exp_t = dataclasses.replace(exp_t, infer=dataclasses.replace(exp_t.infer,
                                                                 **infer))
    program = Predictor(exp_t, _npz(workdir, "fine"), None, device="cpu").program
    want_cls = (tcascade.StagedSweep if flags == ["--no-cascade"]
                else tcascade.Monolithic)
    assert isinstance(program, want_cls)


def test_port_cli_int8_and_pairing_match_jax_predictor(tmp_path, workdir,
                                                       monkeypatch, capsys):
    """``--transfer-dtype int8 --batch-volumes 2`` on a root of three cases
    (one pair and an odd tail): the labels equal the JAX predictor's on the
    same config except on ties; with --ensemble the pairing flag is noted as
    having no effect."""
    monkeypatch.setitem(presets.PRESETS, "tiny_cascade", _exp(presets))
    root = tmp_path / "cases"
    dirs = synthetic.write_dataset(str(root), 3, shape=SHAPE, seed0=30, hard=True)
    flags = ["--transfer-dtype", "int8", "--batch-volumes", "2"]
    rc = port_cli.main([str(root), "--preset", "tiny_cascade", "--workdir",
                        workdir, "--device", "cpu", *flags])
    assert rc == 0 and "3 case(s)" in capsys.readouterr().out
    pf, pc = _jax_params(workdir)
    ref = JaxPredictor(_exp(jax_presets, transfer_dtype="int8", batch_volumes=2),
                       pf, pc)
    outs = ref.predict_dirs(dirs, [str(tmp_path / f"ref{i}.nii.gz")
                                   for i in range(3)])
    for d, want_path in zip(dirs, outs):
        name = os.path.basename(d)
        got = read_nifti(os.path.join(d, f"{name}_pred.nii.gz"),
                         apply_scaling=False)[0]
        want = read_nifti(want_path, apply_scaling=False)[0]
        assert got.shape == SHAPE and set(np.unique(got)) <= {0, 1, 2, 4}
        assert (got != want).mean() < 1e-4, int((got != want).sum())
    rc = port_cli.main([dirs[0], "--preset", "tiny_cascade", "--workdir",
                        workdir, "--device", "cpu", "--ensemble", workdir,
                        "--output", str(tmp_path / "ens.nii.gz"), *flags])
    assert rc == 0
    assert "--batch-volumes has no effect with --ensemble" in capsys.readouterr().err


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


def test_int8_transfer_matches_the_jax_int8_path(workdir):
    """transfer_dtype="int8": the payload is the JAX package's bitwise
    (int8, half the bf16 payload's bytes), the masks equal the JAX int8
    predictor's except on ties and the bf16 path's on > 98% of voxels
    (tests/test_inference.py:227), the whole-canvas int8 transfer equals the
    bucketed one, and an unknown transfer dtype is refused."""
    import torch

    pf, pc = _jax_params(workdir)
    ref8 = JaxPredictor(_exp(jax_presets, transfer_dtype="int8"), pf, pc)
    port8 = _port(workdir, transfer_dtype="int8")
    port16 = _port(workdir)
    whole8 = _port(workdir, transfer_dtype="int8", transfer_bucket=0)
    for seed in (10, 11):
        image = synthetic.make_hard_case_arrays(seed=seed, shape=SHAPE)[0]
        small, dst, bbox = port8._encode_host(image)
        small_j, dst_j, bbox_j = ref8._encode_host(image)
        assert small.dtype == torch.int8 and small_j.dtype == np.int8
        np.testing.assert_array_equal(small.numpy(), small_j)
        assert dst == tuple(int(v) for v in dst_j)
        assert (bbox.lo, bbox.hi) == (bbox_j.lo, bbox_j.hi)
        assert 2 * small.nbytes == port16._encode_host(image)[0].nbytes
        assert whole8._encode_host(image)[1] == (0, 0, 0)
        want, _ = ref8.predict_arrays(image)
        got, _ = port8.predict_arrays(image)
        assert got.shape == SHAPE and (got > 0).sum() > 100
        assert (got != want).mean() < 1e-4, int((got != want).sum())
        assert (got == port16.predict_arrays(image)[0]).mean() > 0.98
        np.testing.assert_array_equal(whole8.predict_arrays(image)[0], got)
    with pytest.raises(ValueError, match="transfer_dtype"):
        _port(workdir, transfer_dtype="Int8")


def test_int8_payload_cache_round_trip(tmp_path, workdir, monkeypatch):
    """An int8 entry is stored as int8, reads back bitwise in both packages,
    sits beside the bf16 entry of the same case (the key holds the dtype),
    and a hit gives the masks of a miss."""
    import torch

    from brats2019_tpu.infer import payload_cache as ref_cache
    from brats2019_tpu_torch.infer import payload_cache, predictor as pmod

    cache = str(tmp_path / "cache")
    port8 = _port(workdir, prep_cache_dir=cache, transfer_dtype="int8")
    d = synthetic.write_dataset(str(tmp_path / "cases"), 1, shape=(48, 40, 36),
                                hard=True)[0]
    miss = port8.predict_dir(d, str(tmp_path / "miss.nii.gz"))[0]
    _port(workdir, prep_cache_dir=cache).prefill_payload_cache(d)
    path = payload_cache.payload_cache_path(
        cache, d, port8.canvas, port8.exp.infer.transfer_bucket, "int8")
    assert sorted(os.listdir(cache)) == sorted(
        [os.path.basename(path), os.path.basename(payload_cache.payload_cache_path(
            cache, d, port8.canvas, port8.exp.infer.transfer_bucket, "bfloat16"))])
    with np.load(path) as z:
        assert z["small"].dtype == np.int8
    small_t, dst_t, bbox_t = payload_cache.load_payload(path)
    small_j, dst_j, bbox_j = ref_cache.load_payload(path)
    assert small_t.dtype == torch.int8
    np.testing.assert_array_equal(small_t.numpy(), small_j)
    assert dst_t == tuple(int(v) for v in dst_j)
    assert (bbox_t.lo, bbox_t.hi) == (bbox_j.lo, bbox_j.hi)
    other = str(tmp_path / "from_jax.npz")
    ref_cache.store_payload(other, small_j, dst_j, bbox_j)
    assert torch.equal(payload_cache.load_payload(other)[0], small_t)
    monkeypatch.setattr(pmod, "load_case",
                        lambda *a, **k: pytest.fail("decoded on a cache hit"))
    hit = port8.predict_dir(d, str(tmp_path / "hit.nii.gz"))[0]
    np.testing.assert_array_equal(read_nifti(hit, apply_scaling=False)[0],
                                  read_nifti(miss, apply_scaling=False)[0])


def test_transfer_bound_hint_policy(capsys):
    """The reference's four cases (tests/test_inference.py:427), and the
    port's policy equal to the reference's on a grid of inputs: the same
    verdict and the same median, share and cadence in the message (the port
    hands it the copy times alone and words the message so)."""
    from brats2019_tpu.infer.predictor import transfer_bound_hint as ref_hint
    from brats2019_tpu_torch.infer.predictor import transfer_bound_hint

    hint = transfer_bound_hint([0.1] * 8, 8 * 0.12, 8, "bfloat16")
    assert hint is not None and "int8" in hint
    assert transfer_bound_hint([0.1] * 8, 8 * 0.12, 8, "int8") is None
    assert transfer_bound_hint([0.01] * 8, 8 * 0.12, 8, "bfloat16") is None
    assert transfer_bound_hint([0.1] * 2, 2 * 0.12, 2, "bfloat16") is None
    for prep in ([0.05] * 6, [0.2, 0.01, 0.3, 0.02, 0.25], [0.06] * 3):
        for wall in (0.0, 0.3, 0.6, 2.0):
            for dt in ("bfloat16", "int8"):
                a = transfer_bound_hint(prep, wall, len(prep), dt)
                b = ref_hint(prep, wall, len(prep), dt)
                assert (a is None) == (b is None)
                if a is not None:
                    numbers = lambda m: m.split("(")[1].split(")")[0]
                    assert numbers(a) == numbers(b)


# ------------------------------------------------ the pipelined serving path --

def _port(workdir, **infer):
    return Predictor(_exp(presets, **infer), _npz(workdir, "fine"),
                     _npz(workdir, "coarse"), device="cpu")


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("postproc", ["host", "device"])
def test_predict_arrays_many_equals_one_by_one(workdir, depth, postproc):
    port = _port(workdir, serving_depth=depth, postproc=postproc)
    images = [synthetic.make_hard_case_arrays(seed=s, shape=SHAPE)[0]
              for s in (10, 11, 12)]
    serial = [port.predict_arrays(img)[0] for img in images]
    piped = port.predict_arrays_many(images)
    assert len(piped) == 3
    for a, b in zip(serial, piped):
        assert b.dtype == np.uint8 and b.shape == SHAPE
        np.testing.assert_array_equal(a, b)


def test_device_postproc_labels_equal_host_postproc_labels(workdir):
    """The same labels through the device filter and through host scipy."""
    image = synthetic.make_hard_case_arrays(seed=10, shape=SHAPE)[0]
    kw = dict(min_component_voxels=40, et_min_voxels=100000)
    host = _port(workdir, postproc="host", **kw).predict_arrays(image)[0]
    dev = _port(workdir, postproc="device", **kw).predict_arrays(image)[0]
    raw = _port(workdir, min_component_voxels=0, et_min_voxels=0
                ).predict_arrays(image)[0]
    np.testing.assert_array_equal(host, dev)
    assert (raw != host).any() and (host == 3).sum() == 0


@pytest.mark.parametrize("depth", [1, 2])
def test_predict_dirs_equals_predict_dir_bitwise(tmp_path, workdir, depth):
    port = _port(workdir, serving_depth=depth, postproc="device",
                 prep_cache_dir=str(tmp_path / "cache"))
    dirs = synthetic.write_dataset(str(tmp_path / "cases"), 3, shape=(48, 40, 36))
    serial = [read_nifti(port.predict_dir(d, str(tmp_path / f"s{i}.nii.gz"))[0],
                         apply_scaling=False)[0] for i, d in enumerate(dirs)]
    outs = port.predict_dirs(dirs, [str(tmp_path / f"p{i}.nii.gz")
                                    for i in range(3)])
    for a, out in zip(serial, outs):
        np.testing.assert_array_equal(a, read_nifti(out, apply_scaling=False)[0])


def test_payload_cache_hit_ships_the_miss_payload(tmp_path, workdir, monkeypatch):
    import torch

    from brats2019_tpu.infer import payload_cache as ref_cache
    from brats2019_tpu_torch.infer import payload_cache, predictor as pmod

    cache = str(tmp_path / "cache")
    port = _port(workdir, prep_cache_dir=cache)
    d = synthetic.write_dataset(str(tmp_path / "cases"), 1, shape=(48, 40, 36))[0]
    args = (cache, d, port.canvas, port.exp.infer.transfer_bucket, "bfloat16")
    path = payload_cache.payload_cache_path(*args)
    assert path == ref_cache.payload_cache_path(*args)   # one cache, two packages
    miss = port._prep_dir_to(d)
    assert os.listdir(cache) == [os.path.basename(path)]
    monkeypatch.setattr(pmod, "load_case",
                        lambda *a, **k: pytest.fail("decoded on a cache hit"))
    hit = port._prep_dir_to(d)
    assert hit[0] == miss[0] and hit[1].raw == miss[1].raw
    assert hit[3] == miss[3] and hit[4] == miss[4]
    assert torch.equal(hit[2][0].view(torch.int16), miss[2][0].view(torch.int16))
    assert port.prefill_payload_cache(d) is False          # already warm
    # the entry reads in the JAX package, bit for bit, and the other way round
    small_j, dst_j, bbox_j = ref_cache.load_payload(path)
    small_t, dst_t, bbox_t = payload_cache.load_payload(path)
    np.testing.assert_array_equal(small_j.view(np.int16),
                                  small_t.view(torch.int16).numpy())
    assert tuple(int(v) for v in dst_j) == dst_t
    assert (bbox_j.lo, bbox_j.hi, bbox_j.full_shape) == (
        bbox_t.lo, bbox_t.hi, bbox_t.full_shape)
    other = str(tmp_path / "from_jax.npz")
    ref_cache.store_payload(other, small_j, dst_j, bbox_j)
    again = payload_cache.load_payload(other)
    assert torch.equal(again[0].view(torch.int16), small_t.view(torch.int16))
    # a corrupt entry is a miss, rebuilt on the next prep
    with open(path, "wb") as f:
        f.write(b"not an npz")
    assert payload_cache.load_payload(path) is None


def test_prefill_then_serve_is_a_hit(tmp_path, workdir, monkeypatch):
    from brats2019_tpu_torch.infer import predictor as pmod

    port = _port(workdir, prep_cache_dir=str(tmp_path / "cache"))
    d = synthetic.write_dataset(str(tmp_path / "cases"), 1, shape=(48, 40, 36))[0]
    assert _port(workdir).prefill_payload_cache(d) is False     # cache off
    want = read_nifti(_port(workdir).predict_dir(
        d, str(tmp_path / "nocache.nii.gz"))[0], apply_scaling=False)[0]
    assert port.prefill_payload_cache(d) is True
    monkeypatch.setattr(pmod, "load_case",
                        lambda *a, **k: pytest.fail("decoded after a prefill"))
    out, _ = port.predict_dir(d, str(tmp_path / "cached.nii.gz"))
    np.testing.assert_array_equal(read_nifti(out, apply_scaling=False)[0], want)
    # a re-uploaded case (new mtime) supersedes the entry: one file remains
    monkeypatch.undo()
    os.utime(os.path.join(d, os.path.basename(d) + "_t1.nii.gz"),
             ns=(1, 1_000_000_000))
    assert port.prefill_payload_cache(d) is True
    assert len(os.listdir(str(tmp_path / "cache"))) == 1


def test_payload_memo_hit_miss_and_weakref_death(workdir, monkeypatch):
    import gc

    port = _port(workdir, payload_memo_volumes=2)
    calls = []
    real = port._encode_host
    monkeypatch.setattr(port, "_encode_host",
                        lambda img: calls.append(id(img)) or real(img))
    a = synthetic.make_hard_case_arrays(seed=10, shape=SHAPE)[0]
    b = synthetic.make_hard_case_arrays(seed=11, shape=SHAPE)[0]
    p1 = port._memo_encode(a)
    assert port._memo_encode(a) is p1 and len(calls) == 1      # hit
    port._memo_encode(b)
    assert len(calls) == 2 and len(port._payload_memo) == 2     # miss
    c = a.copy()
    port._memo_encode(c)                                        # evicts the oldest
    assert len(port._payload_memo) == 2 and id(a) not in port._payload_memo
    del b, c
    gc.collect()
    port._memo_encode(a)                 # dead entries are swept on the next call
    assert list(port._payload_memo) == [id(a)]
    off = _port(workdir, payload_memo_volumes=0)
    assert off._memo_encode(a) is not off._memo_encode(a)


def test_reload_params_and_warmup(workdir):
    from brats2019_tpu_torch.utils.weights import init_params, load_params_npz

    port = _port(workdir)
    image = synthetic.make_hard_case_arrays(seed=10, shape=SHAPE)[0]
    before = port.predict_arrays(image)[0]
    assert port.warmup(stage="primary") > 0 and port.warmup(stage="rest") >= 0
    with pytest.raises(ValueError):
        port.warmup(stage="everything")
    new_fine = init_params(presets.UNetConfig(**FINE_KW), seed=3)
    with pytest.raises(ValueError, match="params_coarse"):
        port.reload_params(new_fine)
    port.reload_params(new_fine, _npz(workdir, "coarse"))
    after = port.predict_arrays(image)[0]
    fresh = Predictor(_exp(presets), new_fine, _npz(workdir, "coarse"),
                      device="cpu").predict_arrays(image)[0]
    np.testing.assert_array_equal(after, fresh)
    assert (after != before).any()
    port.reload_params(load_params_npz(_npz(workdir, "fine")),
                       _npz(workdir, "coarse"))
    np.testing.assert_array_equal(port.predict_arrays(image)[0], before)
    with pytest.raises((RuntimeError, KeyError)):      # structure must match
        port.reload_params({"params/nope": np.zeros(1)}, _npz(workdir, "coarse"))


def test_predictor_prints_the_transfer_hint_once(tmp_path, workdir, monkeypatch,
                                                 capsys):
    """Both pipelined entry points hand the policy the batch's copy times,
    the batch wall and size, and the transfer dtype; the advisory prints at
    most once per predictor."""
    from brats2019_tpu_torch.infer import predictor as pmod

    images = [synthetic.make_hard_case_arrays(seed=s, shape=SHAPE)[0]
              for s in (10, 11)]
    seen = []

    def policy(prep_s, wall_s, n, dtype):
        seen.append((len(prep_s), n, dtype, wall_s > 0))
        return "note: --transfer-dtype int8 (test)"

    monkeypatch.setattr(pmod, "transfer_bound_hint", policy)
    port = _port(workdir, transfer_dtype="int8")
    port.predict_arrays_many(images)
    port.predict_arrays_many(images)
    assert seen == [(2, 2, "int8", True)]
    assert capsys.readouterr().err.count("--transfer-dtype int8 (test)") == 1
    assert len(port._copy_times) == 4
    seen.clear()
    other = _port(workdir)
    dirs = synthetic.write_dataset(str(tmp_path), 3, shape=(48, 40, 36))
    other.predict_dirs(dirs, [None] * 3)
    assert seen == [(3, 3, "bfloat16", True)]


def test_transfer_hint_times_the_copy_alone(tmp_path, workdir, monkeypatch):
    """The advisory reads the host-to-device copy alone: a decode that
    takes most of the cadence (here a 0.3 s sleep in it) is not in the
    times the policy gets, so it gives no int8 advice for it."""
    from brats2019_tpu_torch.infer import predictor as pmod

    real, policy = pmod.load_case, pmod.transfer_bound_hint
    monkeypatch.setattr(pmod, "load_case",
                        lambda *a, **k: time.sleep(0.3) or real(*a, **k))
    got = []
    monkeypatch.setattr(pmod, "transfer_bound_hint",
                        lambda copy_s, wall_s, n, dtype: got.append(
                            (list(copy_s), wall_s, n)) or None)
    port = _port(workdir)
    dirs = synthetic.write_dataset(str(tmp_path), 4, shape=(48, 40, 36))
    port.predict_dirs(dirs, [None] * 4)
    (copy_s, wall_s, n), = got
    depth = port.exp.infer.serving_depth
    assert n == 4 and len(copy_s) == 4 and wall_s >= 4 * 0.3 / depth
    assert max(copy_s) < 0.3
    assert policy(copy_s, wall_s, n, "bfloat16") is None
