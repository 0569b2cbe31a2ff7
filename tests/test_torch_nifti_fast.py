"""PyTorch port: the native NIfTI decoder (``utils/nifti_fast.py`` +
``csrc/fastnifti.cpp``, built with g++ at first use) against the NumPy
reader and the JAX package's ``load_case``: the cases of
``tests/test_nifti_fast.py`` for the copy, every malformed file included,
plus ``load_case(backend=)`` and ``Case.meta``."""

import struct

import numpy as np
import pytest

from brats2019_tpu.data import case as ref_case
from brats2019_tpu_torch.data import synthetic
from brats2019_tpu_torch.data.case import load_case, modality_paths
from brats2019_tpu_torch.data.preprocess import brain_bbox_np
from brats2019_tpu_torch.utils import nifti_fast
from brats2019_tpu_torch.utils.nifti import read_nifti, write_nifti


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("fastnifti")
    return synthetic.write_case(str(root / "BraTS19_F_1"), shape=(48, 40, 32))


def test_the_decoder_builds_here():
    """The test host and the card's host both have g++ and zlib: the decoder
    must build and load (a silent fallback would hide a broken build)."""
    assert nifti_fast.available(), nifti_fast.build_error
    so = nifti_fast.library_path()
    assert so.exists() and so.parent.name == "host"
    assert so.parent.parent.name == "build"


def test_matches_python_reader_bit_for_bit(case_dir):
    fast, meta = nifti_fast.load_volumes_fast(modality_paths(case_dir))
    ref = load_case(case_dir, backend="python").image
    assert fast.shape == ref.shape and fast.dtype == np.float32
    assert fast.tobytes() == ref.tobytes()


def test_mismatched_modality_dims_rejected(tmp_path):
    a, b = tmp_path / "vol_a.nii.gz", tmp_path / "vol_b.nii.gz"
    write_nifti(str(a), np.ones((16, 16, 16), np.int16))
    write_nifti(str(b), np.ones((64, 64, 64), np.int16))
    assert nifti_fast.load_volumes_fast([str(a), str(b)]) is None
    assert read_nifti(str(a))[0].shape != read_nifti(str(b))[0].shape


def test_nan_scl_slope_matches_python_reader(tmp_path):
    p = tmp_path / "nanscl.nii"
    write_nifti(str(p), np.arange(64, dtype=np.int16).reshape(4, 4, 4))
    raw = bytearray(p.read_bytes())
    struct.pack_into("<2f", raw, 112, float("nan"), float("nan"))
    p.write_bytes(bytes(raw))
    fast, _ = nifti_fast.load_volumes_fast([str(p)])
    ref, _hdr = read_nifti(str(p), apply_scaling=True)
    assert np.isfinite(fast).all()
    np.testing.assert_array_equal(fast[..., 0], ref.astype(np.float32))


def test_stats_and_bbox_match(case_dir):
    fast, meta = nifti_fast.load_volumes_fast(modality_paths(case_dir))
    for c in range(4):
        vals = fast[..., c][fast[..., c] != 0]
        np.testing.assert_allclose(meta["mean"][c], vals.mean(), rtol=1e-5)
        np.testing.assert_allclose(meta["std"][c], vals.std(), rtol=1e-4)
    bbox = brain_bbox_np(fast)
    np.testing.assert_array_equal(meta["bbox_lo"], bbox.lo)
    np.testing.assert_array_equal(meta["bbox_hi"], bbox.hi)


def _corrupt(tmp_path, name, mutate):
    p = tmp_path / name
    write_nifti(str(p), np.ones((4, 4, 4), np.int16))
    raw = bytearray(p.read_bytes())
    mutate(raw)
    p.write_bytes(bytes(raw))
    return str(p)


@pytest.mark.parametrize("name,mutate", [
    ("negdim.nii", lambda raw: struct.pack_into("<h", raw, 42, -1)),
    ("voxoff.nii", lambda raw: struct.pack_into("<f", raw, 108, 100.0)),
])
def test_malformed_header_fails_cleanly(tmp_path, name, mutate):
    """A negative dim and a vox_offset past the data are ordinary failures
    (None), the process alive."""
    assert nifti_fast.load_volumes_fast([_corrupt(tmp_path, name, mutate)]) is None


def test_gzip_garbage_fails_cleanly(tmp_path):
    p = str(tmp_path / "junk.nii.gz")
    with open(p, "wb") as f:
        f.write(b"\x1f\x8b" + b"\x00" * 64)
    assert nifti_fast.load_volumes_fast([p]) is None


def test_truncated_data_fails_cleanly(tmp_path):
    p = tmp_path / "trunc.nii"
    write_nifti(str(p), np.ones((8, 8, 8), np.int16))
    p.write_bytes(p.read_bytes()[:-32])
    assert nifti_fast.load_volumes_fast([str(p)]) is None


@pytest.mark.parametrize("hard", [False, True])
def test_load_case_backends_match_the_reference(tmp_path, hard):
    """``load_case`` under each backend against the JAX package's: the same
    image and labels bit for bit; ``meta`` equal to the reference's native
    meta (native, auto) or None (python)."""
    d = synthetic.write_dataset(str(tmp_path), 1, shape=(40, 36, 28), seed0=11,
                                hard=hard)[0]
    ref_native = ref_case.load_case(d, load_seg=True, backend="native")
    ref_py = ref_case.load_case(d, load_seg=True, backend="python")
    assert ref_py.meta is None
    for backend in ("auto", "native", "python"):
        got = load_case(d, load_seg=True, backend=backend)
        assert got.image.tobytes() == ref_py.image.tobytes()
        assert got.seg.tobytes() == ref_py.seg.tobytes()
        assert got.header.raw == ref_py.header.raw
        if backend == "python":
            assert got.meta is None
            continue
        assert got.meta.keys() == ref_native.meta.keys()
        for k in got.meta:
            np.testing.assert_array_equal(got.meta[k], ref_native.meta[k])
        bbox = brain_bbox_np(got.image)
        assert tuple(got.meta["bbox_lo"]) == bbox.lo
        assert tuple(got.meta["bbox_hi"]) == bbox.hi


def test_native_backend_raises_when_unavailable(tmp_path, monkeypatch):
    d = synthetic.write_dataset(str(tmp_path), 1, shape=(24, 20, 16))[0]
    monkeypatch.setattr(nifti_fast, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native loader"):
        load_case(d, backend="native")
    got = load_case(d, backend="auto")
    assert got.meta is None
    with pytest.raises(ValueError, match="backend"):
        load_case(d, backend="fast")


def test_predictor_takes_the_fused_bbox_from_meta(tmp_path):
    """The predictor's payload from the decoder's meta equals the one from
    the strided scan, and the memo keeps the two apart."""
    import dataclasses

    from brats2019_tpu_torch.configs.presets import get_preset
    from brats2019_tpu_torch.infer.predictor import Predictor
    from brats2019_tpu_torch.utils.weights import init_params

    exp = get_preset("unit")
    exp = dataclasses.replace(exp, infer=dataclasses.replace(
        exp.infer, canvas=(32, 32, 32)))
    d = synthetic.write_dataset(str(tmp_path), 1, shape=(40, 36, 28), seed0=2)[0]
    c = load_case(d)
    assert c.meta is not None
    pred = Predictor(exp, init_params(exp.unet, 0), device="cpu")
    small_m, dst_m, bbox_m = pred._encode_host(c.image, c.meta)
    small_s, dst_s, bbox_s = pred._encode_host(c.image)
    assert (bbox_m.lo, bbox_m.hi) == (bbox_s.lo, bbox_s.hi) and dst_m == dst_s
    assert small_m.equal(small_s)
    pred._memo_encode(c.image, c.meta)
    pred._memo_encode(c.image)
    assert len(pred._payload_memo) == 2
    a, _ = pred.predict_case(c)
    b, _ = pred.predict_arrays(c.image)
    assert a.tobytes() == b.tobytes()
