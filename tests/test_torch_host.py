"""PyTorch port: the NumPy host copies (constants, NIfTI I/O, case loading,
synthetic cases of both generators, label postprocessing, the training path's
preprocessing, k-fold split, metrics logger, the evaluation metrics, the
uncertainty maps and the int8 transfer quantizer) pinned to their originals
in the JAX package."""

import ast
import inspect
import os
import struct

import numpy as np
import pytest

from brats2019_tpu.data import case as ref_case
from brats2019_tpu.data import constants as ref_constants
from brats2019_tpu.data import preprocess as ref_preprocess
from brats2019_tpu.data import synthetic as ref_synthetic
from brats2019_tpu.infer import postprocess as ref_post
from brats2019_tpu.infer import tiling as ref_tiling
from brats2019_tpu.infer import uncertainty as ref_uncertainty
from brats2019_tpu.train import metrics as ref_metrics
from brats2019_tpu.utils import logging as ref_logging
from brats2019_tpu.utils import nifti as ref_nifti
from brats2019_tpu_torch.data import case, constants, preprocess, synthetic
from brats2019_tpu_torch.infer import postprocess, tiling, uncertainty
from brats2019_tpu_torch.train import metrics
from brats2019_tpu_torch.utils import logging as port_logging
from brats2019_tpu_torch.utils import nifti

SHAPE = (28, 24, 18)


def test_constants_match_reference():
    for name in ("MODALITIES", "NUM_MODALITIES", "NUM_CLASSES", "VOLUME_SHAPE",
                 "DISK_LABELS"):
        assert getattr(constants, name) == getattr(ref_constants, name)
    labels = np.random.default_rng(0).integers(0, 4, size=(5, 6, 7)).astype(np.uint8)
    disk = constants.internal_to_disk(labels)
    np.testing.assert_array_equal(disk, ref_constants.internal_to_disk(labels))
    np.testing.assert_array_equal(constants.disk_to_internal(disk),
                                  ref_constants.disk_to_internal(disk))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_case_arrays_match_reference(seed):
    got = synthetic.make_case_arrays(seed=seed, shape=SHAPE)
    want = ref_synthetic.make_case_arrays(seed=seed, shape=SHAPE)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_written_dataset_is_byte_identical(tmp_path):
    got = synthetic.write_dataset(str(tmp_path / "port"), 2, shape=SHAPE, seed0=4)
    want = ref_synthetic.write_dataset(str(tmp_path / "ref"), 2, shape=SHAPE,
                                       seed0=4)
    assert [os.path.basename(d) for d in got] == [os.path.basename(d) for d in want]
    for g, w in zip(got, want):
        assert sorted(os.listdir(g)) == sorted(os.listdir(w))
        for f in os.listdir(g):
            with open(os.path.join(g, f), "rb") as a, open(os.path.join(w, f), "rb") as b:
                assert a.read() == b.read(), f


@pytest.mark.parametrize("ext", [".nii.gz", ".nii"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_nifti_roundtrip_matches_reference(tmp_path, ext, dtype):
    rng = np.random.default_rng(1)
    data = (rng.uniform(0, 100, size=(6, 5, 4))).astype(dtype)
    affine = np.array([[-1.5, 0, 0, 3], [0, -1, 0, 239], [0, 0, 2, -7], [0, 0, 0, 1]])
    p_got, p_want = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
    nifti.write_nifti(p_got, data, affine=affine)
    ref_nifti.write_nifti(p_want, data, affine=affine)
    with open(p_got, "rb") as a, open(p_want, "rb") as b:
        assert a.read() == b.read()
    got, hdr = nifti.read_nifti(p_want)
    want, ref_hdr = ref_nifti.read_nifti(p_want)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(hdr.affine(), ref_hdr.affine())
    assert hdr.raw == ref_hdr.raw
    # write-back with the input header, as the predictor does
    labels = rng.integers(0, 5, size=data.shape).astype(np.uint8)
    nifti.write_nifti(p_got, labels, like=hdr)
    ref_nifti.write_nifti(p_want, labels, like=ref_hdr)
    with open(p_got, "rb") as a, open(p_want, "rb") as b:
        assert a.read() == b.read()


def test_nifti_scaling_and_qform_match_reference(tmp_path):
    """A header with scl_slope/scl_inter and a qform-only affine, read by
    both readers."""
    p = str(tmp_path / "s.nii")
    ref_nifti.write_nifti(p, np.arange(60, dtype=np.int16).reshape(5, 4, 3))
    with open(p, "rb") as f:
        raw = bytearray(f.read())
    struct.pack_into("<2f", raw, 112, 0.5, 3.0)           # slope, inter
    struct.pack_into("<2h", raw, 252, 1, 0)               # qform only
    struct.pack_into("<3f", raw, 256, 0.1, -0.2, 0.3)     # quatern b, c, d
    struct.pack_into("<f", raw, 76, -1.0)                 # qfac
    with open(p, "wb") as f:
        f.write(bytes(raw))
    for scaling in (True, False):
        got, hdr = nifti.read_nifti(p, apply_scaling=scaling)
        want, ref_hdr = ref_nifti.read_nifti(p, apply_scaling=scaling)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hdr.affine(), ref_hdr.affine())


def test_case_discovery_and_loading_match_reference(tmp_path):
    root = str(tmp_path / "cases")
    ref_synthetic.write_dataset(root, 2, shape=SHAPE, seed0=7)
    os.makedirs(os.path.join(root, "not_a_case"))
    got = case.discover_cases(root)
    assert got == ref_case.discover_cases(root) and len(got) == 2
    assert case.discover_cases(got[0]) == [got[0]]
    assert case.discover_cases(str(tmp_path / "missing")) == []
    for d in got:
        c = case.load_case(d)
        r = ref_case.load_case(d, load_seg=False, backend="python")
        assert c.name == r.name
        assert c.image.dtype == r.image.dtype == np.float32
        np.testing.assert_array_equal(c.image, r.image)
        assert c.header.raw == r.header.raw
    os.remove(os.path.join(got[0], os.path.basename(got[0]) + "_t2.nii.gz"))
    with pytest.raises(FileNotFoundError, match="t2"):
        case.load_case(got[0])


@pytest.mark.parametrize("min_voxels,et_min", [(16, 32), (0, 0), (200, 500)])
def test_postprocess_matches_reference(min_voxels, et_min):
    rng = np.random.default_rng(min_voxels)
    labels = np.zeros((30, 28, 20), np.uint8)
    labels[4:14, 5:15, 3:12] = rng.integers(1, 4, size=(10, 10, 9))
    for _ in range(12):                       # small specks to filter
        x, y, z = rng.integers(0, 18, size=3)
        labels[x:x + 2, y + 10:y + 11, z] = rng.integers(1, 4)
    got = postprocess.postprocess_labels(
        labels, min_component_voxels=min_voxels, et_min_voxels=et_min)
    want = ref_post.postprocess_labels(
        labels, min_component_voxels=min_voxels, et_min_voxels=et_min)
    np.testing.assert_array_equal(got, want)
    tiny_et = np.zeros((8, 8, 8), np.uint8)
    tiny_et[2:4, 2:4, 2:4] = 3
    np.testing.assert_array_equal(postprocess.suppress_tiny_et_np(tiny_et, 32),
                                  ref_post.suppress_tiny_et_np(tiny_et, 32))


def test_case_seg_loading_matches_reference(tmp_path):
    root = str(tmp_path / "cases")
    dirs = ref_synthetic.write_dataset(root, 2, shape=SHAPE, seed0=9)
    for d in dirs:
        c = case.load_case(d, load_seg=True)
        r = ref_case.load_case(d, backend="python")
        assert c.seg.dtype == r.seg.dtype == np.uint8
        np.testing.assert_array_equal(c.seg, r.seg)
        assert case.seg_path(d) == ref_case.seg_path(d)
        assert case.load_case(d).seg is None
    os.remove(case.seg_path(dirs[0]))
    assert case.load_case(dirs[0], load_seg=True).seg is None


@pytest.mark.parametrize("n,folds", [(7, 3), (2, 2), (5, 5)])
def test_kfold_split_matches_reference(n, folds):
    cases = [f"c{i}" for i in range(n)]
    for fold in range(folds):
        assert case.kfold_split(cases, folds, fold) == ref_case.kfold_split(
            cases, folds, fold)
    for bad in ((1, 0), (folds, folds), (folds, -1)):
        with pytest.raises(ValueError):
            case.kfold_split(cases, *bad)


def test_zscore_and_crop_match_reference():
    rng = np.random.default_rng(2)
    img = rng.normal(3.0, 2.0, size=(12, 10, 8, 4)).astype(np.float32)
    img[:3] = 0
    img[..., 2] = 0                                  # an all-zero channel
    np.testing.assert_array_equal(preprocess.zscore_np(img),
                                  ref_preprocess.zscore_np(img))
    bbox = ref_preprocess.brain_bbox_np(img)
    np.testing.assert_array_equal(preprocess.crop_np(img, bbox),
                                  ref_preprocess.crop_np(img, bbox))


def test_metrics_logger_is_the_reference_but_for_the_primary_check(tmp_path):
    """Every top-level statement of the copy equals the original's, except
    the module docstring and ``_is_primary_process``, which asks jax in the
    original and is always true in the one-process port."""
    def body(mod):
        tree = ast.parse(inspect.getsource(mod))
        return {getattr(n, "name", i): ast.dump(n)
                for i, n in enumerate(tree.body[1:])}

    got, want = body(port_logging), body(ref_logging)
    assert got.pop("_is_primary_process") != want.pop("_is_primary_process")
    assert got == want
    assert port_logging._is_primary_process()
    lg = port_logging.MetricsLogger(str(tmp_path), name="fine")
    lg.log(3, {"loss": 1.5})
    lg.close()
    with open(tmp_path / "fine_metrics.jsonl") as f:
        assert '"loss": 1.5' in f.read()


def test_tile_origins_and_blend_weight_are_the_reference_copies():
    """The NumPy functions of infer/tiling.py are the reference's statement
    for statement, and give byte-equal arrays."""
    def fn(mod, name):
        tree = ast.parse(inspect.getsource(getattr(mod, name)))
        return ast.dump(tree.body[0])

    for name in ("tile_origins", "blend_weight"):
        assert fn(tiling, name) == fn(ref_tiling, name), name
    for vol, tile, overlap in (((192, 224, 160), (128, 128, 128), 0.5),
                               ((24, 16, 16), (16, 16, 16), 0.5),
                               ((37, 16, 9), (16, 16, 16), 0.25),
                               ((128, 128, 128), (128, 128, 128), 0.5)):
        got = tiling.tile_origins(vol, tile, overlap)
        want = ref_tiling.tile_origins(vol, tile, overlap)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    got = tiling.tile_origins((192, 224, 160), (128, 128, 128))
    assert sorted(map(tuple, got.tolist())) == [
        (x, y, z) for x in (0, 64) for y in (0, 48, 96) for z in (0, 32)]
    for tile, mode, sigma in (((128, 128, 128), "gaussian", 0.125),
                              ((16, 8, 32), "gaussian", 0.25),
                              ((16, 16, 16), "softmax", 0.125)):
        got = tiling.blend_weight(tile, mode, sigma)
        want = ref_tiling.blend_weight(tile, mode, sigma)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def _fn_ast(mod, name, drop_docstring=False):
    """The AST of ``mod.name``'s source (its docstring dropped if asked)."""
    node = ast.parse(inspect.getsource(getattr(mod, name))).body[0]
    if drop_docstring and ast.get_docstring(node) is not None:
        node.body = node.body[1:]
    return ast.dump(node)


HARD = ("_smooth_field", "_blob_rho", "_blob_mask", "make_hard_case_arrays")


@pytest.mark.parametrize("name", HARD)
def test_hard_generator_functions_are_the_reference_copies(name):
    """Statement for statement the original (make_hard_case_arrays' docstring
    is the port's own)."""
    assert _fn_ast(synthetic, name, True) == _fn_ast(ref_synthetic, name, True)


@pytest.mark.parametrize("seed", [10, 11, 13])
def test_hard_case_arrays_are_byte_equal(seed):
    got = synthetic.make_hard_case_arrays(seed=seed, shape=(64, 64, 48))
    want = ref_synthetic.make_hard_case_arrays(seed=seed, shape=(64, 64, 48))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_written_hard_dataset_is_byte_identical(tmp_path):
    got = synthetic.write_dataset(str(tmp_path / "port"), 2, shape=SHAPE, seed0=12,
                                  hard=True)
    want = ref_synthetic.write_dataset(str(tmp_path / "ref"), 2, shape=SHAPE,
                                       seed0=12, hard=True)
    for g, w in zip(got, want):
        assert sorted(os.listdir(g)) == sorted(os.listdir(w))
        for f in os.listdir(g):
            with open(os.path.join(g, f), "rb") as a, open(os.path.join(w, f), "rb") as b:
                assert a.read() == b.read(), f


METRICS = ("_surface", "hd95_np", "region_hd95_np", "region_sens_spec_np")


@pytest.mark.parametrize("name", METRICS)
def test_eval_metrics_are_the_reference_copies(name):
    assert _fn_ast(metrics, name) == _fn_ast(ref_metrics, name)


def test_eval_metrics_give_the_reference_values():
    rng = np.random.default_rng(3)
    gt = np.zeros((20, 18, 16), np.uint8)
    gt[4:14, 3:12, 2:11] = rng.integers(1, 4, size=(10, 9, 9))
    pred = gt.copy()
    pred[5:9, 4:8, 3:6] = 0
    pred[15:17, 14:16, 12:14] = 3                      # a false-positive island
    for spacing in ((1.0, 1.0, 1.0), (0.9, 1.2, 2.5)):
        assert metrics.region_hd95_np(pred, gt, spacing) == \
            ref_metrics.region_hd95_np(pred, gt, spacing)
    assert metrics.region_sens_spec_np(pred, gt) == ref_metrics.region_sens_spec_np(
        pred, gt)
    empty = np.zeros_like(gt)
    assert metrics.hd95_np(empty, empty) == 0.0
    assert metrics.hd95_np(empty, gt > 0) == float("inf")
    assert metrics.region_dice_np(pred, gt) == ref_metrics.region_dice_np(pred, gt)


def test_uncertainty_maps_are_the_reference_copies():
    assert uncertainty.REGION_CHANNELS == ref_uncertainty.REGION_CHANNELS
    assert (_fn_ast(uncertainty, "region_uncertainty_maps")
            == _fn_ast(ref_uncertainty, "region_uncertainty_maps"))
    probs = np.random.default_rng(4).dirichlet(np.ones(4), size=(9, 8, 7))
    probs = probs.astype(np.float32)
    probs[0, 0, 0] = (1.0, 0.0, 0.0, 0.0)
    probs[0, 0, 1] = (0.5, 0.5, 0.0, 0.0)
    got = uncertainty.region_uncertainty_maps(probs)
    want = ref_uncertainty.region_uncertainty_maps(probs)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == np.uint8 and got[k].tobytes() == want[k].tobytes()
    assert got["whole"][0, 0, 0] == 0 and got["whole"][0, 0, 1] == 100


def test_uncertainty_dir_is_the_reference_but_for_the_decoder_meta():
    """``predict_uncertainty_dir`` is the original statement for statement,
    the ``meta=case.meta`` that hands the native decoder's bbox on included
    (the port has the decoder too); only its docstring is its own."""
    got = ast.parse(inspect.getsource(uncertainty.predict_uncertainty_dir)).body[0]
    want = ast.parse(inspect.getsource(ref_uncertainty.predict_uncertainty_dir)).body[0]
    for node in (got, want):
        calls = [n for n in ast.walk(node) if isinstance(n, ast.Call)
                 and getattr(n.func, "attr", None) == "predict_probs_arrays"]
        assert len(calls) == 1 and [k.arg for k in calls[0].keywords] == ["meta"]
    for node in (got, want):
        node.body = node.body[1:]                      # the docstrings
    assert ast.dump(got) == ast.dump(want)


PREP_CACHE = ("_case_signature_hash", "_prep_cache_path")


@pytest.mark.parametrize("name", PREP_CACHE)
def test_prep_cache_keys_are_the_reference_copies(name):
    """The training prep cache's file naming, statement for statement, so
    one cache directory serves both packages (its reader and writer are
    held to the JAX package's by behaviour in
    tests/test_torch_train_extras.py: the image is a torch tensor here)."""
    from brats2019_tpu.data import pipeline as ref_pipeline
    from brats2019_tpu_torch.data import pipeline

    assert pipeline.PREP_CACHE_VERSION == ref_pipeline.PREP_CACHE_VERSION
    assert _fn_ast(pipeline, name) == _fn_ast(ref_pipeline, name)


def test_native_decoder_source_is_the_reference_copy():
    """``brats2019_tpu_torch/csrc/fastnifti.cpp`` is the root
    ``csrc/fastnifti.cpp`` line for line from its first ``#include`` on (only
    the leading comment, which says how the port builds it, is its own)."""
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    got = (root / "brats2019_tpu_torch/csrc/fastnifti.cpp").read_text()
    want = (root / "csrc/fastnifti.cpp").read_text()
    mark = "#include <cmath>"
    assert got.count(mark) == 1 and want.count(mark) == 1
    assert got[got.index(mark):] == want[want.index(mark):]
    # the build flags are the reference Makefile's
    from brats2019_tpu_torch.utils import nifti_fast

    make = (root / "csrc/Makefile").read_text()
    assert " ".join(nifti_fast.CXX_FLAGS) in make
    assert " ".join(nifti_fast.LD_FLAGS) in make


def test_native_decoder_binding_is_the_reference_copy():
    """The ctypes structure and ``load_volumes_fast`` are the reference's
    statement for statement (docstrings aside); the ABI version is its."""
    import ctypes

    from brats2019_tpu.utils import nifti_fast as ref_fast
    from brats2019_tpu_torch.utils import nifti_fast

    assert nifti_fast._FNInfo._fields_ == ref_fast._FNInfo._fields_
    assert (_fn_ast(nifti_fast, "load_volumes_fast", True)
            == _fn_ast(ref_fast, "load_volumes_fast", True))
    assert ctypes.sizeof(nifti_fast._FNInfo) == ctypes.sizeof(ref_fast._FNInfo)
    assert nifti_fast.ABI_VERSION == 2
    src = inspect.getsource(ref_fast._ensure_lib)
    assert "_ABI_VERSION = 2" in src


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16])
def test_int8_quantizer_is_the_reference_copy(dtype):
    """``quantize_int8_per_modality``: the reference's body, and its output
    bitwise on crops with background, an all-zero modality and negative
    intensities."""
    assert (_fn_ast(preprocess, "quantize_int8_per_modality", True)
            == _fn_ast(ref_preprocess, "quantize_int8_per_modality", True))
    rng = np.random.default_rng(11)
    img = (rng.normal(50.0, 30.0, size=(14, 12, 10, 4)) * 7).astype(dtype)
    img[:4] = 0
    img[..., 3] = 0
    got = preprocess.quantize_int8_per_modality(img)
    want = ref_preprocess.quantize_int8_per_modality(img)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert (got[:4] == 0).all() and (got[..., 3] == 0).all()
    assert np.abs(got).max() == 127
