"""PyTorch port: preprocessing, TTA and the split cascade (stage_roi +
stage_finish) against the JAX package, in f32 on the CPU, with the trained
accuracy fixtures as localizer and with a random stem-2 fine net."""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from brats2019_tpu.configs.presets import InferenceConfig as JaxInferenceConfig
from brats2019_tpu.data import preprocess as jpre
from brats2019_tpu.data.synthetic import make_case_arrays, make_hard_case_arrays
from brats2019_tpu.infer import tta as jtta
from brats2019_tpu.models import cascade as jcascade
from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.models.unet3d import UNetConfig as JaxUNetConfig
from brats2019_tpu.train.checkpoint import export_params
from brats2019_tpu_torch.configs.presets import InferenceConfig, UNetConfig
from brats2019_tpu_torch.data import preprocess as tpre
from brats2019_tpu_torch.infer import tta as ttta
from brats2019_tpu_torch.models import cascade as tcascade
from brats2019_tpu_torch.utils.weights import build_unet, load_params_npz

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "accuracy",
                       "hard_member0.npz")
FIXTURE_KW = dict(levels=2, base_features=8, compute_dtype="float32")


# -------------------------------------------------------------------- tta --

def test_flips_order_matches_reference():
    assert ttta.FLIPS == jtta.FLIPS and ttta.FLIPS[0] == (False, False, False)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_tta_stack_and_reduce_match_jax(precision):
    x = np.random.default_rng(0).normal(size=(6, 5, 4, 3)).astype(np.float32)
    got = ttta.tta_stack(torch.from_numpy(x), precision)
    want = np.asarray(jtta.tta_stack(jnp.asarray(x), precision))
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    p = np.random.default_rng(1).random((8, 6, 5, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ttta.tta_reduce(torch.from_numpy(p)).numpy(),
        np.asarray(jtta.tta_reduce(jnp.asarray(p))),
    )


# ---------------------------------------------------------- device preprocess --

def test_zscore_matches_jax():
    img, _ = make_case_arrays(seed=2, shape=(24, 20, 16))
    img = img.astype(np.float32)
    np.testing.assert_allclose(
        tpre.zscore(torch.from_numpy(img)).numpy(),
        np.asarray(jpre.zscore(jnp.asarray(img))), atol=1e-5, rtol=1e-5,
    )
    z = tpre.zscore(torch.zeros(4, 4, 4, 2))
    assert (z == 0).all()


@pytest.mark.parametrize("seed", range(4))
def test_mask_bbox_center_and_crop_start_match_jax(seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((12, 14, 10), bool)
    if seed:  # seed 0: the empty mask -> volume center
        lo = rng.integers(0, 6, 3)
        hi = lo + rng.integers(1, 5, 3)
        mask[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = rng.random(
            tuple(hi - lo)) > 0.3
        mask[lo[0], lo[1], lo[2]] = True
    c_t = tpre.mask_bbox_center(torch.from_numpy(mask))
    c_j = np.asarray(jpre.mask_bbox_center(jnp.asarray(mask)))
    np.testing.assert_array_equal(c_t.numpy(), c_j)
    assert c_t.dtype == torch.int32
    for roi in ((8, 8, 8), (12, 14, 10), (4, 16, 2)):
        full = (12, 14, 10)
        np.testing.assert_array_equal(
            tpre.centered_crop_start(c_t, roi, full).numpy(),
            np.asarray(jpre.centered_crop_start(jnp.asarray(c_j), roi, full)),
        )


# ------------------------------------------------------------ host helper copies --

def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("seed,shape", [(0, (40, 36, 28)), (1, (30, 50, 20))])
def test_host_helpers_match_originals(seed, shape):
    img, _ = make_case_arrays(seed=seed, shape=shape)
    img = img.astype(np.float32)
    # random-looking values so the bf16 cast exercises rounding
    img = img * np.float32(1.0 + 1e-3 * np.pi)
    bb_t, bb_j = tpre.brain_bbox_fast_np(img), jpre.brain_bbox_fast_np(img)
    assert (bb_t.lo, bb_t.hi, bb_t.full_shape) == (bb_j.lo, bb_j.hi, bb_j.full_shape)
    assert tpre.brain_bbox_np(img, margin=2) == tpre.BBox(
        *(lambda b: (b.lo, b.hi, b.full_shape))(jpre.brain_bbox_np(img, margin=2)))
    for canvas in ((32, 32, 32), (48, 24, 40)):
        fit_t = tpre.crop_cast_fit_np(img, bb_t, canvas)
        fit_j = jpre.crop_cast_fit_np(img, bb_j, canvas)
        assert fit_t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(fit_t), fit_j.view(np.int16))
        for bucket in (16, 8):
            small_t, dst_t = tpre.crop_cast_bucket_np(img, bb_t, canvas, bucket)
            small_j, dst_j = jpre.crop_cast_bucket_np(img, bb_j, canvas, bucket)
            assert dst_t == dst_j
            np.testing.assert_array_equal(_bits(small_t), small_j.view(np.int16))
        labels = np.random.default_rng(seed).integers(0, 4, canvas).astype(np.uint8)
        np.testing.assert_array_equal(
            tpre.uncrop_from_canvas_np(labels, bb_t.shape, bb_t, canvas),
            jpre.uncrop_from_canvas_np(labels, bb_j.shape, bb_j, canvas),
        )


def test_center_fit_and_bf16_cast_match_originals():
    for s in range(1, 40, 3):
        for t in (8, 17, 32):
            assert tpre.center_fit_axis(s, t) == jpre.center_fit_axis(s, t)
    v = np.random.default_rng(5).normal(size=4096).astype(np.float32) * 1e3
    v[:4] = [0.0, -0.0, 1.00390625, 1.01171875]   # exact bf16 ties
    np.testing.assert_array_equal(
        _bits(torch.from_numpy(v).to(torch.bfloat16)),
        v.astype(ml_dtypes.bfloat16).view(np.int16),
    )


# --------------------------------------------------------------- the cascade --

CANVAS = (64, 64, 48)


def _infer_cfg(cls, tile):
    return cls(
        canvas=CANVAS, tile=tile, roi_shape=tile, coarse_shape=(32, 32, 24),
        cascade=True, tta_flips=True, tta_precision="float32",
        min_component_voxels=0, et_min_voxels=0, compute_dtype="float32",
    )


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(jax fine cfg, jax params, torch model) for the trained fixture and a
    random stem-2 fine net; the fixture also serves as the localizer."""
    from brats2019_tpu.train.checkpoint import import_params

    d = tmp_path_factory.mktemp("nets")
    like = JaxUNet3D(JaxUNetConfig(**FIXTURE_KW)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 4)))
    fixture = (JaxUNetConfig(**FIXTURE_KW), import_params(FIXTURE, like),
               build_unet(UNetConfig(**FIXTURE_KW), load_params_npz(FIXTURE)))
    kw2 = dict(levels=2, base_features=8, compute_dtype="float32",
               stem_downsample=2)
    p2 = JaxUNet3D(JaxUNetConfig(**kw2)).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 16, 4)))
    export_params(str(d / "s2.npz"), p2)
    stem2 = (JaxUNetConfig(**kw2), p2,
             build_unet(UNetConfig(**kw2), str(d / "s2.npz")))
    return {"fixture": fixture, "stem2": stem2}


def _image(seed):
    return make_hard_case_arrays(seed=seed, shape=CANVAS)[0].astype(np.float32)


def test_coarse_locate_matches_jax(nets):
    jcfg, jp, tm = nets["fixture"]
    jm = JaxUNet3D(jcfg)
    roi = (32, 32, 32)
    for seed in (10, 11):
        img = _image(seed)
        z = jpre.zscore(jnp.asarray(img))
        region_j, start_j = jcascade.coarse_locate(
            lambda p, x: jm.apply(p, x), jp, z,
            _infer_cfg(JaxInferenceConfig, roi), CANVAS, roi,
        )
        with torch.no_grad():
            region_t, start_t = tcascade.coarse_locate(
                tm, tpre.zscore(torch.from_numpy(img)),
                _infer_cfg(InferenceConfig, roi), CANVAS, roi,
            )
        np.testing.assert_array_equal(start_t.numpy(), np.asarray(start_j))
        np.testing.assert_allclose(region_t.numpy(), np.asarray(region_j),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fine", ["fixture", "stem2"])
def test_split_cascade_matches_make_predict_fn(nets, fine):
    """ROI start equal; labels equal except on numerical ties of the JAX
    mean probabilities (top-2 gap < 1e-5)."""
    jcfg, jp, tm = nets[fine]
    ccfg, cp, cm = nets["fixture"]
    jfine, jcoarse = JaxUNet3D(jcfg), JaxUNet3D(ccfg)
    tile = (32, 32, 32)
    fn = jcascade.make_predict_fn(
        lambda p, x: jfine.apply(p, x), _infer_cfg(JaxInferenceConfig, tile),
        CANVAS, coarse_apply=lambda p, x: jcoarse.apply(p, x),
        fine_lowres_apply=lambda p, x: jfine.apply(p, x, subpixel=False),
        stem=jcfg.stem_downsample,
    )
    assert hasattr(fn, "stages")  # the split path
    split = tcascade.make_predict_fn(tm, _infer_cfg(InferenceConfig, tile),
                                     CANVAS, coarse=cm)
    for seed in (10, 13):
        img = _image(seed)
        labels_j, start_j = fn(jp, cp, jnp.asarray(img))
        probs_j, _ = fn.probs_fn(jp, cp, jnp.asarray(img))
        with torch.no_grad():
            tiles, start_t = split.stage_roi(torch.from_numpy(img))
            assert tiles.shape == (8,) + tile + (4,)
            labels_t, _ = split.stage_finish(tiles, start_t)
        np.testing.assert_array_equal(start_t.numpy(), np.asarray(start_j))
        assert labels_t.dtype == torch.uint8 and labels_t.shape == tile
        diff = labels_t.numpy() != np.asarray(labels_j)
        top2 = np.sort(np.asarray(probs_j), axis=-1)[..., -2:]
        tie = (top2[..., 1] - top2[..., 0]) < 1e-5
        assert not (diff & ~tie).any(), int((diff & ~tie).sum())
        assert diff.mean() < 1e-3


@pytest.mark.parametrize("min_voxels,et_min", [(16, 32), (300, 100000)])
def test_split_cascade_device_postproc_matches_make_predict_fn(nets, min_voxels,
                                                               et_min):
    """postproc="device": ROI start equal and labels equal to the JAX
    program's labels after its in-graph postprocessing step, except where a numerical tie of the
    mean probabilities flipped a voxel before the filter (none on these
    inputs: the raw labels are checked equal first). The second case's
    thresholds remove components and relabel all ET."""
    import dataclasses

    jcfg, jp, tm = nets["stem2"]
    ccfg, cp, cm = nets["fixture"]
    jfine, jcoarse = JaxUNet3D(jcfg), JaxUNet3D(ccfg)
    tile = (32, 32, 32)
    kw = dict(postproc="device", min_component_voxels=min_voxels,
              et_min_voxels=et_min)

    def jax_fn(cfg):
        return jcascade.make_predict_fn(
            lambda p, x: jfine.apply(p, x), cfg, CANVAS,
            coarse_apply=lambda p, x: jcoarse.apply(p, x),
            fine_lowres_apply=lambda p, x: jfine.apply(p, x, subpixel=False),
            stem=jcfg.stem_downsample,
        )

    jcfg_host = _infer_cfg(JaxInferenceConfig, tile)
    tcfg_host = _infer_cfg(InferenceConfig, tile)
    fn_raw = jax_fn(jcfg_host)
    raw = tcascade.make_predict_fn(tm, tcfg_host, CANVAS, coarse=cm)
    dev = tcascade.make_predict_fn(tm, dataclasses.replace(tcfg_host, **kw),
                                   CANVAS, coarse=cm)
    changed = 0
    for seed in (10, 13):
        img = _image(seed)
        raw_j, start_j = fn_raw(jp, cp, jnp.asarray(img))
        # what the JAX program's _finish_one applies in-graph (:247-251)
        want = jcascade._postprocess_device(raw_j, min_voxels, et_min)
        with torch.no_grad():
            raw_t, _ = raw(torch.from_numpy(img))
            got, start_t = dev(torch.from_numpy(img))
        np.testing.assert_array_equal(raw_t.numpy(), np.asarray(raw_j))
        np.testing.assert_array_equal(start_t.numpy(), np.asarray(start_j))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        changed += int((got.numpy() != raw_t.numpy()).sum())
    if et_min > 32:             # these thresholds must change something
        assert changed > 0


def test_lowres_reduce_equals_fullres_reduce():
    """d2s is a permutation: the low-res reduce equals softmax -> unflip ->
    mean -> argmax at full resolution, exactly."""
    from brats2019_tpu_torch.models.unet3d import depth_to_space

    r, k = 2, 4
    logits = torch.from_numpy(np.random.default_rng(7).normal(
        size=(8, 3, 4, 2, k * r ** 3)).astype(np.float32))
    probs_lr = tcascade.lowres_mean_probs(logits, r, k, torch.float32)
    lab_lr = tcascade.labels_from_blocks(torch.argmax(probs_lr, -1), r)
    full = torch.softmax(depth_to_space(logits, r), -1)
    lab_full = torch.argmax(ttta.tta_reduce(full), -1)
    np.testing.assert_array_equal(lab_lr.numpy(), lab_full.numpy())


@pytest.mark.parametrize("fine,postproc", [("fixture", "host"),
                                          ("stem2", "host"),
                                          ("stem2", "device")])
def test_stage_finish_pair_is_two_stage_finishes(nets, fine, postproc):
    """Two volumes' flip stacks through one batch-16 fine forward, each half
    reduced (the full-resolution reduce with stem 1, the low-res one with
    stem 2; device postprocessing when configured): the labels of two
    ``stage_finish`` calls and of JAX's ``fine_pair`` on the same stacks,
    except on ties of the mean probabilities (top-2 gap < 1e-5); the starts
    pass through."""
    import dataclasses

    jcfg, jp, tm = nets[fine]
    ccfg, cp, cm = nets["fixture"]
    jfine, jcoarse = JaxUNet3D(jcfg), JaxUNet3D(ccfg)
    tile = (32, 32, 32)
    kw = dict(postproc=postproc, min_component_voxels=16, et_min_voxels=32)
    fn = jcascade.make_predict_fn(
        lambda p, x: jfine.apply(p, x),
        dataclasses.replace(_infer_cfg(JaxInferenceConfig, tile), **kw),
        CANVAS, coarse_apply=lambda p, x: jcoarse.apply(p, x),
        fine_lowres_apply=lambda p, x: jfine.apply(p, x, subpixel=False),
        stem=jcfg.stem_downsample,
    )
    split = tcascade.make_predict_fn(
        tm, dataclasses.replace(_infer_cfg(InferenceConfig, tile), **kw),
        CANVAS, coarse=cm)
    with torch.no_grad():
        (ta, sa), (tb, sb) = (split.stage_roi(torch.from_numpy(_image(s)))
                              for s in (10, 13))
        la, sa2, lb, sb2 = split.stage_finish_pair(ta, tb, sa, sb)
        singles = [split.stage_finish(t, st)[0] for t, st in ((ta, sa), (tb, sb))]
        probs = [split.stage_finish_probs(t, st)[0] for t, st in ((ta, sa), (tb, sb))]
    assert sa2 is sa and sb2 is sb
    ja, _, jb, _ = fn.fine_pair(jp, *(jnp.asarray(t.numpy()) for t in (ta, tb, sa, sb)))
    for got, single, want, pr in zip((la, lb), singles, (ja, jb), probs):
        assert got.dtype == torch.uint8 and got.shape == tile
        top2 = torch.sort(pr, -1).values[..., -2:].numpy()
        tie = (top2[..., 1] - top2[..., 0]) < 1e-5
        for other in (single.numpy(), np.asarray(want)):
            diff = got.numpy() != other
            assert not (diff & ~tie).any(), int((diff & ~tie).sum())
            assert diff.mean() < 1e-3


def test_every_configuration_gets_a_program():
    """No configuration of make_predict_fn raises any more (F2): the paths
    that raised before get the reference's staged sweep or monolithic
    program, and the flagship keeps the split program."""
    from brats2019_tpu_torch.models.unet3d import UNet3D

    m = UNet3D(UNetConfig(**FIXTURE_KW))
    cfg = _infer_cfg(InferenceConfig, (32, 32, 32))
    import dataclasses

    for bad, program in ((dict(tta_flips=False), tcascade.Monolithic),
                         (dict(cascade=False), tcascade.Monolithic),
                         (dict(roi_shape=(48, 48, 48)), tcascade.Monolithic)):
        assert isinstance(tcascade.make_predict_fn(
            m, dataclasses.replace(cfg, **bad), CANVAS, coarse=m), program)
    # device postprocessing: the same split program
    assert isinstance(
        tcascade.make_predict_fn(m, dataclasses.replace(cfg, postproc="device"),
                                 CANVAS, coarse=m), tcascade.SplitCascade)
    assert isinstance(tcascade.make_predict_fn(m, cfg, CANVAS, coarse=None),
                      tcascade.Monolithic)
