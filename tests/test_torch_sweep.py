"""PyTorch port: the sliding window, the monolithic program and the staged
multi-tile sweep (``models/cascade.py``) against the JAX package, in f32 on
the CPU; and ``Predictor`` on presets without a cascade (``unit``, and
``reference_parity``'s network at a reduced tile and canvas)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.configs import presets as jax_presets
from brats2019_tpu.data.synthetic import make_case_arrays
from brats2019_tpu.infer import tiling as jtiling
from brats2019_tpu.infer import tta as jtta
from brats2019_tpu.infer.predictor import Predictor as JaxPredictor
from brats2019_tpu.models import cascade as jcascade
from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.train.checkpoint import export_params
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.infer import tiling as ttiling
from brats2019_tpu_torch.infer import tta as ttta
from brats2019_tpu_torch.infer.predictor import Predictor
from brats2019_tpu_torch.models import cascade as tcascade
from brats2019_tpu_torch.utils.weights import build_unet

FINE_KW = dict(levels=2, base_features=4, compute_dtype="float32",
               stem_downsample=2)
COARSE_KW = dict(levels=2, base_features=4, compute_dtype="float32")
TIE = 1e-5   # top-2 gap of the JAX mean probabilities below which a label may flip


def _net(tmp, name, kw, seed):
    """(JAX model, JAX params, the port's model with the same weights)."""
    jm = JaxUNet3D(jax_presets.UNetConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 16, 4)))
    path = str(tmp / f"{name}.npz")
    export_params(path, jp)
    return jm, jp, build_unet(presets.UNetConfig(**kw), path)


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep_nets")
    return {"fine": _net(d, "fine", FINE_KW, 0),
            "coarse": _net(d, "coarse", COARSE_KW, 1)}


def _labels_agree_except_ties(got, want, probs_want):
    diff = np.asarray(got) != np.asarray(want)
    top2 = np.sort(np.asarray(probs_want), axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < TIE
    assert not (diff & ~tie).any(), int((diff & ~tie).sum())


@pytest.mark.parametrize("tta", [False, True])
def test_sliding_window_probs_matches_jax(nets, tta):
    jm, jp, tm = nets["fine"]
    vol = np.random.default_rng(3).normal(size=(24, 20, 16, 4)).astype(np.float32)
    tile = (16, 16, 16)
    origins = ttiling.tile_origins(vol.shape[:3], tile, 0.5)
    assert len(origins) == 4
    w = ttiling.blend_weight(tile)
    want = jtiling.sliding_window_probs(
        lambda p: jtta.tta_probs(lambda q, x: jm.apply(q, x), jp, p,
                                 enabled=tta),
        jnp.asarray(vol), origins, tile, jnp.asarray(w), 4)
    with torch.no_grad():
        got = ttiling.sliding_window_probs(
            lambda p: ttta.tta_probs(tm, p, enabled=tta),
            torch.from_numpy(vol), origins, tile, torch.from_numpy(w), 4)
    assert got.dtype == torch.float32 and got.shape == (24, 20, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# the two cases of tests/test_inference.py::test_staged_multitile_sweep_matches_monolithic
SWEEP_CASES = {
    # no cascade: a 2-tile whole-canvas sweep along X, origins [0, 8]
    "whole_canvas": dict(canvas=(24, 16, 16), seed=13, cfg=dict(cascade=False)),
    # cascade with an ROI larger than one tile
    "roi_larger_than_tile": dict(
        canvas=(32, 32, 32), seed=14,
        cfg=dict(cascade=True, coarse_shape=(16, 16, 16), roi_shape=(24, 16, 16))),
}


def _sweep_cfg(mod, case):
    return mod.InferenceConfig(
        canvas=None, tile=(16, 16, 16), tta_flips=True,
        min_component_voxels=0, et_min_voxels=0, compute_dtype="float32",
        tta_precision="float32", **case["cfg"])


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_staged_sweep_matches_monolithic_and_jax(nets, case):
    """The staged sweep's labels agree with the monolithic program's at >
    0.999 (the reference's own bar), each program's labels equal the JAX
    program of the same kind except on ties, and each program's mean
    probabilities are within 1e-4 of JAX's."""
    c = SWEEP_CASES[case]
    canvas = c["canvas"]
    jf, jpf, tf = nets["fine"]
    jc, jpc, tc = nets["coarse"]
    cascade = c["cfg"]["cascade"]
    jcfg, tcfg = _sweep_cfg(jax_presets, c), _sweep_cfg(presets, c)
    jkw = dict(coarse_apply=(lambda p, x: jc.apply(p, x)) if cascade else None)
    j_staged = jcascade.make_predict_fn(
        lambda p, x: jf.apply(p, x), jcfg, canvas,
        fine_lowres_apply=lambda p, x: jf.apply(p, x, subpixel=False), stem=2,
        **jkw)
    j_mono = jcascade.make_predict_fn(lambda p, x: jf.apply(p, x), jcfg, canvas,
                                      allow_split=False, **jkw)
    assert len(j_staged.stages) == 2
    t_coarse = tc if cascade else None
    staged = tcascade.make_predict_fn(tf, tcfg, canvas, coarse=t_coarse)
    mono = tcascade.make_predict_fn(tf, tcfg, canvas, coarse=t_coarse,
                                    allow_split=False)
    assert isinstance(staged, tcascade.StagedSweep)
    assert isinstance(mono, tcascade.Monolithic)
    image = make_case_arrays(seed=c["seed"], shape=canvas)[0].astype(np.float32)
    pc = jpc if cascade else None
    lj_s, sj_s = j_staged(jpf, pc, jnp.asarray(image))
    lj_m, sj_m = j_mono(jpf, pc, jnp.asarray(image))
    pj_s, _ = j_staged.probs_fn(jpf, pc, jnp.asarray(image))
    pj_m, _ = j_mono.probs_fn(jpf, pc, jnp.asarray(image))
    with torch.no_grad():
        x = torch.from_numpy(image)
        lt_s, st_s = staged(x)
        lt_m, st_m = mono(x)
        pt_m, _ = mono.probs(x)
        stacks, _ = staged.stage_sweep_stack(x)
        blk = staged.sweep_probs_lr(stacks)
    assert stacks.shape == (len(staged.origins), 8, 16, 16, 16, 4)
    d, h, w = blk.shape[:3]
    pt_s = blk.permute(0, 3, 1, 4, 2, 5, 6).reshape(2 * d, 2 * h, 2 * w, 4)
    for got in (st_s, st_m):
        np.testing.assert_array_equal(got.numpy(), np.asarray(sj_m))
    np.testing.assert_array_equal(np.asarray(sj_s), np.asarray(sj_m))
    assert lt_s.dtype == lt_m.dtype == torch.uint8
    assert lt_s.shape == lt_m.shape == np.asarray(lj_m).shape
    assert (lt_s.numpy() == lt_m.numpy()).mean() > 0.999
    np.testing.assert_allclose(pt_m.numpy(), np.asarray(pj_m), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pt_s.numpy(), np.asarray(pj_s), rtol=1e-4, atol=1e-4)
    _labels_agree_except_ties(lt_m.numpy(), lj_m, pj_m)
    _labels_agree_except_ties(lt_s.numpy(), lj_s, pj_s)


def _case_image(seed, shape):
    return make_case_arrays(seed=seed, shape=shape)[0]


def _predictors(tmp_path, name, exp_j, exp_t):
    jm = JaxUNet3D(exp_j.unet)
    jp = jm.init(jax.random.PRNGKey(4), jnp.zeros((1, 16, 16, 16, 4)))
    path = str(tmp_path / f"{name}.npz")
    export_params(path, jp)
    return JaxPredictor(exp_j, jp), Predictor(exp_t, path, device="cpu")


def _f32(mod, name, **infer):
    exp = mod.get_preset(name)
    return dataclasses.replace(
        exp, unet=dataclasses.replace(exp.unet, compute_dtype="float32"),
        infer=dataclasses.replace(exp.infer, tta_precision="float32",
                                  compute_dtype="float32", **infer))


@pytest.mark.parametrize("name,infer,shape", [
    ("unit", {}, (40, 36, 30)),
    # reference_parity's widths and depth (5 levels, base 24, max 256), 32^3
    # tiles with 8-flip TTA over a reduced canvas: 4 origins
    ("reference_parity", dict(canvas=(48, 48, 32), tile=(32, 32, 32)),
     (56, 52, 40)),
])
def test_predictor_without_cascade_matches_jax(tmp_path, name, infer, shape):
    exp_j, exp_t = _f32(jax_presets, name, **infer), _f32(presets, name, **infer)
    ref, port = _predictors(tmp_path, name, exp_j, exp_t)
    assert isinstance(port.program, tcascade.Monolithic)
    assert port.coarse is None
    image = _case_image(21, shape)
    want, _ = ref.predict_arrays(image)
    got, _ = port.predict_arrays(image)
    assert got.shape == shape and got.dtype == np.uint8
    assert (got != want).mean() < 1e-4, int((got != want).sum())


def test_make_predict_fn_chooses_by_the_reference_predicates(nets):
    """Every preset gets a program; the flagship keeps SplitCascade."""
    jf, jpf, tf = nets["fine"]
    jc, jpc, tc = nets["coarse"]
    flat = tc                                               # a stem-1 net
    base = presets.InferenceConfig(canvas=None, tile=(16, 16, 16),
                                   roi_shape=(16, 16, 16),
                                   coarse_shape=(16, 16, 16))
    canvas = (32, 32, 32)
    pick = lambda fine, coarse=None, **kw: type(tcascade.make_predict_fn(
        fine, dataclasses.replace(base, **kw), canvas, coarse=coarse)).__name__
    assert pick(tf, tc) == "SplitCascade"
    assert pick(flat, tc) == "SplitCascade"                 # stem 1
    assert pick(tf, tc, tta_flips=False) == "Monolithic"
    assert pick(tf, None) == "StagedSweep"                  # no coarse net
    assert pick(tf, tc, cascade=False) == "StagedSweep"
    assert pick(tf, tc, roi_shape=(24, 16, 16)) == "StagedSweep"
    assert pick(flat, None) == "Monolithic"                 # stem 1, 27 tiles
    assert pick(tf, None, tile=(15, 16, 16)) == "Monolithic"  # odd tile
    assert pick(tf, None, tta_flips=False) == "Monolithic"

