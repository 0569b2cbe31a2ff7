"""PyTorch port: the training slice against the JAX package, in f32 on the
CPU at small sizes — loss terms, optimizer (schedule, clip, AdamW, EMA),
whole train steps through the weight bridge, sampling and augmentation on
the same draws, the data pipeline, bitwise resume, and the train/predict
CLIs. Tolerances are stated per test: 1e-5 abs + 1e-4 rel where the same
math runs in another summation order."""

import dataclasses
import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from brats2019_tpu.configs import presets as jax_presets
from brats2019_tpu.data import augment as jax_augment
from brats2019_tpu.data import pipeline as jax_pipeline
from brats2019_tpu.data import sampling as jax_sampling
from brats2019_tpu.data import synthetic as jax_synthetic
from brats2019_tpu.data.case import load_case as jax_load_case
from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.models.unet3d import UNetConfig as JaxUNetConfig
from brats2019_tpu.train import loss as jax_loss
from brats2019_tpu.train.checkpoint import export_params as jax_export_params
from brats2019_tpu.train.step import (
    get_ema_params,
    make_optimizer,
    make_segmentation_microbatch_loss,
)
from brats2019_tpu.utils import flops as jax_flops
from brats2019_tpu_torch.cli import common, predict as predict_cli, train as train_cli
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.data import augment, pipeline, sampling
from brats2019_tpu_torch.data.case import load_case
from brats2019_tpu_torch.models.blocks import Conv3x3
from brats2019_tpu_torch.models.unet3d import UNet3D
from brats2019_tpu_torch.train import loop, loss, step as port_step
from brats2019_tpu_torch.train.checkpoint import CheckpointManager, export_params
from brats2019_tpu_torch.utils import flops
from brats2019_tpu_torch.utils.weights import load_params_npz, state_dict_from_flat

TOL = dict(atol=1e-5, rtol=1e-4)


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


# ------------------------------------------------------------------- loss --

def _logits_labels(shape, k=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape + (k,)).astype(np.float32) * 2,
            rng.integers(0, k, size=shape).astype(np.int32))


@pytest.mark.parametrize("fn", ["soft_dice_loss", "cross_entropy_loss",
                                "region_soft_dice_loss"])
def test_loss_terms_match_reference(fn):
    logits, labels = _logits_labels((2, 6, 5, 4))
    want = getattr(jax_loss, fn)(jnp.asarray(logits), jnp.asarray(labels))
    got = getattr(loss, fn)(torch.from_numpy(logits), torch.from_numpy(labels))
    _close(got, want)


def test_segmentation_loss_with_region_and_aux_matches_reference():
    logits, labels = _logits_labels((1, 8, 8, 8), seed=1)
    aux = [_logits_labels((1, 4, 4, 4), seed=2)[0],
           _logits_labels((1, 2, 2, 2), seed=3)[0]]
    kw = dict(dice_weight=0.7, ce_weight=1.3, region_weight=0.5, aux_weight=0.4)
    want_l, want_aux = jax_loss.segmentation_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        aux_logits=tuple(jnp.asarray(a) for a in aux), **kw)
    got_l, got_aux = loss.segmentation_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        aux_logits=[torch.from_numpy(a) for a in aux], **kw)
    _close(got_l, want_l)
    assert sorted(got_aux) == sorted(want_aux)
    for k in want_aux:
        _close(got_aux[k], want_aux[k])


@pytest.mark.parametrize("r", [2, 3])
def test_lowres_loss_equals_fullres_and_reference(r):
    from brats2019_tpu_torch.models.unet3d import depth_to_space

    rng = np.random.default_rng(4)
    lr = rng.normal(size=(2, 3, 2, 4, 4 * r ** 3)).astype(np.float32)
    labels = rng.integers(0, 4, size=(2, 3 * r, 2 * r, 4 * r)).astype(np.int32)
    t_lr, t_lab = torch.from_numpy(lr), torch.from_numpy(labels)
    got, _ = loss.segmentation_loss_lowres(t_lr, t_lab, r, region_weight=0.5)
    full, _ = loss.segmentation_loss(depth_to_space(t_lr, r), t_lab,
                                     region_weight=0.5)
    want, _ = jax_loss.segmentation_loss_lowres(
        jnp.asarray(lr), jnp.asarray(labels), r, region_weight=0.5)
    _close(got, full.item())
    _close(got, want)
    np.testing.assert_array_equal(
        loss.blockify_labels(t_lab, r).numpy(),
        np.asarray(jax_loss.blockify_labels(jnp.asarray(labels), r)))


def test_region_dice_and_flops_match_reference():
    from brats2019_tpu.train.metrics import region_dice_np as jax_region_dice
    from brats2019_tpu_torch.train.metrics import region_dice_np

    rng = np.random.default_rng(5)
    for _ in range(3):
        a, b = (rng.integers(0, 4, size=(6, 7, 5)) for _ in range(2))
        assert region_dice_np(a, b) == jax_region_dice(a, b)
    empty = np.zeros((3, 3, 3), np.uint8)
    assert region_dice_np(empty, empty) == jax_region_dice(empty, empty)
    for name in ("cascade", "unit", "reference_parity"):
        exp, ref = presets.get_preset(name), jax_presets.get_preset(name)
        for cfg, rcfg in ((exp.unet, ref.unet), (exp.coarse_unet, ref.coarse_unet)):
            if cfg is not None:
                assert (flops.unet_forward_flops(cfg, (64, 48, 32))
                        == jax_flops.unet_forward_flops(rcfg, (64, 48, 32)))
        assert (flops.train_step_flops(exp.unet, exp.train)
                == jax_flops.train_step_flops(ref))
        if exp.coarse_unet is not None:
            ucfg, cfg, _ = loop.stage_config(exp, "coarse")
            assert flops.train_step_flops(ucfg, cfg) == (
                3.0 * jax_flops.unet_forward_flops(ref.coarse_unet, ref.train.coarse_patch)
                * ref.train.batch_per_device * max(ref.train.grad_accum_steps, 1))
    assert flops.peak_tflops_for("NVIDIA H100 80GB HBM3") == 989.0
    assert flops.peak_tflops_for("NVIDIA H100 PCIe") == 756.0
    assert flops.mfu(1e12, 1.0, "Some Unknown GPU") is None
    assert flops.mfu(989e12, 1.0, "NVIDIA H100 80GB HBM3") == pytest.approx(1.0)


# -------------------------------------------------------------- optimizer --

OPT_CFG = presets.TrainConfig(steps=8, warmup_steps=3, lr=1e-2, grad_clip=0.5,
                              weight_decay=1e-2, ema_decay=0.8, end_lr_frac=0.1)


def _jax_cfg(cfg):
    return jax_presets.TrainConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("cfg", [
    OPT_CFG,
    dataclasses.replace(OPT_CFG, warmup_steps=0, ema_decay=0.0, grad_clip=50.0),
])
def test_optimizer_matches_make_optimizer_every_step(cfg):
    """Schedule, clip, AdamW and EMA over a short run with warmup, clipping
    on at some steps and off at others."""
    rng = np.random.default_rng(6)
    init = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = make_optimizer(_jax_cfg(cfg))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = port_step.Optimizer(params, cfg)
    sched = optax.warmup_cosine_decay_schedule(
        cfg.lr / (cfg.warmup_steps + 1), cfg.lr, cfg.warmup_steps, cfg.steps,
        cfg.lr * cfg.end_lr_frac) if cfg.warmup_steps else optax.cosine_decay_schedule(
        cfg.lr, cfg.steps, alpha=cfg.end_lr_frac)
    for i in range(cfg.steps + 2):
        assert opt.lr(i) == pytest.approx(float(sched(i)), rel=1e-6)
        scale = 0.05 if i % 2 else 1.0            # some steps under the clip
        grads = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
                 for k, v in init.items()}
        upd, js = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        gnorm = opt.step({k: torch.from_numpy(v) for k, v in grads.items()})
        _close(gnorm, optax.global_norm(grads))
        for k in init:
            _close(params[k], jp[k], atol=1e-6, rtol=1e-5)
        ema = get_ema_params(js)
        if cfg.ema_decay:
            for k in init:
                _close(opt.ema[k], ema[k], atol=1e-6, rtol=1e-5)
        else:
            assert opt.ema is None and ema is None


# -------------------------------------------------------------- train step --

NET_KW = dict(levels=2, base_features=8, max_features=16,
              compute_dtype="float32", stem_downsample=2)
STEP_CFG = presets.TrainConfig(patch=(16, 16, 16), steps=6, warmup_steps=2,
                               lr=1e-3, grad_clip=0.05, ema_decay=0.7)


def _bridge(tmp_path):
    jm = JaxUNet3D(JaxUNetConfig(**NET_KW))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 4)))
    path = str(tmp_path / "params.npz")
    jax_export_params(path, params)
    model = UNet3D(presets.UNetConfig(**NET_KW))
    model.load_state_dict(state_dict_from_flat(load_params_npz(path)))
    return jm, params, model.train()


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp)[len("params/"):]
            .replace("/", "."): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("k", [1, 2])
def test_train_steps_match_jax(tmp_path, k):
    """3 steps with clipping active and EMA on: loss, grads, params and
    EMA to 1e-4 relative."""
    cfg = dataclasses.replace(STEP_CFG, grad_accum_steps=k)
    jm, jp, model = _bridge(tmp_path)
    jcfg = _jax_cfg(cfg)
    jloss = make_segmentation_microbatch_loss(
        lambda p, x: jm.apply(p, x), jcfg,
        lowres_apply=lambda p, x: jm.apply(p, x, subpixel=False), stem=2)
    vg = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    tx = make_optimizer(jcfg)
    js = tx.init(jp)
    opt = port_step.Optimizer(dict(model.named_parameters()), cfg)
    loss_fn = port_step.make_microbatch_loss(cfg, stem=2, lowres=True)
    rng = np.random.default_rng(7)
    for _ in range(3):
        micro = [(rng.normal(size=(1, 16, 16, 16, 4)).astype(np.float32),
                  rng.integers(0, 4, size=(1, 16, 16, 16)).astype(np.int32))
                 for _ in range(k)]
        outs = [vg(jp, jnp.asarray(x), jnp.asarray(y)) for x, y in micro]
        jgrads = jax.tree_util.tree_map(lambda *g: sum(g) / k,
                                        *[o[1] for o in outs])
        jl = np.mean([float(o[0][0]) for o in outs])
        aux = port_step.train_update(
            model, opt, loss_fn,
            [(torch.from_numpy(x), torch.from_numpy(y).long()) for x, y in micro])
        _close(aux["loss"], jl)
        _close(aux["grad_norm"], optax.global_norm(jgrads))
        want_g = _flat(jgrads)
        for name, p in model.named_parameters():
            _close(p.grad / k, want_g[name])
        upd, js = tx.update(jgrads, js, jp)
        jp = optax.apply_updates(jp, upd)
        want_p, want_e = _flat(jp), _flat(get_ema_params(js))
        for name, p in model.named_parameters():
            _close(p, want_p[name])
            _close(opt.ema[name], want_e[name])


def test_conv_kernel_takes_gradient_and_eval_sees_the_update():
    """The f32 master kernel gets its gradient through the compute-dtype
    cast, and eval after an optimizer step runs the new weights."""
    from brats2019_tpu_torch.utils.weights import init_params

    cfg = presets.UNetConfig(levels=2, base_features=4, max_features=8)
    model = UNet3D(cfg)
    model.load_state_dict(state_dict_from_flat(init_params(cfg, 1)))
    x = torch.randn(1, 8, 8, 8, 4)
    with torch.inference_mode():
        before = model.eval()(x)
    model.train()
    model(x).square().mean().backward()
    convs = [m for m in model.modules() if isinstance(m, Conv3x3)]
    assert all(m.kernel.grad is not None and m.kernel.grad.abs().sum() > 0
               for m in convs)
    assert all(m.kernel.grad.dtype == torch.float32 for m in convs)
    opt = port_step.Optimizer(dict(model.named_parameters()),
                              dataclasses.replace(STEP_CFG, grad_clip=1e9))
    opt.step({n: p.grad for n, p in model.named_parameters()})
    fresh = UNet3D(cfg)
    fresh.load_state_dict(model.state_dict())
    with torch.inference_mode():
        after = model.eval()(x)
        want = fresh.eval()(x)
    assert not torch.equal(after, before)
    assert torch.equal(after, want)
    for m in convs:
        assert torch.equal(m.kernel_c, m.kernel.detach().bfloat16())
    with torch.inference_mode():      # a model built inside inference mode
        built = UNet3D(cfg)
        built.load_state_dict(model.state_dict())
        assert torch.equal(built.eval()(x), want)


# ---------------------------------------------------- sampling and augment --

def _jax_patch_draw(key, vol_shape, patch, n_rows, fg_prob):
    """The draws of ``_random_origin`` (sampling.py:58-72), reproduced."""
    k_u, k_fg, k_pick, k_bias = jax.random.split(key, 4)
    maxs = jnp.array([max(v - p, 0) for v, p in zip(vol_shape, patch)], jnp.int32)
    uniform = jax.random.randint(k_u, (3,), jnp.zeros(3, jnp.int32), maxs + 1)
    row = jax.random.randint(k_pick, (), 0, n_rows)
    jitter = jax.random.randint(k_bias, (3,), -(jnp.array(patch) // 4),
                                jnp.array(patch) // 4 + 1)
    take = jax.random.bernoulli(k_fg, fg_prob)
    return sampling.PatchDraw(tuple(int(v) for v in uniform), bool(take),
                              int(row), tuple(int(v) for v in jitter))


@pytest.mark.parametrize("fg_prob", [0.0, 0.5, 1.0])
def test_sampling_matches_reference_on_the_same_draws(fg_prob):
    rng = np.random.default_rng(8)
    img = rng.normal(size=(20, 18, 14, 4)).astype(np.float32)
    seg = np.zeros((20, 18, 14), np.uint8)
    seg[3:9, 10:16, 2:7] = rng.integers(1, 4, size=(6, 6, 5))
    table = sampling.build_fg_table_np(seg, 64)
    np.testing.assert_array_equal(table, jax_sampling.build_fg_table_np(seg, 64))
    patch = (8, 12, 6)
    for s in range(6):
        key = jax.random.PRNGKey(s)
        want = jax_sampling.sample_patch_impl(
            key, jnp.asarray(img), jnp.asarray(seg), patch, jnp.asarray(table),
            fg_prob)
        draw = _jax_patch_draw(key, img.shape[:3], patch, table.shape[0], fg_prob)
        origin = sampling.patch_origin(draw, img.shape[:3], patch, table, fg_prob)
        got = sampling.slice_patch(torch.from_numpy(img), torch.from_numpy(seg),
                                   origin, patch)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="exceeds"):
        sampling.sample_patch_impl(torch.Generator(), torch.from_numpy(img),
                                   torch.from_numpy(seg), (24, 8, 8))


@pytest.mark.parametrize("rot90,gamma_range", [(False, 0.0), (True, 0.3)])
def test_augment_matches_reference_on_the_same_draws(rot90, gamma_range):
    rng = np.random.default_rng(9)
    img = rng.normal(size=(8, 8, 6, 4)).astype(np.float32)
    img[:2] = 0.0                                   # background stays zero
    seg = rng.integers(0, 4, size=(8, 8, 6)).astype(np.uint8)
    for s in range(8):
        key = jax.random.PRNGKey(100 + s)
        want = jax_augment.augment(key, jnp.asarray(img), jnp.asarray(seg),
                                   scale_range=0.1, shift_range=0.2,
                                   rot90=rot90, gamma_range=gamma_range)
        k_f, k_r, k_i, k_g = jax.random.split(key, 4)
        k_s, k_h = jax.random.split(k_i)
        hi = 1.0 + gamma_range
        draw = augment.AugmentDraw(
            flips=tuple(bool(b) for b in jax.random.bernoulli(k_f, 0.5, (3,))),
            rot_k=int(jax.random.randint(k_r, (), 0, 4)),
            scale=torch.from_numpy(np.array(1.0 + jax.random.uniform(
                k_s, (4,), minval=-0.1, maxval=0.1))),
            shift=torch.from_numpy(np.array(jax.random.uniform(
                k_h, (4,), minval=-0.2, maxval=0.2))),
            gamma=torch.from_numpy(np.array(jnp.exp(jax.random.uniform(
                k_g, (4,), minval=-jnp.log(hi), maxval=jnp.log(hi)))))
            if gamma_range > 0 else None,
        )
        got = augment.apply_augment(torch.from_numpy(img), torch.from_numpy(seg),
                                    draw, rot90=rot90)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert (got[0] == 0).sum() == (img == 0).sum()


def test_draws_are_a_function_of_seed_and_microbatch():
    a = port_step.step_generator(3, 11)
    b = port_step.step_generator(3, 11)
    c = port_step.step_generator(3, 12)
    da = sampling.draw_patch(a, (20, 20, 20), (8, 8, 8), 64, 0.5)
    assert da == sampling.draw_patch(b, (20, 20, 20), (8, 8, 8), 64, 0.5)
    assert da != sampling.draw_patch(c, (20, 20, 20), (8, 8, 8), 64, 0.5)
    aug = augment.draw_augment(a, 4, gamma_range=0.3)
    assert all(0.9 <= v <= 1.1 for v in aug.scale.tolist())
    assert all(1 / 1.3 - 1e-6 <= v <= 1.3 + 1e-6 for v in aug.gamma.tolist())


# --------------------------------------------------------------- pipeline --

@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("cases")
    return jax_synthetic.write_dataset(str(root), 3, shape=(40, 40, 32), seed0=5)


def test_cursor_matches_reference():
    for n, seed in ((7, 3), (1, 0), (4, 11)):
        a, b = pipeline.CaseCursor(n, seed=seed), jax_pipeline.CaseCursor(n, seed=seed)
        assert [a.next_index() for _ in range(25)] == [b.next_index() for _ in range(25)]
        assert a.state() == b.state()


@pytest.mark.parametrize("downsample,canvas", [(1, (32, 36, 24)), (2, (16, 16, 16))])
def test_prepare_training_case_matches_reference(cases, downsample, canvas):
    for d in cases:
        want = jax_pipeline.prepare_training_case(
            jax_load_case(d, backend="python"), canvas, downsample=downsample)
        got = pipeline.prepare_training_case(load_case(d, load_seg=True), canvas,
                                             downsample=downsample)
        assert got["image"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["image"].view(torch.int16).numpy(),
                                      np.asarray(want["image"]).view(np.int16))
        np.testing.assert_array_equal(got["seg"], want["seg"])
        np.testing.assert_array_equal(got["fg"], want["fg"])


def test_case_pool_refreshes_without_waiting(cases):
    pool = pipeline.CasePool(cases, "cpu", (32, 32, 24), cases=2, seed=1)
    assert pool.image.shape == (2, 32, 32, 24, 4) and pool.seg.dtype == torch.uint8

    def tables_follow_seg():
        for k in range(pool.k):
            np.testing.assert_array_equal(
                pool.fg_host[k], sampling.build_fg_table_np(pool.seg[k].numpy()))

    tables_follow_seg()
    assert not pool.maybe_refresh()               # no worker: nothing ready
    pool.start()
    try:
        for _ in range(200):
            if pool.maybe_refresh():
                break
            pool._stop.wait(0.05)
        else:
            pytest.fail("no case was refreshed")
    finally:
        pool.stop()
    tables_follow_seg()


# ------------------------------------------------------- loop and resume --

def _tiny_exp(workdir, **train):
    t = dict(patch=(16, 16, 16), pool_shape=(32, 32, 24), pool_cases_per_device=2,
             steps=4, warmup_steps=1, log_every=1, eval_every=0,
             checkpoint_every=2, pool_refresh_every=0, ema_decay=0.5,
             grad_clip=0.5)
    t.update(train)
    return presets.ExperimentConfig(
        name="tiny", unet=presets.UNetConfig(**NET_KW),
        train=presets.TrainConfig(**t), workdir=str(workdir))


def _preempt_after(monkeypatch, n_steps):
    """Deliver SIGTERM to the loop's handler after ``n_steps`` steps (no
    real signal is sent)."""
    handlers = {}

    def fake_signal(sig, handler):
        prev = handlers.get(sig, signal.SIG_DFL)
        handlers[sig] = handler
        return prev

    monkeypatch.setattr(loop.signal, "signal", fake_signal)
    real_call = port_step.TrainStep.__call__
    done = []

    def call(self, pool, i):
        aux = real_call(self, pool, i)
        done.append(i)
        if len(done) == n_steps:
            handlers[signal.SIGTERM](signal.SIGTERM, None)
        return aux

    monkeypatch.setattr(port_step.TrainStep, "__call__", call)


def _read_log(workdir):
    with open(os.path.join(workdir, "fine", "fine_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_resume_is_bitwise(tmp_path, cases, monkeypatch):
    straight = loop.train_stage(_tiny_exp(tmp_path / "a"), cases[:2], device="cpu")
    with monkeypatch.context() as m:
        _preempt_after(m, 2)
        first = loop.train_stage(_tiny_exp(tmp_path / "b"), cases[:2], device="cpu")
    assert first.preempted
    resumed = loop.train_stage(_tiny_exp(tmp_path / "b"), cases[:2], device="cpu")
    assert not resumed.preempted
    sa = torch.load(tmp_path / "a" / "fine" / "checkpoints" / "4" / "state.pt")
    sb = torch.load(tmp_path / "b" / "fine" / "checkpoints" / "4" / "state.pt")
    for k, v in sa["params"].items():
        assert torch.equal(v, sb["params"][k]), k
    for part in ("mu", "nu", "ema"):
        for k, v in sa["opt_state"][part].items():
            assert torch.equal(v, sb["opt_state"][part][k]), (part, k)
    assert sa["opt_state"]["count"] == sb["opt_state"]["count"] == 4
    la = {r["step"]: r["loss"] for r in _read_log(tmp_path / "a")}
    lb = {r["step"]: r["loss"] for r in _read_log(tmp_path / "b")}
    assert la == lb and sorted(la) == [1, 2, 3, 4]


def test_resume_migrates_the_ema_and_keeps_checkpoints(tmp_path, cases):
    exp = _tiny_exp(tmp_path, ema_decay=0.0, keep_checkpoints=1)
    loop.train_stage(exp, cases[:2], device="cpu")
    ckpt = CheckpointManager(os.path.join(exp.workdir, "fine"))
    assert ckpt.all_steps() == [4]
    exp6 = _tiny_exp(tmp_path, ema_decay=0.5, steps=6, keep_checkpoints=1)
    res = loop.train_stage(exp6, cases[:2], device="cpu")
    state = ckpt.restore()
    assert state["step"] == 6 and state["opt_state"]["ema"] is not None
    assert res.final_metrics["loss"] > 0


def test_load_stage_params_priority(tmp_path, cases):
    """Best beats the latest step; an export wins while it is at least as
    new as the newest checkpoint; a newer checkpoint beats a stale export."""
    exp = _tiny_exp(tmp_path, eval_every=2, steps=4)
    loop.train_stage(exp, cases[:2], val_dirs=cases[2:], device="cpu")
    wd = os.path.join(exp.workdir, "fine")
    ckpt = CheckpointManager(wd)
    with open(os.path.join(ckpt.best_dir, "metric.json")) as f:
        best_step = json.load(f)["step"]
    best = torch.load(os.path.join(ckpt.best_dir, "state.pt"))
    assert best["step"] == best_step
    got = common.load_stage_params(exp, "fine")
    for k, v in best["params"].items():
        np.testing.assert_array_equal(got[k], v.numpy())
    best_copy = os.path.join(str(tmp_path), "best_copy")
    shutil.move(ckpt.best_dir, best_copy)
    latest = common.load_stage_params(exp, "fine")
    for k, v in ckpt.restore()["params"].items():
        np.testing.assert_array_equal(latest[k], v.numpy())
    shutil.move(best_copy, ckpt.best_dir)
    model = UNet3D(exp.unet)
    model.load_state_dict(state_dict_from_flat(
        {k: np.zeros_like(v) for k, v in got.items()}))
    export_params(os.path.join(wd, "params.npz"), model)
    exported = common.load_stage_params(exp, "fine")
    assert sorted(exported) == sorted(got)
    assert all((v == 0).all() for v in exported.values())
    os.utime(os.path.join(wd, "params.npz"), (1, 1))
    assert not all((v == 0).all()
                   for v in common.load_stage_params(exp, "fine").values())
    with pytest.raises(FileNotFoundError, match="params.npz"):
        common.load_stage_params(dataclasses.replace(
            exp, workdir=str(tmp_path / "none")), "fine")


# -------------------------------------------------------------------- CLI --

def test_train_cli_unit_preset_then_serve(tmp_path, monkeypatch, capsys):
    data, work = str(tmp_path / "data"), str(tmp_path / "w")
    rc = train_cli.main(["--preset", "unit", "--synthetic", "3",
                         "--synthetic-shape", "40", "40", "32", "--data", data,
                         "--workdir", work, "--device", "cpu"])
    assert rc == 0
    log = _read_log(work)
    assert [r["step"] for r in log] == [1, 2, 3, 4]
    for r in log:
        assert np.isfinite(r["loss"]) and r["grad_norm"] > 0
        assert {"dice_loss", "ce_loss", "steps_per_sec", "patches_per_sec"} <= set(r)
    exp = dataclasses.replace(presets.get_preset("unit"), workdir=work)
    flat = common.load_stage_params(exp, "fine")
    assert sorted(flat) == sorted(
        "params/" + k.replace(".", "/") for k in UNet3D(exp.unet).state_dict())
    # the unit preset has no coarse stage, and the port's predict serves the
    # split cascade only: serve a tiny cascade trained by the same CLI
    tiny = presets.ExperimentConfig(
        name="tiny_cascade",
        unet=presets.UNetConfig(levels=2, base_features=8, max_features=16,
                                compute_dtype="float32", stem_downsample=2),
        coarse_unet=presets.UNetConfig(levels=2, base_features=8,
                                       compute_dtype="float32"),
        train=presets.TrainConfig(patch=(32, 32, 32), coarse_patch=(16, 16, 16),
                                  pool_shape=(48, 48, 32), pool_cases_per_device=1,
                                  steps=3, warmup_steps=0, log_every=1,
                                  eval_every=3, checkpoint_every=0),
        infer=presets.InferenceConfig(
            canvas=(48, 48, 32), tile=(32, 32, 32), roi_shape=(32, 32, 32),
            coarse_shape=(24, 24, 16), cascade=True, tta_flips=True,
            compute_dtype="float32"),
        workdir=str(tmp_path / "tiny"))
    monkeypatch.setitem(presets.PRESETS, "tiny_cascade", tiny)
    assert train_cli.main(["--preset", "tiny_cascade", "--data", data,
                           "--device", "cpu"]) == 0
    for stage in ("coarse", "fine"):
        assert os.path.exists(os.path.join(tiny.workdir, stage, "checkpoints",
                                           "best", "metric.json"))
    out = capsys.readouterr().out
    assert "stage coarse done" in out and "stage fine done" in out
    case = os.path.join(data, sorted(os.listdir(data))[0])
    assert predict_cli.main([case, "--preset", "tiny_cascade",
                             "--device", "cpu"]) == 0
    from brats2019_tpu_torch.utils.nifti import read_nifti

    name = os.path.basename(case)
    seg, _ = read_nifti(os.path.join(case, f"{name}_pred.nii.gz"),
                        apply_scaling=False)
    assert seg.shape == (40, 40, 32) and set(np.unique(seg)) <= {0, 1, 2, 4}


def test_train_cli_errors(tmp_path, capsys):
    assert train_cli.main(["--preset", "unit", "--device", "cpu"]) == 2
    assert train_cli.main(["--preset", "unit", "--device", "cpu",
                           "--data", str(tmp_path / "none")]) == 2
    assert train_cli.main(["--preset", "unit", "--ema-decay", "1.5",
                           "--data", str(tmp_path)]) == 2
    if not torch.cuda.is_available():
        assert train_cli.main(["--preset", "unit", "--device", "cuda",
                               "--data", str(tmp_path)]) == 2
        assert "cuda" in capsys.readouterr().err


def test_train_stage_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """The library entry point defaults to CUDA like the CLI: without a card
    that is an error, never a silent CPU run."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        loop.train_stage(_tiny_exp(tmp_path / "w"), [])
