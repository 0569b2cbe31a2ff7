"""PyTorch port: the training left-outs against the JAX package, in f32 on
the CPU at small sizes — deep supervision (aux heads, their logits and the
loss with them, within 1e-5 abs + 1e-4 rel), remat (``remat_levels``: equal
losses and gradients within 1e-6, the same keys, saved tensors rebuilt
rather than held), warm start (``--init-from`` from ``.npz``,
``.safetensors`` and ``.pt`` give JAX's params bitwise; a resumable
checkpoint wins; the EMA starts from the loaded weights), the training prep
cache (JAX's file names; an entry of either package is the other's hit,
byte-equal; a corrupt entry is rebuilt), the ``--debug-checks`` sampler
bounds, ``--debug-nans``, ``--profile`` on train and predict, the new train
CLI flags, and ``cli.info``."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.cli.common import _stage_param_template
from brats2019_tpu.configs import presets as jax_presets
from brats2019_tpu.data import pipeline as jax_pipeline
from brats2019_tpu.data import sampling as jax_sampling
from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.models.unet3d import UNetConfig as JaxUNetConfig
from brats2019_tpu.train.checkpoint import export_params as jax_export_params
from brats2019_tpu.train.loop import _load_init_params as jax_load_init_params
from brats2019_tpu.train.step import make_segmentation_microbatch_loss
from brats2019_tpu_torch.cli import train as train_cli
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.data import pipeline, sampling, synthetic
from brats2019_tpu_torch.models.blocks import DoubleConv
from brats2019_tpu_torch.models.unet3d import UNet3D
from brats2019_tpu_torch.train import loop, step as port_step
from brats2019_tpu_torch.utils import weights
from test_golden_parity import TorchMirror

TOL = dict(atol=1e-5, rtol=1e-4)
DS_KW = {
    "plain": dict(levels=3, base_features=4, max_features=16,
                  compute_dtype="float32", deep_supervision=True),
    "s2d": dict(levels=3, base_features=8, max_features=16, compute_dtype="float32",
                deep_supervision=True, stem_downsample=2),
}


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


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


# -------------------------------------------------------- deep supervision --

@pytest.fixture(scope="module", params=sorted(DS_KW))
def ds_pair(request, tmp_path_factory):
    """A JAX deep-supervision net (params with aux_head_*) and the port's
    net loaded from its export through the bridge (strict)."""
    kw = DS_KW[request.param]
    jm = JaxUNet3D(JaxUNetConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 16, 4)),
                 deep_outputs=True)
    path = str(tmp_path_factory.mktemp("ds") / "params.npz")
    jax_export_params(path, jp)
    model = UNet3D(presets.UNetConfig(**kw))
    model.load_state_dict(weights.state_dict_from_flat(weights.load_params_npz(path)))
    return kw, jm, jp, model


def test_aux_heads_load_through_the_bridge(ds_pair):
    kw, _, jp, model = ds_pair
    want = _flat(jp)
    got = weights.flat_from_state_dict(model.state_dict())
    assert sorted(got) == sorted(want)
    assert [k for k in got if "aux_head" in k] == [
        "params/aux_head_1/kernel", "params/aux_head_1/bias"]
    assert sorted(weights.init_params(presets.UNetConfig(**kw), 0)) == sorted(want)
    plain = presets.UNetConfig(**dict(kw, deep_supervision=False))
    assert not any("aux_head" in k for k in weights.param_template(plain))


def test_aux_logits_match_reference(ds_pair):
    kw, jm, jp, model = ds_pair
    x = np.random.default_rng(1).normal(size=(1, 16, 16, 16, 4)).astype(np.float32)
    want_l, want_aux = jm.apply(jp, jnp.asarray(x), deep_outputs=True)
    with torch.no_grad():
        got_l, got_aux = model(torch.from_numpy(x), deep_outputs=True)
        plain = model(torch.from_numpy(x))
    assert len(got_aux) == len(want_aux) == 1
    _close(got_l, want_l)
    for g, w in zip(got_aux, want_aux):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        _close(g, w)
    assert torch.equal(plain, got_l)        # inference: plain logits


def test_deep_supervision_loss_and_grads_match_reference(ds_pair):
    """The full-resolution loss with the aux term (a sub-pixel net too: the
    aux labels need full resolution), and every gradient, aux heads included."""
    kw, jm, jp, model = ds_pair
    cfg = presets.TrainConfig(patch=(16, 16, 16), region_weight=0.3,
                              deep_supervision_weight=0.4)
    jcfg = jax_presets.TrainConfig(**dataclasses.asdict(cfg))
    jloss = make_segmentation_microbatch_loss(
        lambda p, v: jm.apply(p, v, deep_outputs=True), jcfg, lowres_apply=None,
        stem=kw.get("stem_downsample", 1))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 16, 16, 16, 4)).astype(np.float32)
    y = rng.integers(0, 4, size=(1, 16, 16, 16)).astype(np.int32)
    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(
        jp, jnp.asarray(x), jnp.asarray(y))
    loss_fn = port_step.make_microbatch_loss(
        cfg, kw.get("stem_downsample", 1), lowres=True, deep_supervision=True)
    model.train().zero_grad(set_to_none=True)
    loss, aux = loss_fn(model, torch.from_numpy(x), torch.from_numpy(y).long())
    loss.backward()
    _close(loss, jl)
    for k in ("dice_loss", "ce_loss", "region_dice_loss"):
        _close(aux[k], jaux[k])
    want = _flat(jg)
    for name, p in model.named_parameters():
        _close(p.grad, want["params/" + name.replace(".", "/")])
    assert model.aux_head_1.kernel.grad.abs().sum() > 0


def test_init_stage_builds_the_aux_heads():
    cfg = presets.UNetConfig(**DS_KW["plain"])
    model, opt = loop.init_stage(cfg, presets.TrainConfig(), torch.device("cpu"))
    assert "aux_head_1.kernel" in opt.params and model.training


# -------------------------------------------------------------------- remat --

def _remat_run(remat: int):
    """One loss and backward of a 3-level net: (model, loss, grads, numel
    saved for the backward outside any checkpoint, numel saved inside each
    block's forward, block calls in the forward, block calls in all)."""
    cfg = presets.UNetConfig(levels=3, base_features=4, max_features=16,
                             compute_dtype="float32", remat_levels=remat)
    model = UNet3D(cfg)
    model.load_state_dict(weights.state_dict_from_flat(weights.init_params(cfg, 4)))
    calls, saved, per_block, inputs = [], [], {}, {}

    def pre(name):
        def hook(mod, args):
            calls.append(name)
            per_block.setdefault(name, -sum(saved))
            inputs.setdefault(name, args[0].numel())
        return hook

    def post(name):
        def hook(mod, args, out):
            if len(calls) <= 5:        # the forward, not a recompute
                per_block[name] += sum(saved)
        return hook

    for name, m in model.named_children():
        if isinstance(m, DoubleConv):
            # a pre-hook: a recompute stops early, before forward hooks run
            m.register_forward_pre_hook(pre(name))
            m.register_forward_hook(post(name))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(1, 16, 16, 16, 4)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, size=(1, 16, 16, 16))).long()
    loss_fn = port_step.make_microbatch_loss(presets.TrainConfig())
    pack = lambda t: (saved.append(t.numel()), t)[1]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = loss_fn(model.train(), x, y)
    n_fwd = len(calls)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return (model, loss.detach(), grads, sum(saved), per_block, inputs, n_fwd,
            len(calls))


def test_remat_levels_give_equal_losses_and_grads():
    m0, l0, g0, saved0, blocks0, _, fwd0, all0 = _remat_run(0)
    m2, l2, g2, saved2, blocks2, inputs, fwd2, all2 = _remat_run(2)
    assert list(m0.state_dict()) == list(m2.state_dict())
    _close(l2, l0, atol=1e-6, rtol=0)
    for k in g0:
        _close(g2[k], g0[k], atol=1e-6, rtol=1e-6)
    # levels 0 and 1: encoder blocks 0, 1 and the decoder blocks of levels
    # 1 and 0 (DoubleConv_3, _4) run again in the backward
    remat = ("DoubleConv_0", "DoubleConv_1", "DoubleConv_3", "DoubleConv_4")
    assert (fwd0, all0) == (5, 5) and (fwd2, all2) == (5, 9)
    # what those blocks' ops save (the convs' and INs' inputs, the IN
    # statistics) is rebuilt in the backward, not held: of it only each
    # block's input is saved (by the checkpoint itself)
    assert all(blocks0[n] > 0 for n in blocks0)
    assert all(blocks2[n] == 0 for n in remat) and blocks2["DoubleConv_2"] > 0
    assert saved2 == saved0 - sum(blocks0[n] - inputs[n] for n in remat)
    assert saved2 < 0.6 * saved0


def test_remat_is_off_without_a_gradient():
    cfg = presets.UNetConfig(levels=2, base_features=4, compute_dtype="float32",
                             remat_levels=2)
    model = UNet3D(cfg)
    model.load_state_dict(weights.state_dict_from_flat(weights.init_params(cfg, 1)))
    x = torch.randn((1, 8, 8, 8, 4), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model(x)
    b = UNet3D(dataclasses.replace(cfg, remat_levels=0))
    b.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(a, b(x))


# --------------------------------------------------------------- warm start --

@pytest.fixture(scope="module")
def unit_like():
    return _stage_param_template(jax_presets.get_preset("unit"), "fine")


@pytest.mark.parametrize("ext", ["npz", "safetensors", "pt"])
def test_init_from_gives_the_reference_params(tmp_path, unit_like, ext):
    path = str(tmp_path / f"src.{ext}")
    if ext == "pt":
        torch.manual_seed(0)
        torch.save(TorchMirror(jax_presets.get_preset("unit").unet).state_dict(), path)
    else:
        src = jax.tree_util.tree_map(
            lambda a: np.random.default_rng(0).normal(size=a.shape).astype(a.dtype),
            unit_like)
        jax_export_params(path, src)
    want = _flat(jax_load_init_params(path, unit_like))
    got = loop._load_init_params(path, weights.param_template(
        presets.get_preset("unit").unet))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_init_from_refuses_a_shape_mismatch(tmp_path):
    path = str(tmp_path / "p.npz")
    weights.save_params(path, weights.init_params(presets.get_preset("smoke").unet))
    with pytest.raises((ValueError, KeyError)):
        loop._load_init_params(path, weights.param_template(
            presets.get_preset("unit").unet))


def _unit_args(tmp_path, workdir, *extra, data=True):
    head = ["--data", str(tmp_path / "data")]
    if data and not (tmp_path / "data").exists():
        head += ["--synthetic", "2", "--synthetic-shape", "32", "32", "32"]
    return head + ["--preset", "unit", "--workdir", str(workdir),
                   "--device", "cpu", *extra]


def test_warm_start_then_resume_wins_and_the_ema_is_seeded(tmp_path, capsys):
    unit = presets.get_preset("unit")
    torch.manual_seed(5)
    ckpt = str(tmp_path / "ref.pt")
    torch.save(TorchMirror(jax_presets.get_preset("unit").unet).state_dict(), ckpt)
    wd = tmp_path / "run"
    rc = train_cli.main(_unit_args(tmp_path, wd, "--steps", "2", "--checkpoint-every",
                                   "2", "--stage", "fine", "--init-from", ckpt,
                                   "--ema-decay", "0.9"))
    out = capsys.readouterr().out
    assert rc == 0 and "warm-started params from" in out
    state = torch.load(str(wd / "fine" / "checkpoints" / "2" / "state.pt"),
                       weights_only=True)
    imported = loop._load_init_params(ckpt, weights.param_template(unit.unet))
    random_init = weights.init_params(unit.unet, unit.train.seed)
    ema = state["opt_state"]["ema"]
    flat = lambda d: np.concatenate([np.ravel(np.asarray(d[k])) for k in sorted(d)])
    e = flat({"params/" + k.replace(".", "/"): v.numpy() for k, v in ema.items()})
    d_imported = np.linalg.norm(e - flat(imported))
    d_random = np.linalg.norm(e - flat(random_init))
    assert d_imported < 0.25 * d_random, (d_imported, d_random)
    rc = train_cli.main(_unit_args(tmp_path, wd, "--steps", "4", "--checkpoint-every",
                                   "2", "--stage", "fine", "--init-from", ckpt,
                                   "--ema-decay", "0.9"))
    out = capsys.readouterr().out
    assert rc == 0 and "IGNORED" in out and "resumed from step 2" in out


def test_init_from_requires_single_stage(tmp_path, capsys):
    rc = train_cli.main(["--data", str(tmp_path / "data"), "--synthetic", "1",
                         "--synthetic-shape", "32", "32", "32", "--preset",
                         "cascade", "--stage", "all", "--device", "cpu",
                         "--init-from", str(tmp_path / "x.npz")])
    assert rc == 2
    assert "requires an explicit --stage" in capsys.readouterr().err


# --------------------------------------------------------------- prep cache --

@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("prep")
    return synthetic.write_dataset(str(root / "d"), 1, shape=(40, 36, 32), seed0=3)[0]


@pytest.mark.parametrize("canvas,ds", [((32, 32, 32), 1), ((16, 16, 16), 2)])
def test_prep_cache_path_equals_reference(tmp_path, case_dir, canvas, ds):
    assert pipeline._prep_cache_path(str(tmp_path), case_dir, canvas, ds) == \
        jax_pipeline._prep_cache_path(str(tmp_path), case_dir, canvas, ds)
    assert pipeline.PREP_CACHE_VERSION == jax_pipeline.PREP_CACHE_VERSION


def _no_decode(monkeypatch, mod):
    def boom(*a, **k):
        raise AssertionError("decoded a NIfTI on a cache hit")
    monkeypatch.setattr(mod, "load_case", boom)


def _same(port, ref):
    assert port["image"].dtype == torch.bfloat16
    assert port["image"].view(torch.int16).numpy().tobytes() == \
        np.asarray(ref["image"]).view(np.uint16).tobytes()
    for k in ("seg", "fg"):
        assert port[k].dtype == ref[k].dtype and port[k].tobytes() == ref[k].tobytes()


@pytest.mark.parametrize("ds", [1, 2])
def test_an_entry_of_either_package_is_the_others_hit(tmp_path, case_dir,
                                                      monkeypatch, ds):
    canvas = (32, 32, 32) if ds == 1 else (16, 16, 16)
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    want = jax_pipeline.cached_prepare_training_case(case_dir, canvas, ds, jdir)
    uncached = pipeline.cached_prepare_training_case(case_dir, canvas, ds)
    _same(uncached, want)
    written = pipeline.cached_prepare_training_case(case_dir, canvas, ds, pdir)
    _same(written, want)
    assert os.listdir(jdir) == os.listdir(pdir)
    with monkeypatch.context() as m:
        _no_decode(m, pipeline)
        _same(pipeline.cached_prepare_training_case(case_dir, canvas, ds, jdir), want)
    with monkeypatch.context() as m:
        _no_decode(m, jax_pipeline)
        _same(pipeline.cached_prepare_training_case(case_dir, canvas, ds, pdir),
              jax_pipeline.cached_prepare_training_case(case_dir, canvas, ds, pdir))


def test_corrupt_entry_is_rebuilt(tmp_path, case_dir, capsys):
    cdir = str(tmp_path / "c")
    good = pipeline.cached_prepare_training_case(case_dir, (32, 32, 32), 1, cdir)
    path = pipeline._prep_cache_path(cdir, case_dir, (32, 32, 32), 1)
    with open(path, "wb") as f:
        f.write(b"not an npz")
    again = pipeline.cached_prepare_training_case(case_dir, (32, 32, 32), 1, cdir)
    assert "discarding corrupt cache entry" in capsys.readouterr().err
    assert torch.equal(again["image"].view(torch.int16), good["image"].view(torch.int16))
    with np.load(path) as z:
        assert set(z.files) == {"image_u16", "seg", "fg"}


def test_case_pool_reads_through_the_cache(tmp_path, case_dir, monkeypatch):
    cdir = str(tmp_path / "c")
    kw = dict(canvas=(32, 32, 32), cases=1, prep_cache_dir=cdir)
    first = pipeline.CasePool([case_dir], "cpu", **kw)
    with monkeypatch.context() as m:
        _no_decode(m, pipeline)
        second = pipeline.CasePool([case_dir], "cpu", **kw)
    assert torch.equal(first.image.view(torch.int16), second.image.view(torch.int16))
    assert torch.equal(first.seg, second.seg)
    assert np.array_equal(first.fg_host, second.fg_host)


# ----------------------------------------------------------- sampler checks --

def test_misbuilt_fg_table_raises_in_both_packages():
    img = np.random.default_rng(0).normal(size=(24, 24, 24, 4)).astype(np.float32)
    seg = np.zeros((24, 24, 24), np.uint8)
    gen = torch.Generator().manual_seed(0)
    good = np.full((16, 3), 12, np.int32)
    jout = jax_sampling.checked_sample_batch(
        jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(seg), (8, 8, 8), 2,
        jnp.asarray(good), 1.0)
    out = sampling.checked_sample_batch(gen, torch.from_numpy(img),
                                        torch.from_numpy(seg), (8, 8, 8), 2, good, 1.0)
    assert tuple(out[0].shape) == tuple(jout[0].shape) == (2, 8, 8, 8, 4)
    for bad in (np.full((16, 3), 99, np.int32), np.full((16, 3), -1, np.int32),
                np.array([[12, 12, 24]] * 16, np.int32)):
        with pytest.raises(Exception, match="out of volume bounds"):
            jax_sampling.checked_sample_batch(
                jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(seg), (8, 8, 8),
                2, jnp.asarray(bad), 1.0)
        with pytest.raises(ValueError, match="out of volume bounds"):
            sampling.checked_sample_batch(gen, torch.from_numpy(img),
                                          torch.from_numpy(seg), (8, 8, 8), 2, bad, 1.0)
    with pytest.raises(ValueError, match="exceeds volume"):
        sampling.checked_sample_batch(gen, torch.from_numpy(img),
                                      torch.from_numpy(seg), (32, 8, 8), 1, good)


def test_debug_checks_validate_the_pool(case_dir):
    pool = pipeline.CasePool([case_dir], "cpu", canvas=(32, 32, 32), cases=1)
    cfg = presets.TrainConfig(patch=(16, 16, 16))
    loop._validate_pool_sampling(pool, cfg)
    pool.fg_host[0, 5] = (40, 0, 0)
    with pytest.raises(ValueError, match="out of volume bounds"):
        loop._validate_pool_sampling(pool, cfg)


# ------------------------------------------------------- flags and sanitizers --

def test_new_train_flags_parse_and_flow(tmp_path, monkeypatch):
    unit = presets.get_preset("unit")
    for w in ("t1", "t2"):
        os.makedirs(tmp_path / w / "fine")
        weights.save_params(str(tmp_path / w / "fine" / "params.npz"),
                            weights.init_params(unit.unet, len(w)))
    seen = {}

    def fake_stage(exp, case_dirs, **kw):
        seen.update(kw, exp=exp)
        return loop.StageResult(model=None, final_metrics={}, workdir="")

    monkeypatch.setattr(loop, "train_stage", fake_stage)
    rc = train_cli.main(_unit_args(
        tmp_path, tmp_path / "s", "--stage", "fine", "--distill-from",
        str(tmp_path / "t1"), str(tmp_path / "t2"), "--kd-weight", "0.3",
        "--kd-temperature", "3", "--init-from", "x.npz", "--prep-cache",
        str(tmp_path / "pc"), "--debug-nans", "--debug-checks", "--profile"))
    assert rc == 0
    assert len(seen["kd_teachers"]) == 2
    assert all(not t.training for t in seen["kd_teachers"])
    assert (seen["kd_config"].kd_weight, seen["kd_config"].temperature,
            seen["kd_config"].gt_weight) == (0.3, 3.0, 1.0)
    assert seen["init_from"] == "x.npz" and seen["debug_nans"] and seen["profile"]
    assert seen["exp"].train.prep_cache_dir == str(tmp_path / "pc")
    assert seen["exp"].train.debug_checks
    # the JAX package's names and defaults
    from brats2019_tpu.cli import train as jax_train_cli

    ref = {a.dest: a for a in jax_train_cli.build_parser()._actions}
    mine = {a.dest: a for a in train_cli.build_parser()._actions}
    for dest in ("distill_from", "kd_weight", "kd_temperature", "init_from",
                 "prep_cache_dir", "debug_nans", "debug_checks", "profile"):
        assert mine[dest].option_strings == ref[dest].option_strings
        assert mine[dest].default == ref[dest].default


def test_debug_nans_stops_at_the_first_bad_step(tmp_path, monkeypatch):
    exp = dataclasses.replace(presets.get_preset("unit"), workdir=str(tmp_path / "w"))
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train, steps=4))
    dirs = synthetic.write_dataset(str(tmp_path / "d"), 1, shape=(32, 32, 32))

    class NanAt2(port_step.TrainStep):
        def __call__(self, pool, step):
            aux = super().__call__(pool, step)
            if step == 1:
                aux["grad_norm"] = torch.tensor(float("nan"))
            return aux

    monkeypatch.setattr(loop, "TrainStep", NanAt2)
    res = loop.train_stage(exp, dirs, device="cpu")        # flag off: runs on
    assert not res.preempted
    exp = dataclasses.replace(exp, workdir=str(tmp_path / "w2"))
    with pytest.raises(FloatingPointError, match="step 2"):
        loop.train_stage(exp, dirs, device="cpu", debug_nans=True)


def test_profile_on_train_and_predict_writes_a_trace(tmp_path):
    from brats2019_tpu_torch.cli import predict

    exp = dataclasses.replace(presets.get_preset("unit"), workdir=str(tmp_path / "w"))
    exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train, steps=12))
    dirs = synthetic.write_dataset(str(tmp_path / "d"), 1, shape=(32, 32, 32))
    loop.train_stage(exp, dirs, device="cpu", profile=True)
    trace = tmp_path / "w" / "fine" / "profile" / "trace.json"
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    out = tmp_path / "prof"
    rc = predict.main([dirs[0], "--preset", "unit", "--workdir", str(tmp_path / "w"),
                       "--device", "cpu", "--profile", str(out)])
    with open(out / "trace.json") as f:
        assert rc == 0 and json.load(f)["traceEvents"]


def test_info_reports_devices_flops_and_artifacts(tmp_path, monkeypatch, capsys):
    from brats2019_tpu_torch.cli import info

    monkeypatch.chdir(tmp_path)
    unit = presets.get_preset("unit")
    os.makedirs(os.path.join(unit.workdir, "fine"))
    weights.save_params(os.path.join(unit.workdir, "fine", "params.safetensors"),
                        weights.init_params(unit.unet))
    assert info.main(["--preset", "unit"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["torch"]["cuda"]["available"] == torch.cuda.is_available()
    assert got["flops"]["fine_train_step"] > got["flops"]["fine_forward_per_patch"] > 0
    fine = got["artifacts"]["fine"]
    assert fine["export"].endswith("params.safetensors") and not fine["export_stale"]
    assert got["preset"]["unet"] == dataclasses.asdict(unit.unet)


def test_info_reports_the_program_export_manifest(tmp_path, monkeypatch, capsys):
    """``stablehlo_manifest`` (the reference's key) points at the manifest of
    a program export under ``<workdir>/torch_export/``, once there is one."""
    from brats2019_tpu_torch.cli import info
    from brats2019_tpu_torch.infer.export_hlo import export_predict_program
    from brats2019_tpu_torch.infer.predictor import Predictor

    monkeypatch.chdir(tmp_path)
    unit = presets.get_preset("unit")
    assert info.main(["--preset", "unit"]) == 0
    assert "stablehlo_manifest" not in json.loads(capsys.readouterr().out)["artifacts"]
    one_tile = dataclasses.replace(unit, infer=dataclasses.replace(
        unit.infer, tile=(32, 32, 32)))
    out = os.path.join(unit.workdir, "torch_export")
    export_predict_program(Predictor(one_tile, weights.init_params(unit.unet),
                                     device="cpu"), out)
    assert info.main(["--preset", "unit"]) == 0
    got = json.loads(capsys.readouterr().out)["artifacts"]["stablehlo_manifest"]
    assert got == os.path.join(out, "manifest.json") and os.path.exists(got)
