"""PyTorch port: knowledge distillation (``train/distill.py``) against the
JAX package's ``brats2019_tpu/train/distill.py``, in f32 on the CPU at
small sizes: the KD loss and the teacher ensemble's probabilities within
1e-6, and three KD train steps with two teachers against JAX's
``make_kd_train_step`` on a one-device CPU mesh, on the same batches (a
pool of one case of the patch's size: every draw is the whole case) —
loss, ``kd_loss``, grad norm and params within 1e-5 abs + 1e-4 rel; the
same three steps over two shards (``TrainStep`` over a ``cpu, cpu`` mesh,
the teachers through ``teacher_replicas``) against JAX's step on a
two-device CPU mesh, one case a shard, within the same tolerance; and the
replica map over two distinct devices (``cpu`` and ``meta``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.configs.presets import TrainConfig as JaxTrainConfig
from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.models.unet3d import UNetConfig as JaxUNetConfig
from brats2019_tpu.parallel.mesh import make_mesh
from brats2019_tpu.train import distill as jax_distill
from brats2019_tpu.train.checkpoint import export_params as jax_export_params
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.parallel import mesh as port_mesh
from brats2019_tpu_torch.train import distill, step as port_step
from brats2019_tpu_torch.utils.weights import build_unet, load_params_npz

TOL = dict(atol=1e-5, rtol=1e-4)
S_KW = dict(levels=2, base_features=4, max_features=8, compute_dtype="float32")
T_KW = dict(levels=2, base_features=8, max_features=16, compute_dtype="float32")
PATCH = (16, 16, 16)
STEPS = 3
CFG_KW = dict(patch=PATCH, pool_shape=PATCH, pool_cases_per_device=1,
              batch_per_device=1, steps=8, warmup_steps=2, lr=1e-3,
              grad_clip=0.5, augment=False)
KD = dict(kd_weight=0.7, temperature=2.0, gt_weight=0.5)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    """A JAX params tree as the export format's flat dict."""
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bridge(tmp_path, kw, seed, name):
    """A JAX net's params and the port's net holding the same values."""
    jm = JaxUNet3D(JaxUNetConfig(**kw))
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1,) + PATCH + (4,)))
    path = str(tmp_path / f"{name}.npz")
    jax_export_params(path, params)
    return jm, params, load_params_npz(path)


@pytest.mark.parametrize("t", [1.0, 2.0, 4.0])
def test_kd_loss_matches_reference(t):
    rng = np.random.default_rng(int(t))
    logits = rng.normal(size=(2, 6, 5, 4, 4)).astype(np.float32) * 3
    teacher = rng.dirichlet(np.ones(4), size=(2, 6, 5, 4)).astype(np.float32)
    teacher[0, 0, 0, 0] = (1.0, 0.0, 0.0, 0.0)       # log(0) clamped
    want = jax_distill.kd_loss(jnp.asarray(logits), jnp.asarray(teacher), t)
    got = distill.kd_loss(torch.from_numpy(logits), torch.from_numpy(teacher), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_kd_loss_zero_when_matching_and_positive_when_not():
    logits = torch.randn((1, 4, 4, 4, 4), generator=torch.Generator().manual_seed(0))
    assert float(distill.kd_loss(logits, torch.softmax(logits / 2, -1), 2.0)) < 1e-5
    onehot = torch.nn.functional.one_hot(torch.ones((1, 4, 4, 4), dtype=torch.long), 4)
    assert float(distill.kd_loss(torch.zeros_like(logits), onehot.float(), 1.0)) > 0.5


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("teachers")
    return [_bridge(tmp, T_KW, seed, f"t{seed}") for seed in (7, 8)]


@pytest.mark.parametrize("t", [1.0, 3.0])
def test_ensemble_teacher_probs_match_reference(teachers, t):
    x = np.random.default_rng(2).normal(size=(1,) + PATCH + (4,)).astype(np.float32)
    want = jax_distill.ensemble_teacher_probs(
        [lambda p, v, m=jm: m.apply(p, v) for jm, _, _ in teachers],
        [p for _, p, _ in teachers], jnp.asarray(x), t)
    nets = distill.build_teachers(presets.UNetConfig(**T_KW),
                                  [f for _, _, f in teachers], "cpu")
    got = distill.ensemble_teacher_probs(nets, torch.from_numpy(x), t)
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # the mean over teachers, in teacher order
    one = [distill.ensemble_teacher_probs([n], torch.from_numpy(x), t) for n in nets]
    torch.testing.assert_close(got, (one[0] + one[1]) / 2, atol=1e-7, rtol=0)


def test_teachers_are_frozen(teachers):
    nets = distill.build_teachers(presets.UNetConfig(**T_KW),
                                  [f for _, _, f in teachers], "cpu")
    assert all(not n.training for n in nets)
    assert all(not p.requires_grad for n in nets for p in n.parameters())


@pytest.fixture(scope="module")
def jax_kd_run(tmp_path_factory, teachers):
    """JAX's KD step for STEPS steps on a one-device mesh: the initial
    student export, per-step aux and params."""
    tmp = tmp_path_factory.mktemp("student")
    sm, sp, s_flat = _bridge(tmp, S_KW, 0, "student")
    cfg = JaxTrainConfig(**CFG_KW)
    env = make_mesh([jax.devices()[0]])
    step = jax_distill.make_kd_train_step(
        lambda p, v: sm.apply(p, v),
        [lambda p, v, m=jm: m.apply(p, v) for jm, _, _ in teachers],
        [p for _, p, _ in teachers], cfg, jax_distill.KDConfig(**KD), env)
    rng = np.random.default_rng(5)
    img = rng.normal(size=(1,) + PATCH + (4,)).astype(np.float32)
    seg = rng.integers(0, 4, size=(1,) + PATCH).astype(np.uint8)
    fg = np.zeros((1, 16, 3), np.int32)
    p, o = sp, step.tx.init(sp)
    auxs, params = [], []
    for s in range(STEPS):
        p, o, aux = step.fn(p, o, jnp.asarray(img), jnp.asarray(seg),
                            jnp.asarray(fg), jnp.int32(s))
        auxs.append({k: float(v) for k, v in jax.device_get(aux).items()})
        params.append(_flat(p))
    return s_flat, img, seg, auxs, params


def test_kd_train_steps_match_jax(teachers, jax_kd_run):
    s_flat, img, seg, auxs, params = jax_kd_run
    cfg = presets.TrainConfig(**CFG_KW)
    model = build_unet(presets.UNetConfig(**S_KW), s_flat, "cpu").train()
    model.requires_grad_(True)
    nets = distill.build_teachers(presets.UNetConfig(**T_KW),
                                  [f for _, _, f in teachers], "cpu")
    before = [{k: v.clone() for k, v in n.state_dict().items()} for n in nets]
    opt = port_step.Optimizer(dict(model.named_parameters()), cfg)
    loss_fn = distill.make_kd_microbatch_loss(
        distill.teacher_replicas(nets, ["cpu"]), cfg, distill.KDConfig(**KD))
    batch = [(torch.from_numpy(img), torch.from_numpy(seg).long())]
    for s in range(STEPS):
        aux = port_step.train_update(model, opt, loss_fn, batch)
        for k in ("loss", "kd_loss", "dice_loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(aux[k]), auxs[s][k], **TOL, err_msg=k)
        # loss = gt_weight * (dice + ce) + kd_weight * kd
        want = (KD["gt_weight"] * (aux["dice_loss"] + aux["ce_loss"])
                + KD["kd_weight"] * aux["kd_loss"])
        np.testing.assert_allclose(float(aux["loss"]), float(want), rtol=1e-6)
        for name, p in model.named_parameters():
            key = "params/" + name.replace(".", "/")
            np.testing.assert_allclose(p.detach().numpy(), params[s][key], **TOL,
                                       err_msg=key)
    for n, b in zip(nets, before):
        assert all(torch.equal(v, b[k]) for k, v in n.state_dict().items())
    assert all(p.grad is None for n in nets for p in n.parameters())


def test_kd_loss_shares_grad_accumulation(teachers):
    """The KD loss plugs into train_update: k microbatches' grads are
    summed and divided by k, aux means include kd_loss."""
    cfg = presets.TrainConfig(**dict(CFG_KW, grad_accum_steps=2))
    flat = {k: v for k, v in teachers[0][2].items()}
    nets = distill.build_teachers(presets.UNetConfig(**T_KW), [flat], "cpu")
    loss_fn = distill.make_kd_microbatch_loss({torch.device("cpu"): nets}, cfg,
                                              distill.KDConfig())
    rng = np.random.default_rng(9)
    micro = [(torch.from_numpy(rng.normal(size=(1,) + PATCH + (4,)).astype(np.float32)),
              torch.from_numpy(rng.integers(0, 4, size=(1,) + PATCH)).long())
             for _ in range(2)]
    auxs = []
    for mb in micro:
        m = build_unet(presets.UNetConfig(**T_KW), flat, "cpu").train()
        m.requires_grad_(True)
        auxs.append({k: v.detach() for k, v in loss_fn(m, *mb)[1].items()})
    model = build_unet(presets.UNetConfig(**T_KW), flat, "cpu").train()
    model.requires_grad_(True)
    opt = port_step.Optimizer(dict(model.named_parameters()), cfg)
    aux = port_step.train_update(model, opt, loss_fn, micro)
    for k in ("loss", "kd_loss"):
        np.testing.assert_allclose(float(aux[k]), float((auxs[0][k] + auxs[1][k]) / 2),
                                   rtol=1e-6)
    # the student equals the teacher: its KD term is 0 on both batches
    assert float(aux["kd_loss"]) < 1e-5


def test_kd_needs_a_teacher():
    with pytest.raises(ValueError, match="teacher"):
        distill.make_kd_microbatch_loss({}, presets.TrainConfig(), distill.KDConfig())
    with pytest.raises(ValueError, match="teacher"):
        distill.make_kd_microbatch_loss({torch.device("cpu"): []},
                                        presets.TrainConfig(), distill.KDConfig())


def test_kd_config_matches_reference():
    assert [f.name for f in dataclasses.fields(distill.KDConfig)] == [
        f.name for f in dataclasses.fields(jax_distill.KDConfig)]
    assert distill.KDConfig() == distill.KDConfig(**dataclasses.asdict(
        jax_distill.KDConfig()))


@pytest.fixture(scope="module")
def jax_kd_run_2(tmp_path_factory, teachers):
    """JAX's KD step for STEPS steps on a two-device CPU mesh, one case (of
    the patch's size) a shard: the initial student export, the two cases,
    per-step aux and params."""
    tmp = tmp_path_factory.mktemp("student2")
    sm, sp, s_flat = _bridge(tmp, S_KW, 1, "student")
    cfg = JaxTrainConfig(**CFG_KW)
    env = make_mesh(jax.devices()[:2])
    step = jax_distill.make_kd_train_step(
        lambda p, v: sm.apply(p, v),
        [lambda p, v, m=jm: m.apply(p, v) for jm, _, _ in teachers],
        [p for _, p, _ in teachers], cfg, jax_distill.KDConfig(**KD), env)
    rng = np.random.default_rng(6)
    img = rng.normal(size=(2,) + PATCH + (4,)).astype(np.float32)
    seg = rng.integers(0, 4, size=(2,) + PATCH).astype(np.uint8)
    fg = np.zeros((2, 16, 3), np.int32)
    p, o = sp, step.tx.init(sp)
    auxs, params = [], []
    for s in range(STEPS):
        p, o, aux = step.fn(p, o, jnp.asarray(img), jnp.asarray(seg),
                            jnp.asarray(fg), jnp.int32(s))
        auxs.append({k: float(v) for k, v in jax.device_get(aux).items()})
        params.append(_flat(p))
    return s_flat, img, seg, auxs, params


def test_kd_train_steps_over_two_shards_match_jax(teachers, jax_kd_run_2):
    """Data-parallel KD: each shard's loss runs its device's teachers; the
    averaged step equals JAX's two-device KD step."""
    import types

    s_flat, img, seg, auxs, params = jax_kd_run_2
    cfg = presets.TrainConfig(**CFG_KW)
    env = port_mesh.make_mesh(["cpu"] * 2)
    model = build_unet(presets.UNetConfig(**S_KW), s_flat, "cpu").train()
    model.requires_grad_(True)
    nets = distill.build_teachers(presets.UNetConfig(**T_KW),
                                  [f for _, _, f in teachers], "cpu")
    replicas = distill.teacher_replicas(nets, env.local_devices())
    assert list(replicas) == [torch.device("cpu")]
    assert all(a is b for a, b in zip(replicas[torch.device("cpu")], nets))
    step = port_step.TrainStep(
        model, cfg, distill.make_kd_microbatch_loss(replicas, cfg,
                                                    distill.KDConfig(**KD)),
        env=env)
    pools = [types.SimpleNamespace(
        image=torch.from_numpy(img[j:j + 1]), seg=torch.from_numpy(seg[j:j + 1]),
        fg_host=np.zeros((1, 16, 3), np.int32)) for j in range(2)]
    for s in range(STEPS):
        aux = step(pools, s)
        for k in ("loss", "kd_loss", "dice_loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(aux[k]), auxs[s][k], **TOL, err_msg=k)
        for name, p in model.named_parameters():
            key = "params/" + name.replace(".", "/")
            np.testing.assert_allclose(p.detach().numpy(), params[s][key], **TOL,
                                       err_msg=key)


def test_teacher_replicas_one_frozen_copy_per_device(teachers):
    """Two distinct devices: the teachers already on the CPU serve there as
    they are; the other device gets one frozen copy of each; the originals
    keep their values and device."""
    nets = distill.build_teachers(presets.UNetConfig(**T_KW),
                                  [f for _, _, f in teachers], "cpu")
    before = [{k: v.clone() for k, v in n.state_dict().items()} for n in nets]
    cpu, meta = torch.device("cpu"), torch.device("meta")
    env = port_mesh.MeshEnv(devices=(cpu, meta, cpu))
    reps = distill.teacher_replicas(nets, env.local_devices())
    assert list(reps) == [cpu, meta]
    assert all(a is b for a, b in zip(reps[cpu], nets))
    assert len(reps[meta]) == len(nets)
    for copy_, orig in zip(reps[meta], nets):
        assert copy_ is not orig and not copy_.training
        assert all(p.device == meta and not p.requires_grad
                   for p in copy_.parameters())
        assert ([k for k, _ in copy_.named_parameters()]
                == [k for k, _ in orig.named_parameters()])
    for n, b in zip(nets, before):
        assert all(v.device == cpu and torch.equal(v, b[k])
                   for k, v in n.state_dict().items())
    # the loss takes the replicas on its input's device: on the CPU the
    # mesh's map gives the one-device map's loss bitwise; a device without
    # replicas is an error
    cfg = presets.TrainConfig(**CFG_KW)
    kd = distill.KDConfig(**KD)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1,) + PATCH + (4,)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(4).integers(
        0, 4, size=(1,) + PATCH)).long()
    student = build_unet(presets.UNetConfig(**T_KW), teachers[0][2], "cpu")
    one = distill.teacher_replicas(nets, [cpu])
    assert all(a is b for a, b in zip(one[cpu], nets))
    a = distill.make_kd_microbatch_loss(one, cfg, kd)(student, x, y)[0]
    b = distill.make_kd_microbatch_loss(reps, cfg, kd)(student, x, y)[0]
    assert torch.equal(a, b)
    with pytest.raises(KeyError):
        distill.make_kd_microbatch_loss({meta: reps[meta]}, cfg, kd)(student, x, y)
