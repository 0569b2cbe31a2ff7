"""PyTorch port: data-parallel training over a mesh (``train/step.py``,
``train/loop.py``, ``data/pipeline.py``) and the multi-process launcher
(``parallel/multiprocess.py``), on CPU shards and gloo processes.

* the N-shard step's averaged gradients equal the mean of each shard's own
  gradients on its own batch (as ``tests/test_dp_parity.py``), and the
  sampling keys on the global shard index;
* a one-shard mesh trains exactly today's one-device run (the loss sequence
  bitwise);
* 2 gloo processes x 1 shard against 1 process x 2 shards: one data-parallel
  step, one sharded conv and one spatially sharded training gradient equal (the conv also against the JAX package's
  sharded conv), the flagship workload's losses and cascade mask equal, and
  no worker imports jax or the JAX package.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from brats2019_tpu_torch.configs.presets import get_preset
from brats2019_tpu_torch.data import synthetic
from brats2019_tpu_torch.models.unet3d import UNet3D
from brats2019_tpu_torch.parallel.mesh import make_mesh
from brats2019_tpu_torch.parallel.multiprocess import (decode_mask,
                                                       flagship_workload,
                                                       launch_workers,
                                                       parity_workload)
from brats2019_tpu_torch.train.loop import _Pools, train_stage
from brats2019_tpu_torch.train.step import (Optimizer, TrainStep,
                                            make_microbatch_loss,
                                            sample_microbatch, step_generator)
from brats2019_tpu_torch.utils.weights import init_params, state_dict_from_flat


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    synthetic.write_dataset(str(root / "d"), 3, shape=(40, 36, 28), seed0=1)
    return str(root / "d")


def _cases(data):
    return sorted(os.path.join(data, d) for d in os.listdir(data))


def _model(exp):
    m = UNet3D(exp.unet)
    m.load_state_dict(state_dict_from_flat(init_params(exp.unet, 0)))
    return m.train()


def test_step_generator_keeps_the_one_device_stream():
    a = torch.randint(0, 1 << 30, (4,), generator=step_generator(3, 7))
    b = torch.randint(0, 1 << 30, (4,), generator=step_generator(3, 7, 0))
    c = torch.randint(0, 1 << 30, (4,), generator=step_generator(3, 7, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("n", [2, 3])
def test_dp_grads_equal_the_mean_of_the_shards_grads(data, n):
    exp = get_preset("unit")
    cfg = dataclasses.replace(exp.train, batch_per_device=2, grad_accum_steps=2,
                              pool_refresh_every=0)
    env = make_mesh(["cpu"] * n)
    model = _model(exp)
    step = TrainStep(model, cfg, make_microbatch_loss(cfg), env=env,
                     opt=Optimizer(dict(model.named_parameters()), cfg))
    seen = {}
    real = step.opt.step
    step.opt.step = lambda g: seen.update(g) or real(g)
    pools = _Pools(env, _cases(data), cfg.pool_shape, cfg.pool_cases_per_device,
                   1, cfg.seed, None)
    ref_model = _model(exp)      # the weights before the step
    aux = step(pools.pools, 5)
    k = cfg.grad_accum_steps
    want = {name: torch.zeros_like(p) for name, p in ref_model.named_parameters()}
    losses = []
    for j in range(n):
        ref_model.zero_grad()
        for i in range(k):
            imgs, segs = sample_microbatch(pools.pools[j], cfg, 5 * k + i, j)
            loss, _ = make_microbatch_loss(cfg)(ref_model, imgs, segs)
            loss.backward()
            losses.append(loss.item())
        for name, p in ref_model.named_parameters():
            want[name] += p.grad / k / n
    for name, g in want.items():
        np.testing.assert_allclose(seen[name].numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(aux["loss"]), np.mean(losses), rtol=1e-5)
    # each shard saw its own cases: the cursors stride over the shards
    assert sorted(p.cursor.offset for p in pools.pools) == list(range(n))


def test_one_shard_mesh_trains_todays_run(data, tmp_path):
    exp = get_preset("unit")
    runs = {}
    for name, env in (("plain", None), ("mesh", make_mesh(["cpu"]))):
        e = dataclasses.replace(exp, workdir=str(tmp_path / name),
                                train=dataclasses.replace(exp.train, steps=3))
        train_stage(e, _cases(data)[:2], stage="fine", device="cpu", env=env)
        with open(tmp_path / name / "fine" / "fine_metrics.jsonl") as f:
            runs[name] = [(r["step"], r["loss"], r["grad_norm"])
                          for r in map(json.loads, f) if "loss" in r]
    assert runs["plain"] == runs["mesh"] and len(runs["plain"]) == 3


def test_dp_training_resumes_and_validates(data, tmp_path):
    exp = get_preset("unit")
    e = dataclasses.replace(exp, workdir=str(tmp_path / "w"), train=dataclasses.replace(
        exp.train, steps=2, eval_every=2, checkpoint_every=2))
    env = make_mesh(["cpu"] * 2)
    res = train_stage(e, _cases(data)[:2], stage="fine", val_dirs=_cases(data)[2:],
                      env=env)
    assert np.isfinite(res.final_metrics["loss"])
    assert res.final_metrics["patches_per_sec"] == pytest.approx(
        2 * res.final_metrics["steps_per_sec"])
    state = torch.load(tmp_path / "w" / "fine" / "checkpoints" / "2" / "state.pt",
                       weights_only=True)
    assert len(state["cursor"]["shards"]) == 2
    e4 = dataclasses.replace(e, train=dataclasses.replace(e.train, steps=4))
    res = train_stage(e4, _cases(data)[:2], stage="fine", val_dirs=_cases(data)[2:],
                      env=env)
    with open(tmp_path / "w" / "fine" / "fine_metrics.jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    assert any("val_dice_mean" in r for r in recs)
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4]


@pytest.fixture(scope="module")
def jax_sharded_conv():
    """The JAX package's sharded conv of parity_workload's seeded input."""
    import jax.numpy as jnp

    from brats2019_tpu.parallel import mesh as ref_mesh
    from brats2019_tpu.parallel import spatial as ref_spatial

    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 12, 8, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4, 6)).astype(np.float32)
    fn = ref_spatial.make_sharded_conv3d(ref_mesh.make_mesh())
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(w)))


def test_two_gloo_processes_match_one_process_of_two_shards(data, tmp_path,
                                                            jax_sharded_conv):
    one = parity_workload(data, make_mesh(["cpu"] * 2))
    res = launch_workers(data, str(tmp_path / "w"), num_processes=2,
                         shards_per_process=1, device="cpu", workload="parity",
                         timeout=300)
    assert len(res) == 2
    for r in res:
        assert r["backend"] == "gloo" and r["bringup_sum"] == 3.0
        assert r["forbidden_modules"] == []
        assert (r["process_count"], r["shard_count"]) == (2, 2)
        assert r["loss"] == pytest.approx(one["loss"], rel=1e-5)
        assert r["grad_norm"] == pytest.approx(one["grad_norm"], rel=1e-5)
        for k, v in one["params"].items():
            np.testing.assert_allclose(r["params"][k], v, rtol=1e-5, atol=1e-7)
        assert r["conv"] == one["conv"]
        # the halos and IN statistics crossing the processes, both ways
        assert r["spatial_loss"] == pytest.approx(one["spatial_loss"], rel=1e-5)
        for k, v in one["spatial_grads"].items():
            np.testing.assert_allclose(r["spatial_grads"][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    np.testing.assert_allclose(np.asarray(one["conv"]).reshape(one["conv_shape"]),
                               jax_sharded_conv, rtol=1e-5, atol=1e-5)


def test_flagship_workload_over_two_processes(tmp_path):
    data = str(tmp_path / "d")
    synthetic.write_dataset(data, 2, shape=(64, 40, 36), seed0=1)
    one = flagship_workload(data, str(tmp_path / "one"), env=make_mesh(["cpu"] * 2))
    res = launch_workers(data, str(tmp_path / "two"), num_processes=2,
                         shards_per_process=1, device="cpu", timeout=600)
    assert np.isfinite(one["loss_first"]) and np.isfinite(one["loss_resumed"])
    for r in res:
        assert r["forbidden_modules"] == []
        assert r["loss_first"] == pytest.approx(one["loss_first"], rel=1e-5)
        assert r["loss_resumed"] == pytest.approx(one["loss_resumed"], rel=1e-5)
        assert np.array_equal(decode_mask(r), decode_mask(one))


def test_launcher_defaults_to_the_card():
    """The launcher runs on the card unless asked for the CPU: on a host
    without one the workers fail (raise), never run the CPU path."""
    import inspect

    assert inspect.signature(launch_workers).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            launch_workers("unused", "unused", num_processes=1,
                           shards_per_process=1, workload="parity", timeout=120)
