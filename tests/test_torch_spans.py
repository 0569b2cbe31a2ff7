"""PyTorch port: the program spans (``utils/profile.py``) on the CPU: off
costs no ``record_function`` and no event; spans nest, and one volume's
spans share its request id across the pipelined predictor's threads; the
counts that the benchmark's readers divide by; the spans in a profiler's
events; and the ``brats_torch::conv3d_wgrad`` operator seam."""

import json
import types

import numpy as np
import pytest
import torch

from brats2019_tpu_torch import ops
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.infer.predictor import Predictor
from brats2019_tpu_torch.models.unet3d import UNet3D
from brats2019_tpu_torch.ops import connected_components as cc
from brats2019_tpu_torch.train.step import (Optimizer, TrainStep,
                                            make_microbatch_loss)
from brats2019_tpu_torch.utils import profile

NET = presets.UNetConfig(levels=2, base_features=4, compute_dtype="float32",
                         stem_downsample=2)
CALL_SPANS = ("predict.call", "predict.await_prep", "predict.program",
              "predict.await_post", "cc.sync")


def _flat(cfg, seed):
    torch.manual_seed(seed)
    return {"params/" + k.replace(".", "/"): v.numpy()
            for k, v in UNet3D(cfg).state_dict().items()}


@pytest.fixture(scope="module")
def predictor():
    """A staged sweep (4 tiles) with the device postprocessing, on the CPU."""
    exp = presets.ExperimentConfig(
        name="spans", unet=NET, train=presets.TrainConfig(pool_shape=(32, 32, 24)),
        infer=presets.InferenceConfig(
            canvas=(32, 32, 24), tile=(16, 32, 24), overlap=0.5, cascade=False,
            tta_flips=True, tta_precision="float32", compute_dtype="float32",
            postproc="device", serving_depth=2, min_component_voxels=4,
            et_min_voxels=2),
        workdir="unused")
    return Predictor(exp, _flat(NET, 0), device="cpu")


def _volumes(n, seed=0):
    rng = np.random.default_rng(seed)
    vols = []
    for _ in range(n):
        v = np.zeros((40, 38, 30, 4), np.float32)
        v[6:34, 5:33, 4:26] = rng.normal(size=(28, 28, 22, 4))
        vols.append(v)
    return vols


@pytest.fixture(autouse=True)
def _empty_recorder():
    profile.clear()
    yield
    profile.clear()


def test_off_makes_no_record_function_and_no_event(predictor, monkeypatch):
    made = []
    real_rf = torch.profiler.record_function

    def counted_rf(*a, **k):
        made.append("record_function")
        return real_rf(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted_rf)
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append("event"))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert profile.span("predict.call") is profile.span("cc.sync", device_edges=True)
    predictor.predict_arrays_many(_volumes(2))
    assert made == [] and profile.snapshot() == []


def test_spans_nest_and_share_request_ids_across_threads(predictor):
    with profile.recording():
        out = predictor.predict_arrays_many(_volumes(3))
    assert len(out) == 3
    spans = profile.snapshot()
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert not s.name.startswith("brats_torch::")
        assert s.end_ns >= s.start_ns
        if s.parent is not None:
            assert by_id[s.parent.id] is s.parent and s.parent.thread == s.thread
            assert s.parent.start_ns <= s.start_ns and s.end_ns <= s.parent.end_ns
    (call,) = [s for s in spans if s.name == "predict.call"]
    n = call.req[0]
    for name, parent in (("prep.encode", "predict.prep"),
                         ("prep.copy", "predict.prep"),
                         ("post.fetch", "predict.post"),
                         ("post.finish", "predict.post"),
                         ("program.sweep", "predict.program"),
                         ("program.cc", "predict.program"),
                         ("cc.sync", "program.cc")):
        assert {s.parent.name for s in spans if s.name == name} == {parent}, name
    threads = {}
    for i in range(3):
        mine = {s.name: s for s in spans if s.req == (n, i)}
        assert {"predict.prep", "prep.encode", "prep.copy", "predict.await_prep",
                "predict.program", "program.sweep", "program.cc", "cc.sync",
                "predict.post", "post.fetch", "post.finish"} <= set(mine), i
        threads[i] = {k: mine[k].thread for k in
                      ("predict.prep", "predict.program", "predict.post")}
        assert mine["predict.program"].thread == call.thread
        assert mine["predict.await_prep"].parent is call
    # the prep and post work ran in the pools' threads, not the caller's
    assert all(t["predict.prep"] != call.thread and t["predict.post"] != call.thread
               for t in threads.values())
    assert [s.name for s in spans if s.req == (n, None)].count("predict.await_post") == 1
    # without a card no span has device edges
    assert all(s.device_ms is None for s in spans)


def test_program_count_is_the_volume_count(predictor):
    with profile.recording():
        predictor.predict_arrays_many(_volumes(4, seed=1))
        predictor.predict_arrays(_volumes(1, seed=2)[0])
    names = [s.name for s in profile.snapshot()]
    assert names.count("predict.program") == 5
    assert names.count("program.cc") == 5 and names.count("program.sweep") == 5
    assert names.count("predict.prep") == 5 and names.count("predict.post") == 5
    assert names.count("predict.call") == 2


def test_pairing_and_directory_paths_keep_the_spans(tmp_path):
    """Pairing (the split cascade, ``batch_volumes`` 2): a pair's program
    spans are its two volumes'; an odd tail's ``stage_finish`` is a second
    span of its volume. ``predict_dirs`` adds the decode and the write."""
    from brats2019_tpu_torch.data.synthetic import write_dataset

    coarse = presets.UNetConfig(levels=2, base_features=4, compute_dtype="float32")
    exp = presets.ExperimentConfig(
        name="pairs", unet=NET, coarse_unet=coarse,
        train=presets.TrainConfig(pool_shape=(64, 64, 48)),
        infer=presets.InferenceConfig(
            canvas=(64, 64, 48), tile=(32, 32, 32), roi_shape=(32, 32, 32),
            coarse_shape=(32, 32, 24), cascade=True, tta_flips=True,
            tta_precision="float32", compute_dtype="float32", batch_volumes=2),
        workdir="unused")
    pred = Predictor(exp, _flat(NET, 0), _flat(coarse, 1), device="cpu")
    assert pred._pairs
    with profile.recording():
        pred.predict_arrays_many(_volumes(3, seed=5))
    spans = profile.snapshot()
    (call,) = [s.req[0] for s in spans if s.name == "predict.call"]
    programs = [s.req for s in spans if s.name == "predict.program"]
    assert sorted(programs) == [(call, 0), (call, 1), (call, 2), (call, 2)]
    profile.clear()
    dirs = write_dataset(str(tmp_path / "cases"), 2, shape=(72, 70, 52))
    with profile.recording():
        outs = pred.predict_dirs(dirs, [str(tmp_path / f"o{i}.nii.gz") for i in range(2)])
    assert len(outs) == 2
    names = [s.name for s in profile.snapshot()]
    for name in ("prep.decode", "prep.encode", "prep.copy", "post.write",
                 "predict.prep", "predict.post"):
        assert names.count(name) == 2, name
    # one pair, no tail
    assert names.count("predict.program") == 2


def test_mesh_program_opens_the_program_span():
    """``MultichipPredictor._run`` reads the switch and opens
    ``predict.program``: one a volume."""
    from brats2019_tpu_torch.infer.multichip import MultichipPredictor
    from brats2019_tpu_torch.parallel.mesh import make_mesh

    net = presets.UNetConfig(levels=2, base_features=4, compute_dtype="float32")
    exp = presets.ExperimentConfig(
        name="mc", unet=net, train=presets.TrainConfig(pool_shape=(32, 32, 32)),
        infer=presets.InferenceConfig(
            canvas=None, tile=(16, 16, 16), cascade=False, tta_flips=False,
            min_component_voxels=0, et_min_voxels=0, compute_dtype="float32",
            tta_precision="float32"))
    mp = MultichipPredictor(exp, _flat(net, 2), mode="sweep",
                            env=make_mesh(["cpu"] * 2))
    with profile.recording():
        for v in _volumes(2, seed=6):
            mp.predict_arrays(v)
    assert [s.name for s in profile.snapshot()] == ["predict.program"] * 2


@pytest.mark.parametrize("length,pool_iters", [(20, 192), (40, 8)])
def test_cc_sync_count_is_the_host_read_count(monkeypatch, length, pool_iters):
    """A line of ``length`` voxels converges in length - 1 pooling passes:
    with the cap above that, phase 1 reads its flag ceil(length / 8) times;
    with a cap of 8 one read ends phase 1 and each jump round reads once."""
    rounds = []
    real = cc._jump_round
    monkeypatch.setattr(cc, "_jump_round",
                        lambda *a: rounds.append(1) or real(*a))
    fg = torch.zeros(8, 8, 48, dtype=torch.bool)
    fg[3, 4, :length] = True
    with profile.recording():
        labels = profile.entry(cc.label_components)(fg, max_pool_iters=pool_iters)
    # one component, whose id is the linear index of its last voxel + 1
    assert (labels[fg] == 3 * 8 * 48 + 4 * 48 + length).all()
    reads = -(-min(length, pool_iters) // 8) + len(rounds)
    if pool_iters >= length:
        assert rounds == []
    else:
        assert rounds
    got = [s for s in profile.snapshot() if s.name == "cc.sync"]
    assert len(got) == reads


def test_spans_land_in_the_profiler_events(predictor):
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        predictor.predict_arrays_many(_volumes(2, seed=3))
    names = [e.name for e in prof.events()]
    for name in CALL_SPANS:
        assert name in names, name
    kept = {s.name for s in profile.snapshot()}
    assert set(CALL_SPANS) <= kept
    assert not any(n.startswith("brats_torch::") for n in kept)
    # the profiler's window only: a later call without it records nothing
    profile.clear()
    predictor.predict_arrays_many(_volumes(1))
    assert profile.snapshot() == []


def test_profile_trace_shows_the_pool_threads_spans(predictor, tmp_path):
    prof = profile.start_trace(torch.device("cpu"))
    try:
        predictor.predict_arrays_many(_volumes(2, seed=4))
    finally:
        path = profile.stop_trace(prof, torch.device("cpu"), str(tmp_path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tids = {}
    for e in events:
        if e.get("name") in ("predict.call", "predict.prep", "predict.post"):
            tids.setdefault(e["name"], set()).add(e.get("tid"))
    assert set(tids) == {"predict.call", "predict.prep", "predict.post"}
    assert not tids["predict.prep"] & tids["predict.call"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3d_wgrad_op_equals_the_plain_weight_gradient(dtype):
    torch.manual_seed(1)
    x = torch.randn(2, 6, 5, 4, 3).to(dtype).requires_grad_()
    w = torch.randn(3, 3, 3, 3, 5).to(dtype).requires_grad_()
    y = ops.conv3d(x, w)
    gy = torch.randn_like(y)
    y.backward(gy)
    _, dw, _ = torch.ops.aten.convolution_backward(
        gy.float().permute(0, 4, 1, 2, 3), x.detach().float().permute(0, 4, 1, 2, 3),
        w.detach().float().permute(4, 3, 0, 1, 2), None, [1, 1, 1], [1, 1, 1],
        [1, 1, 1], False, [0, 0, 0], 1, [False, True, False])
    want = dw.permute(2, 3, 4, 1, 0).to(dtype)
    assert torch.equal(w.grad, want)
    direct = torch.ops.brats_torch.conv3d_wgrad(x.detach(), gy, w.detach())
    assert torch.equal(direct, want) and direct.dtype == dtype
    fake = torch.ops.brats_torch.conv3d_wgrad(
        x.detach().to("meta"), gy.to("meta"), w.detach().to("meta"))
    assert fake.shape == w.shape and fake.dtype == dtype


def test_profiled_train_step_has_a_wgrad_call_per_forward_conv():
    from torch.profiler import ProfilerActivity

    cfg = presets.TrainConfig(patch=(16, 16, 16), batch_per_device=2, seed=3,
                              augment=True, steps=10, warmup_steps=1)
    torch.manual_seed(0)
    model = UNet3D(NET).train()
    g = torch.Generator().manual_seed(0)
    pool = types.SimpleNamespace(
        image=torch.randn(2, 24, 24, 20, 4, generator=g),
        seg=torch.randint(0, 4, (2, 24, 24, 20), generator=g).to(torch.uint8),
        fg_host=np.stack([np.argwhere(np.ones((24, 24, 20)))[:64].astype(np.int32)] * 2))
    step = TrainStep(model, cfg, make_microbatch_loss(cfg, NET.stem_downsample,
                                                      lowres=True),
                     Optimizer(dict(model.named_parameters()), cfg))
    convs = []
    hooks = [m.register_forward_hook(lambda *a: convs.append(1))
             for m in model.modules() if hasattr(m, "kernel")
             and m.kernel.dim() == 5 and m.kernel.shape[:3] == (3, 3, 3)]
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        step(pool, 0)
    for h in hooks:
        h.remove()
    names = [e.name for e in prof.events()]
    assert convs and names.count("brats_torch::conv3d_wgrad") == len(convs)
    for name in ("train.step", "train.sample", "train.forward", "train.backward",
                 "train.update"):
        assert names.count(name) == 1, name
    (sample,) = [s for s in profile.snapshot() if s.name == "train.sample"]
    assert sample.parent.name == "train.step" and sample.req == 0
