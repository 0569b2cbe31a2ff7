"""CPU tests of the benchmark (``perfbench/``): cells found by name, the
frozen yardstick, the plain reference against the program, the result line,
the faults that must turn ``correct`` false, and the imports of a run.

Run from the checkout's root: ``python -m pytest perfbench/tests -q``.
"""

import io
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import REPO, make_root, preset_config, shrink
from perfbench import drivers, harness, synth, yardstick
from perfbench.reference import segment, train as ref_train, unet as ref_unet

CELLS = ("single_chip.cohort", "single_chip.train_b16")
PREDICT = drivers.load(REPO, "predict_closed_loop")
TRAIN = drivers.load(REPO, "train")


def run_cell(root, cell, seed=11, trace=False, seconds=0.5):
    out = io.StringIO()
    rc = harness.run(root, cell, seed, seconds, trace, time.perf_counter(),
                     device="cpu", out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    root = REPO
    spec = harness.load_spec(root)
    c, config, mix, limits = harness.cell_parts(root, spec, cell)
    assert callable(drivers.load(root, mix["kind"]).run) and limits
    harness.experiment(config)   # every field a field of the program's config
    for m in spec["per_layer"]:
        if harness.reports(m, cell, spec):
            assert harness.reader(root, m["name"])({}, None) is None


def test_new_mix_config_and_metric_are_files(tiny_root):
    """A configuration, a traffic mix of a new kind with its driver, and a
    per-layer metric added as files and entries only, in a checkout of
    their own."""
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny_root / "perfbench/configs/single_chip.json").read_text())
    cfg["experiment"]["infer"]["transfer_bucket"] = 0
    (tiny_root / "perfbench/configs/single_whole.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny_root / "perfbench/traffic/cohort.json").read_text())
    mix.update(volumes=2, kind="cohort_marked")
    (tiny_root / "perfbench/traffic/pair.json").write_text(json.dumps(mix))
    (tiny_root / "perfbench/traffic/cohort_marked.py").write_text(
        "from pathlib import Path\n"
        "from perfbench import drivers\n"
        "def run(ctx):\n"
        "    base = drivers.load(Path(__file__).resolve().parents[2], 'predict_closed_loop')\n"
        "    out = base.run(ctx)\n"
        "    out.readings['marked'] = 1.0\n"
        "    return out\n")
    (tiny_root / "perfbench/metrics/judged_volumes.py").write_text(
        "def read(readings, profile):\n"
        "    return float(len(readings.get('judged', []))) + readings['marked']\n")
    (tiny_root / "perfbench/limits/single_whole.pair.json").write_text('{"gap": 0.05}')
    spec["configs"].append(dict(spec["configs"][0], name="single_whole",
                                file="perfbench/configs/single_whole.json"))
    spec["workloads"].append({"name": "single_whole.pair", "config": "single_whole",
                              "traffic": "pair", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "judged_volumes", "unit": "vol", "better": "higher",
                              "source": "host_clock", "layer": "test",
                              "moves": "predict_vol_per_s",
                              "workloads": ["single_whole.pair"]})
    spec["end_to_end"][0]["workloads"].append("single_whole.pair")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    traced = run_cell(tiny_root, "single_whole.pair", trace=True)
    assert traced["metrics"]["judged_volumes"]["value"] == 3.0
    assert traced["attempted"] == 2
    assert set(run_cell(tiny_root, "single_whole.pair")["metrics"]) == {
        "predict_vol_per_s", "setup_s"}


@pytest.mark.parametrize("preset", ["cascade", "single_chip", "train"])
def test_yardstick_equals_program_flops(preset):
    from brats2019_tpu_torch.configs import get_preset
    from brats2019_tpu_torch.utils import flops

    name = "single_chip" if preset == "train" else preset
    cfg = (json.loads((REPO / "perfbench/configs/single_chip.json").read_text())
           if name == "single_chip" else preset_config(name))["experiment"]
    exp = get_preset(name)
    if preset == "train":
        got = yardstick.train_step_flops(cfg["unet"], cfg["train"])
        want, tflop = flops.train_step_flops(exp.unet, exp.train), 1.660
    else:
        got = yardstick.predict_program_flops(cfg)
        want = flops.predict_program_flops(exp, exp.infer.canvas)
        tflop = {"cascade": 4.545, "single_chip": 53.12}[preset]
    assert got == want
    assert round(got / 1e12, 3 if tflop < 10 else 2) == tflop


def test_conv_bound_is_the_larger_term():
    nbytes, flops = yardstick.conv_terms((8, 64, 64, 64, 32, 64))
    assert flops == 2 * 27 * 32 * 64 * 8 * 64 ** 3
    assert yardstick.conv_bound_s((8, 64, 64, 64, 32, 64)) == max(
        nbytes / yardstick.PEAK_BW, flops / yardstick.PEAK_BF16)


def _tiny_config(f32=True, preset="single_chip"):
    """The committed configuration, or for the cascade (no committed cell
    runs it) the program's preset, cut to the tiny size."""
    cfg = (json.loads((REPO / "perfbench/configs/single_chip.json").read_text())
           if preset == "single_chip" else preset_config(preset))
    return shrink(cfg, f32=f32)


def test_reference_unet_equals_port_forward():
    from brats2019_tpu_torch.utils.weights import build_unet

    cfg = _tiny_config()
    net = cfg["experiment"]["unet"]
    flat = {k: v.numpy() for k, v in synth.params(
        ref_unet.param_shapes(net), 3, "fine", "cpu").items()}
    model = build_unet(harness.experiment(cfg).unet, flat, "cpu")
    x = torch.randn(2, 16, 16, 16, 4, generator=torch.Generator().manual_seed(0))
    params = {k: torch.from_numpy(v) for k, v in flat.items()}
    with torch.no_grad():
        want = model(x)
    torch.testing.assert_close(ref_unet.forward(params, net, x), want,
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("preset", ["cascade", "single_chip"])
def test_reference_segmenter_agrees_with_predictor(preset):
    """In f32 on the CPU the program's labels and ROI are the reference's."""
    from brats2019_tpu_torch.infer.predictor import Predictor

    cfg = _tiny_config(preset=preset)
    exp, e = harness.experiment(cfg), cfg["experiment"]
    fine = drivers.flat_params(e, 5, "cpu")
    coarse = drivers.flat_params(e, 5, "cpu", coarse=True) if e.get("coarse_unet") else None
    # bf16 values: the program sends the volume in bf16 whatever it computes in
    vols = [torch.from_numpy(v).bfloat16().float().numpy()
            for v in synth.volumes(2, (36, 36, 28), 5, "cpu")]
    pred = Predictor(exp, fine, coarse, device="cpu")
    keeper = PREDICT._Starts(pred.program)
    pred.program = keeper
    labels = pred.predict_arrays_many(vols)
    ref = segment.Segmenter(e, fine, coarse, "cpu")
    for vol, lab, start in zip(vols, labels, keeper.taken):
        r = segment.judge_served(ref, vol, lab, start.numpy())
        assert r["roi_gap"] == 0.0
        assert r["gap"] < 1e-3 and r["mismatched"] <= 2


def test_reference_train_agrees_with_train_step():
    cfg = _tiny_config()
    ctx = drivers.Context(exp=harness.experiment(cfg), config=cfg["experiment"],
                          mix={"batch_per_device": 4, "pool_cases": 2,
                               "raw_shape": [36, 36, 28], "checked_steps": 3},
                          seed=9, seconds=0, traced=False,
                          device=torch.device("cpu"), t0=0.0)
    step, pool, p0, tdict, got = TRAIN.setup(ctx)
    r = TRAIN.compare(ctx, pool, p0, tdict, got)
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-3 and r["update_gap"] < 1e-3


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny_root, cell, trace):
    res = run_cell(tiny_root, cell, trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    spec = harness.load_spec(tiny_root)
    kinds = spec["per_layer"] if trace else spec["end_to_end"]
    listed = {m["name"] for m in kinds if harness.reports(m, cell, spec)}
    assert set(res["metrics"]) <= listed
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == listed
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_forbidden_modules_compare_whole_names(monkeypatch):
    for name in ("brats2019_tpu_torch.fake", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, None)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "brats2019_tpu.fake", None)
    monkeypatch.setitem(sys.modules, "jax", None)
    assert harness.forbidden_modules() == ["brats2019_tpu.fake", "jax"]


def test_a_run_imports_no_jax(tmp_path):
    root = make_root(tmp_path / "checkout")
    code = (
        "import sys, time, io; sys.path.insert(0, %r)\n"
        "from perfbench import harness\n"
        "rc = harness.run(__import__('pathlib').Path(%r), 'single_chip.cohort', 3, 0.2,"
        " False, time.perf_counter(), device='cpu', out=io.StringIO())\n"
        "print(rc, harness.forbidden_modules())\n" % (str(REPO), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "0 []", out.stderr[-2000:]


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "single_chip.cohort", "--seed",
         "4294967297", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def _alter_answer(monkeypatch):
    """An answer altered where it is produced: the device postprocessing's
    labels get one class more in a 4^3 block at the ROI's centre."""
    from brats2019_tpu_torch.models import cascade

    real = cascade.postprocess_device

    def altered(labels, *a):
        out = real(labels, *a).clone()
        c = [s // 2 for s in out.shape]
        blk = tuple(slice(x - 2, x + 2) for x in c)
        out[blk] = (out[blk] + 1) % 4
        return out

    monkeypatch.setattr(cascade, "postprocess_device", altered)


def _skip_postprocess(monkeypatch):
    """The postprocessing skipped: the labels served as the argmax left
    them, small components and a tiny enhancing tumour kept."""
    from brats2019_tpu_torch.models import cascade

    monkeypatch.setattr(cascade, "postprocess_device", lambda labels, *a: labels)


def _state_unchanged(monkeypatch):
    from brats2019_tpu_torch.train import step

    monkeypatch.setattr(step.Optimizer, "step",
                        lambda self, grads: torch.zeros(()))


def _half_batch(monkeypatch):
    from brats2019_tpu_torch.train import step

    real = step.sample_microbatch

    def half(*a, **k):
        imgs, segs = real(*a, **k)
        return imgs[: len(imgs) // 2], segs[: len(segs) // 2]

    monkeypatch.setattr(step, "sample_microbatch", half)


@pytest.mark.parametrize("cell,fault,seed", [
    ("single_chip.cohort", _alter_answer, 11),
    # a seed whose tiny nets leave small components inside the brain box
    ("single_chip.cohort", _skip_postprocess, 7),
    ("single_chip.train_b16", _state_unchanged, 11),
    ("single_chip.train_b16", _half_batch, 11)])
def test_a_fault_turns_correct_false(tiny_root, monkeypatch, cell, fault, seed):
    fault(monkeypatch)
    res = run_cell(tiny_root, cell, seed=seed)
    assert res["correct"] is False, res["checks"]


def test_reference_judges_a_shifted_roi():
    """A start no coarse mask yields reads the widest gap; the reference's
    own start reads none."""
    margin = np.full((16, 16, 16), -0.5, np.float32)
    margin[4:8, 6:10, 2:5] = 0.5
    canvas, roi = (32, 32, 32), (16, 16, 16)
    own = segment.bbox_start(margin > 0, canvas, roi)
    assert segment.roi_gap(margin, own, canvas, roi) == 0.0
    assert segment.roi_gap(margin, own + np.array([2, 0, 0]), canvas, roi) == 0.5


def test_kept_gap_reads_the_postprocessing_post_condition():
    """A measured speck the filter should have cleared reads 1; cleared, or
    joined to a tumour through voxels the labels do not show, 0; an ET
    count under the rule's minimum reads the gap of the unseen voxel that
    would make it up, and none to spare reads 1."""
    shape = (16, 16, 16)
    served = np.zeros(shape, np.uint8)
    served[2:10, 2:10, 2:10] = 2                       # a kept tumour
    served[13, 13, 13] = 1                             # a measured speck
    seen = np.ones(shape, bool)
    tgap = np.full(shape, 0.5, np.float32)
    tgap[served > 0] = 0.0
    gap0 = np.where(tgap == 0.0, 0.5, 0.0).astype(np.float32)
    etgap = np.full(shape, 0.5, np.float32)
    kept = lambda lab, sn=seen: segment.kept_gap(lab, sn, tgap, gap0, etgap, 16, 32)
    assert kept(served)["small_gap"] == 1.0
    cleared = served.copy()
    cleared[13, 13, 13] = 0
    assert kept(cleared)["small_gap"] == 0.0
    hidden = seen.copy()
    hidden[14:, 14:, 14:] = False                       # beyond the brain box
    tgap[14, 14, 14] = 0.0                              # tumour there
    assert kept(served, hidden)["small_gap"] == 0.0
    et = cleared.copy()
    et[3, 3, 3:6] = 3                                   # 3 ET voxels of 32
    etgap[~hidden] = 0.2
    assert kept(et, hidden)["et_gap"] == 1.0            # 8 unseen voxels: too few
    hidden[10:, 10:, 10:] = False
    etgap[~hidden] = np.linspace(0.01, 0.3, int((~hidden).sum()))
    assert 0.01 < kept(et, hidden)["et_gap"] < 0.3


@pytest.mark.parametrize("tie", [0.01, 0.3])
def test_kept_gap_counts_the_pieces_near_ties_can_cut(tie):
    """A speck whose root is the largest served is kept unmeasured only if
    128 components with larger roots were cleared. Where those could lie is
    one blob of the reference's tumour: sure voxels on a lattice, with ties
    of tumour and background to within ``tie`` between them. Taking the
    ties as background cuts the blob into enough pieces, at that gap; where
    no voxel may be cut, it stays one piece and the speck reads 1."""
    shape = (24, 24, 24)
    served = np.zeros(shape, np.uint8)
    served[1, 1, 1] = 1
    seen = np.ones(shape, bool)
    seen[4:20] = False                                  # the blob is not served
    tgap = np.full(shape, 0.5, np.float32)
    gap0 = np.zeros(shape, np.float32)
    tgap[4:20], gap0[4:20] = 0.0, tie
    gap0[4:20:2, ::2, ::2] = 0.9                        # 8 x 12 x 12 sure voxels
    etgap = np.full(shape, 0.5, np.float32)
    got = segment.kept_gap(served, seen, tgap, gap0, etgap, 16, 32)
    assert got["measured_small"] == 1
    assert got["small_gap"] == pytest.approx(tie)
    gap0[4:20] = 0.9                                    # no voxel of it may be cut
    assert segment.kept_gap(served, seen, tgap, gap0, etgap, 16, 32)["small_gap"] == 1.0


def test_tiny_cell_on_the_card(card, tmp_path):
    """The CPU-cut cohort cell through the card's kernels."""
    root = make_root(tmp_path / "checkout")
    out = io.StringIO()
    assert harness.run(root, "single_chip.cohort", 5, 0.5, False, time.perf_counter(),
                       out=out) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["device"]["platform"] == "gpu" and res["correct"] is True


def test_control_reads_apart_from_the_program():
    """The control (the reference with fp8 operands in the program's place)
    at a size a test holds, on the flagship preset's path (coarse net, ROI,
    fine net): on every seed it reads above three times what
    the program reads on any: the labels' gap, and the steps' loss gap (at
    8 to 16 features, where the tiny net's losses stop reading alike)."""
    import dataclasses as dc

    cfg = _tiny_config(f32=False, preset="cascade")
    e = cfg["experiment"]
    exp = harness.experiment(cfg)
    program, control = [], []
    for seed in (1, 2, 3):
        ctx = drivers.Context(exp=exp, config=e, mix={
            "volumes": 2, "shape": [36, 36, 28], "warmup_calls": 1, "check_volumes": 2,
            "batch_per_device": 4, "pool_cases": 2, "raw_shape": [36, 36, 28],
            "checked_steps": 3}, seed=seed, seconds=0, traced=False,
            device=torch.device("cpu"), t0=0.0)
        pred, keeper, vols, fine, coarse = PREDICT.setup(ctx)
        sample = PREDICT._Sample(2, seed, 0)
        sample.offer(pred.predict_arrays_many(vols), keeper.taken)
        program += [r["gap"] for r in PREDICT.judge(ctx, sample, vols, fine, coarse)]
        ref = segment.Segmenter(e, fine, coarse, "cpu")
        ctl = segment.Segmenter(e, fine, coarse, "cpu", quant=ref_unet.Quant())
        control += [segment.judge_control(ref, ctl, v)["gap"] for v in vols]
    assert min(control) > 3 * max(program), (program, control)
    e["unet"].update(base_features=8, max_features=16)
    losses = []
    for seed in (1, 2, 3):
        ctx = dc.replace(ctx, seed=seed, exp=harness.experiment(cfg))
        step, pool, p0, tdict, got = TRAIN.setup(ctx)
        ref = ref_train.run_steps(p0, e["unet"], tdict, pool, seed, device="cpu")
        ctl = ref_train.run_steps(p0, e["unet"], tdict, pool, seed, device="cpu",
                                  quant=ref_unet.Quant())
        losses.append((ref_train.compare(got, ref)["loss_gap"],
                       ref_train.compare(ctl, ref)["loss_gap"]))
    assert min(c for _, c in losses) > 3 * max(p for p, _ in losses), losses
