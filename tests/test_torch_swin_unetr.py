"""PyTorch port: the Swin UNETR (``models/swin_unetr.py``) and its window
attention (``ops/window_attention.py``) on the CPU, against the benchmark's
plain f32 reference (``perfbench/reference/swin_unetr.py``) and brute-force
builds, at a small size: 32^3 tiles, feature size 24, heads (3, 6, 12, 24)
(head dim 8), window 7. The stages then run at 16^3 (padded to 21^3), 8^3
(padded to 14^3), 4^3 and 2^3 (windows clamped to the axis, no shift).
Also the cell ``swin_unetr.cohort`` cut to that size through the harness,
the FLOP count, the roofline reader, the spans and counters, and the paths
that refuse a Swin UNETR."""

import io
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from brats2019_tpu_torch import ops
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.configs.swin_unetr import SwinUNETRConfig
from brats2019_tpu_torch.infer.predictor import Predictor
from brats2019_tpu_torch.models.swin_unetr import SwinUNETR
from brats2019_tpu_torch.ops.window_attention import (padded, relative_index,
                                                      shift_mask, window_and_shift,
                                                      window_attention_plain)
from brats2019_tpu_torch.utils import profile, weights
from perfbench import drivers, harness, synth, trace, yardstick
from perfbench.reference import segment
from perfbench.reference import swin_unetr as ref

REPO = Path(__file__).resolve().parent.parent
CELL = "swin_unetr.cohort"
WA = sys.modules["brats2019_tpu_torch.ops.window_attention"]
SMALL = dict(feature_size=24, compute_dtype="float32")
TILE = [32, 32, 32]
# the f32 program against the f32 reference: the same operations in another
# order (linears for the patch embed and the transposed convs, the IN from
# the conv's partials, attention per block of windows), so a few f32
# roundings apart; 1e-4 of the logits' largest magnitude holds them with
# 20x room (5-6e-6 of ~4.8 measured) and is ~100x below what a dropped
# shift mask or a transposed bias index move (0.25, 0.035)
REL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config() -> dict:
    """The cell's configuration file cut to the test size (f32)."""
    cfg = json.loads((REPO / "perfbench/configs/swin_unetr.json").read_text())
    e = cfg["experiment"]
    e["unet"].update(SMALL)
    e["infer"].update(canvas=TILE, tile=TILE, tta_precision="float32",
                      compute_dtype="float32", min_component_voxels=4, et_min_voxels=2)
    return cfg


@pytest.fixture(scope="module")
def small():
    """(the file's experiment, the program's config, flat weights, the
    program, f32 tensors of the weights)."""
    cfg = _config()
    e = cfg["experiment"]
    flat = drivers.flat_params(e, 5, "cpu")
    net = harness.experiment(cfg).unet
    model = weights.build_network(net, flat, "cpu")
    return e, net, flat, model, {k: torch.from_numpy(v) for k, v in flat.items()}


# ------------------------------------------------------------ the operator --

def _brute_rel(window, wc):
    wd, wh, ww = window
    coords = [(a, b, c) for a in range(wd) for b in range(wh) for c in range(ww)]
    r = 2 * wc - 1
    return torch.tensor([[((i[0] - j[0] + wc - 1) * r + i[1] - j[1] + wc - 1) * r
                          + i[2] - j[2] + wc - 1 for j in coords] for i in coords])


def _brute_mask(grid, window, shift):
    """Per window of the rolled, padded grid: -100 where two tokens lie in
    different regions ([0, P - w), [P - w, P - s), [P - s, P)) along an axis."""
    def region(p, P, w, s):
        return 0 if p < P - w else (1 if s == 0 or p < P - s else 2)

    nwin = [g // w for g, w in zip(grid, window)]
    out = []
    for wi in np.ndindex(*nwin):
        toks = [tuple(o * w + t for o, w, t in zip(wi, window, tt))
                for tt in np.ndindex(*window)]
        reg = [tuple(region(p, P, w, s) for p, P, w, s in zip(tok, grid, window, shift))
               for tok in toks]
        out.append([[0.0 if a == b else -100.0 for b in reg] for a in reg])
    return torch.tensor(out)


@pytest.mark.parametrize("window,wc", [((7, 7, 7), 7), ((4, 4, 4), 7), ((2, 2, 2), 7),
                                       ((3, 2, 4), 5)])
def test_relative_index_is_the_brute_force_and_monai_construction(window, wc):
    assert torch.equal(relative_index(window, wc), _brute_rel(window, wc))
    assert torch.equal(relative_index(window, wc), ref.relative_position_index(window, wc))


@pytest.mark.parametrize("dims,window,shift", [
    ((16, 16, 16), 7, 3), ((8, 8, 8), 7, 3), ((16, 8, 4), 7, 3), ((9, 10, 11), 7, 3),
    ((4, 4, 4), 7, 3)])
def test_shift_mask_is_the_brute_force_and_monai_construction(dims, window, shift):
    ws, ss = window_and_shift(dims, window, shift)
    grid = padded(dims, ws)
    got = shift_mask(grid, ws, ss)
    if not any(ss):
        assert got is None
        return
    assert torch.equal(got, _brute_mask(grid, ws, ss))
    assert torch.equal(got, ref.compute_mask(grid, ws, ss, "cpu"))


def _naive(qkv, table, dims, window, shift, scale):
    """Window by window and head by head, B and M from the brute force."""
    ws, ss = window_and_shift(dims, window, shift)
    grid = padded(dims, ws)
    heads = table.shape[1]
    nw, t, c3 = qkv.shape
    hd = c3 // 3 // heads
    rel = _brute_rel(ws, window)
    mask = _brute_mask(grid, ws, ss) if any(ss) else torch.zeros(nw, t, t)
    out = torch.zeros(nw, t, c3 // 3)
    for w in range(nw):
        for h in range(heads):
            q, k, v = (qkv[w, :, i * heads * hd + h * hd:i * heads * hd + (h + 1) * hd]
                       for i in range(3))
            s = q @ k.T * scale + table[rel, h] + mask[w % mask.shape[0]]
            out[w, :, h * hd:(h + 1) * hd] = torch.softmax(s, -1) @ v
    return out, ws, ss


@pytest.mark.parametrize("dims,shift", [((9, 10, 8), 0), ((9, 10, 8), 3), ((7, 7, 7), 3),
                                        ((16, 4, 8), 3), ((3, 5, 2), 3)])
def test_plain_operator_equals_a_naive_loop(dims, shift):
    g = torch.Generator().manual_seed(sum(dims) + shift)
    heads, hd, n = 2, 8, 2
    ws, ss = window_and_shift(dims, 7, shift)
    nw = n * math.prod(p // w for p, w in zip(padded(dims, ws), ws))
    qkv = torch.randn(nw, math.prod(ws), 3 * heads * hd, generator=g)
    table = torch.randn(13 ** 3, heads, generator=g)
    want, ws, ss = _naive(qkv, table, dims, 7, shift, hd ** -0.5)
    ops.reset_launch_counts()
    got = ops.window_attention(qkv, table, dims, ws, ss, hd ** -0.5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert ops.launch_counts()["window_attention"] == 1
    assert ops.window_attention.tokens == qkv.shape[0] * qkv.shape[1]
    assert ops.window_attention.padded_tokens == qkv.shape[0] * qkv.shape[1] - n * math.prod(dims)


def test_plain_operator_blocks_alike_and_keeps_the_dtype(monkeypatch):
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(16, 343, 3 * 3 * 16, generator=g)
    table = torch.randn(13 ** 3, 3, generator=g)
    args = ((14, 14, 14), (7, 7, 7), (3, 3, 3), 0.25)
    whole = window_attention_plain(qkv, table, *args)
    monkeypatch.setattr(WA, "PLAIN_SCORES", 3 * 343 * 343 * 3)   # blocks of 3 windows
    torch.testing.assert_close(window_attention_plain(qkv, table, *args), whole,
                               rtol=1e-6, atol=1e-6)
    assert window_attention_plain(qkv.bfloat16(), table, *args).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="do not fit"):
        window_attention_plain(qkv[:15], table, *args)


def test_the_operator_traces_to_one_node():
    qkv = torch.randn(8, 343, 3 * 48)
    table = torch.randn(13 ** 3, 3)

    class M(torch.nn.Module):
        def forward(self, qkv, table):
            return torch.ops.brats_torch.window_attention(qkv, table, [14, 14, 14],
                                                          [7, 7, 7], [3, 3, 3], 0.25)

    prog = torch.export.export(M(), (qkv, table))
    calls = [n for n in prog.graph.nodes if "window_attention" in str(n.target)]
    assert len(calls) == 1
    torch.testing.assert_close(prog.module()(qkv, table),
                               window_attention_plain(qkv, table, (14, 14, 14), (7, 7, 7),
                                                      (3, 3, 3), 0.25))


# ---------------------------------------------------------------- the model --

def test_program_equals_the_reference_in_f32(small):
    e, _, _, model, params = small
    x = torch.randn(2, *TILE, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model(x)
        want = ref.forward(params, e["unet"], x)
    assert got.dtype == torch.float32 and got.shape == (2, *TILE, 4)
    err = (got - want).abs().max().item()
    assert err <= REL_TOL * want.abs().max().item(), err


def _drop_mask(monkeypatch):
    monkeypatch.setattr(WA, "shift_mask", lambda *a: None)


def _transpose_bias(monkeypatch):
    real = WA.relative_index
    monkeypatch.setattr(WA, "relative_index", lambda w, wc: real(w, wc).t())


@pytest.mark.parametrize("fault", [_drop_mask, _transpose_bias])
def test_the_comparison_sees_a_fault(small, monkeypatch, fault):
    """The tolerance of :func:`test_program_equals_the_reference_in_f32` is
    far below what a dropped shift mask or a transposed bias index moves."""
    e, _, _, model, params = small
    x = torch.randn(1, *TILE, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ref.forward(params, e["unet"], x)
        fault(monkeypatch)
        err = (model(x) - want).abs().max().item()
    assert err > 10 * REL_TOL * want.abs().max().item(), err


def test_bf16_program_stays_near_the_reference(small):
    e, net, flat, _, params = small
    import dataclasses as dc

    model = weights.build_network(dc.replace(net, compute_dtype="bfloat16"), flat, "cpu")
    x = torch.randn(1, *TILE, 4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got, want = model(x), ref.forward(params, e["unet"], x)
    assert got.dtype == torch.float32
    # bf16 operands (8 bits of mantissa) through ~30 layers
    assert (got - want).abs().max().item() < 0.1 * want.abs().max().item()


def test_the_file_builds_the_config_and_its_weights_load_strictly(small):
    cfg = json.loads((REPO / "perfbench/configs/swin_unetr.json").read_text())
    exp = harness.experiment(cfg)
    assert type(exp.unet) is SwinUNETRConfig and exp.unet == SwinUNETRConfig()
    assert exp.unet.stem_downsample == 1 and exp.unet.dtype == torch.bfloat16
    assert exp.infer.postproc == "device" and exp.coarse_unet is None
    e, net, flat, model, _ = small
    assert set(flat) == {"params/" + k.replace(".", "/") for k in model.state_dict()}
    assert list(flat) == list(ref.param_shapes(e["unet"]))
    full = ref.param_shapes(cfg["experiment"]["unet"])
    assert sum(math.prod(s) for s in full.values()) == sum(
        p.numel() for p in SwinUNETR(SwinUNETRConfig()).parameters())
    with pytest.raises(RuntimeError, match="Missing key"):
        weights.build_network(net, {k: v for k, v in flat.items()
                                    if not k.endswith("qkv/bias")}, "cpu")


def test_program_flops_count_what_the_flop_counter_counts(small):
    e, *_, params = small
    x = torch.randn(1, *TILE, 4)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.forward(params, e["unet"], x)
    assert ref.forward_flops(e["unet"], TILE) == fc.get_total_flops()
    exp = json.loads(json.dumps(e))
    exp["infer"].update(canvas=[64, 32, 40])
    tiles = yardstick._tiles(exp["infer"]["canvas"], TILE, 0.5)
    assert tiles == 6
    assert ref.program_flops(exp) == tiles * 8 * fc.get_total_flops()


def test_program_flops_at_the_published_size():
    cfg = json.loads((REPO / "perfbench/configs/swin_unetr.json").read_text())["experiment"]
    one = ref.forward_flops(cfg["unet"], [128] * 3)
    assert 1.5e12 < one < 1.6e12
    assert ref.program_flops(cfg) == 12 * 8 * one


# ------------------------------------------------------------- the program --

def _tiny_root(dst: Path) -> Path:
    """A checkout-like root with the benchmark's files, the Swin cell cut to
    the test size."""
    (dst / "perfbench").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for sub in ("metrics", "limits", "configs", "traffic"):
        shutil.copytree(REPO / "perfbench" / sub, dst / "perfbench" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "perfbench/configs/swin_unetr.json").write_text(json.dumps(_config()))
    mix = json.loads((dst / "perfbench/traffic/cohort.json").read_text())
    mix.update(volumes=1, shape=[36, 36, 28], check_volumes=1, trace_calls=1)
    (dst / "perfbench/traffic/cohort.json").write_text(json.dumps(mix))
    return dst


def _run(root, seed, traced, monkeypatch):
    """One run of the cell on the CPU; the forbidden imports it checks are
    those the run made (the suite's conftest has imported jax already)."""
    before = set(sys.modules)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: sorted(
        m for m in set(sys.modules) - before if m.split(".")[0] in harness.FORBIDDEN))
    out = io.StringIO()
    assert harness.run(root, CELL, seed, 0.1, traced, time.perf_counter(), device="cpu",
                       out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_runs_and_the_judge_passes_it(tmp_path, monkeypatch, traced):
    """``Predictor.predict_arrays_many`` through the cohort driver with the
    device postprocessing; the served labels judged under the cell's limit."""
    root = _tiny_root(tmp_path / "checkout")
    res = _run(root, 11, traced, monkeypatch)
    limit = json.loads((REPO / "perfbench/limits" / f"{CELL}.json").read_text())
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["gap"]["limit"] == limit["gap"]
    spec = harness.load_spec(root)
    kinds = spec["per_layer"] if traced else spec["end_to_end"]
    listed = {m["name"] for m in kinds if harness.reports(m, CELL, spec)}
    if traced:
        assert {"window_attn_roofline.predict", "swin_encoder_ms.predict"} <= listed
        assert {"host_prep_ms.predict", "program_ms.predict", "predict_mfu"} <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == listed == {"predict_vol_per_s", "setup_s"}


def test_spans_record_and_the_operator_counts_a_call_per_block(small):
    e, net, flat, *_ = small
    exp = harness.experiment(_config())
    pred = Predictor(exp, flat, device="cpu")
    vol = synth.volumes(1, (36, 36, 28), 3, "cpu")[0]
    ops.reset_launch_counts()
    profile.clear()
    with profile.recording():
        pred.predict_arrays(vol)
    names = [s.name for s in profile.snapshot()]
    profile.clear()
    assert names.count("swin.encoder") == names.count("swin.decoder") == 1
    assert ops.launch_counts()["window_attention"] == sum(net.depths)
    # tokens: the padded windows of 8 flips at each stage (16^3 -> 21^3, 8^3
    # -> 14^3, 4^3 and 2^3 whole), two blocks each
    grids = [(21, 16), (14, 8), (4, 4), (2, 2)]
    assert ops.window_attention.tokens == sum(2 * 8 * p ** 3 for p, _ in grids)
    assert ops.window_attention.padded_tokens == sum(2 * 8 * (p ** 3 - d ** 3)
                                                     for p, d in grids)


def test_reload_swaps_the_weights(small):
    e, net, flat, *_ = small
    exp = harness.experiment(_config())
    pred = Predictor(exp, flat, device="cpu")
    x = torch.zeros(tuple(TILE) + (4,))
    x[8:24, 8:24, 8:24] = torch.randn(16, 16, 16, 4, generator=torch.Generator().manual_seed(4))
    before = pred.probs_device(x)[0]
    pred.reload_params(drivers.flat_params(e, 6, "cpu"))
    after = pred.probs_device(x)[0]
    pred.reload_params(flat)
    again = pred.probs_device(x)[0]
    assert not torch.equal(before, after) and torch.equal(before, again)


# ------------------------------------------------------------- the readers --

def _reader(name):
    return harness.reader(REPO, name)


def test_window_attention_roofline_reader_is_a_hand_count():
    calls = [("brats_torch::window_attention", ((8000, 343, 144), (2197, 3), (), (), (), ()),
              2.0e-3),
             ("brats_torch::window_attention", ((8, 343, 2304), (2197, 24), (), (), (), ()),
              0.5e-3),
             ("brats_torch::conv3d", ((8, 128, 128, 128, 4), (3, 3, 3, 4, 48)), 9.0)]
    prof = trace.Profile(window_s=1.0, busy_s=0.9, device_ops=[], idle_gaps=[],
                         op_calls=calls)
    # stage 1: 8000 windows, 3 heads of 16; stage 4: 8 windows, 24 heads of 16
    b1 = 2 * 8000 * 343 * 144 + 4 * 2197 * 3 + 2 * 8000 * 343 * 48
    f1 = 4 * 8000 * 3 * 343 ** 2 * 16
    b4 = 2 * 8 * 343 * 2304 + 4 * 2197 * 24 + 2 * 8 * 343 * 768
    f4 = 4 * 8 * 24 * 343 ** 2 * 16
    want = 100 * (max(b1 / 3.35e12, f1 / 989e12) + max(b4 / 3.35e12, f4 / 989e12)) / 2.5e-3
    got = _reader("window_attn_roofline.predict")({"kind": "predict"}, prof)
    assert got == pytest.approx(want, rel=1e-12)
    assert b1 / 3.35e12 > f1 / 989e12                  # bytes bound stage 1
    nothing = trace.Profile(1.0, 0.9, [], [], calls[2:])
    assert _reader("window_attn_roofline.predict")({"kind": "predict"}, nothing) is None
    assert _reader("window_attn_roofline.predict")({"kind": "train"}, prof) is None


def test_swin_encoder_reader_divides_by_the_volumes(monkeypatch):
    import types

    read = _reader("swin_encoder_ms.predict")
    span = lambda name, ms: types.SimpleNamespace(name=name, device_ms=ms)
    spans = [span("predict.program", 1.0), span("swin.encoder", 3.0),
             span("predict.program", 1.0), span("swin.encoder", 5.0), span("swin.decoder", 9.0)]
    monkeypatch.setitem(read.__globals__, "_spans", lambda: spans)
    assert read({"kind": "predict"}, None) == 4.0
    monkeypatch.setitem(read.__globals__, "_spans", lambda: spans[:1])
    assert read({"kind": "predict"}, None) is None


# ------------------------------------------------------- what refuses Swin --

def _exp():
    return harness.experiment(_config())


def _multichip(exp, flat):
    from brats2019_tpu_torch.infer.multichip import MultichipPredictor

    MultichipPredictor(exp, flat, mode="sweep")


def _ensemble(exp, flat):
    from brats2019_tpu_torch.infer.ensemble import EnsemblePredictor

    EnsemblePredictor(exp, [(flat, None), (flat, None)], device="cpu")


def _training(exp, flat):
    from brats2019_tpu_torch.train.loop import stage_config

    stage_config(exp, "fine")


def _teachers(exp, flat):
    from brats2019_tpu_torch.train.distill import build_teachers

    build_teachers(exp.unet, [flat], "cpu")


def _init_params(exp, flat):
    weights.init_params(exp.unet, 0)


@pytest.mark.parametrize("path,what", [
    (_multichip, "the multichip predictor"), (_ensemble, "the ensemble"),
    (_training, "training"), (_teachers, "knowledge distillation"),
    (_init_params, "init_params")])
def test_unet_only_paths_refuse_a_swin_config_in_one_line(small, path, what):
    with pytest.raises(TypeError) as err:
        path(_exp(), small[2])
    msg = str(err.value)
    assert msg == f"{what} runs the U-Net only, not a SwinUNETRConfig"


def test_the_unet_still_builds_by_its_class():
    cfg = presets.UNetConfig(levels=2, base_features=4, max_features=8)
    flat = weights.init_params(cfg, 0)
    assert type(weights.build_network(cfg, flat, "cpu")).__name__ == "UNet3D"
    assert type(weights.build_unet(cfg, flat, "cpu")).__name__ == "UNet3D"


# ------------------------------------------------------------ the reference --

def test_reference_imports_neither_the_program_nor_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.swin_unetr\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'brats2019_tpu', 'brats2019_tpu_torch')))\n"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stderr[-2000:]


def test_reference_runs_without_tf32(small, monkeypatch):
    e, *_, params = small
    seen = []
    real = ref._forward

    def spy(*a):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return real(*a)

    monkeypatch.setattr(ref, "_forward", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    ref.forward(params, e["unet"], torch.zeros(1, *TILE, 4))
    assert seen == [(False, False)] and torch.backends.cudnn.allow_tf32
