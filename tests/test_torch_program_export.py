"""PyTorch port: the program export (``infer/export_hlo.py``: ``torch.export``
programs over the ``brats_torch::`` kernel operators) and
``predict_program_flops``, against the JAX package's StableHLO export
(``tests/test_export_hlo.py``'s tiny config and cases) on the CPU.

Weights come from the JAX init through ``export_params`` (the weight bridge).
The exported programs must give the port's eager labels bitwise, and the JAX
package's live and exported labels except on numerical ties of its mean
probabilities (top-2 gap < TIE)."""

import collections
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.configs import presets as jax_presets
from brats2019_tpu.data.synthetic import make_case_arrays
from brats2019_tpu.infer.export_hlo import export_predict_stablehlo
from brats2019_tpu.infer.export_hlo import run_exported as jax_run_exported
from brats2019_tpu.infer.predictor import Predictor as JaxPredictor
from brats2019_tpu.models import UNet3D as JaxUNet3D
from brats2019_tpu.train.checkpoint import export_params
from brats2019_tpu.utils import flops as jax_flops
from brats2019_tpu_torch import ops
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.infer import export_hlo
from brats2019_tpu_torch.infer.predictor import Predictor
from brats2019_tpu_torch.ops import connected_components as cc
from brats2019_tpu_torch.utils import flops
from brats2019_tpu_torch.utils.weights import flat_from_state_dict, load_params_npz

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIE = 1e-5
UNET_KW = dict(levels=2, base_features=4, max_features=8, compute_dtype="float32")
INFER_KW = dict(
    canvas=None, tile=(16, 16, 16), cascade=True, tta_flips=True,
    coarse_shape=(16, 16, 16), roi_shape=(16, 16, 16),  # one origin: split
    min_component_voxels=0, et_min_voxels=0, compute_dtype="float32",
    tta_precision="float32",
)
MONO = dict(cascade=False, tile=(32, 32, 16), overlap=0.0)   # two tiles


def _exp(mod, **infer):
    return mod.ExperimentConfig(
        name="hlo", unet=mod.UNetConfig(**UNET_KW),
        coarse_unet=mod.UNetConfig(**UNET_KW),
        train=mod.TrainConfig(pool_shape=(32, 32, 32)),
        infer=mod.InferenceConfig(**{**INFER_KW, **infer}),
    )


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    """{seed: (JAX params, the same as the port's flat dict)}."""
    d = tmp_path_factory.mktemp("hlo_params")
    out = {}
    for seed in (0, 1):
        jp = JaxUNet3D(jax_presets.UNetConfig(**UNET_KW)).init(
            jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 16, 4)))
        path = str(d / f"p{seed}.npz")
        export_params(path, jp)
        out[seed] = (jp, load_params_npz(path))
    return out


def _image(seed=2):
    return make_case_arrays(seed=seed, shape=(32, 32, 32))[0].astype(np.float32)


def _port_labels(pred, image):
    t = torch.from_numpy(image).to(torch.bfloat16)
    labels, start = pred.predict_device(t)
    return labels.numpy(), start.numpy(), t


def _assert_equal_but_ties(got, want, probs):
    diff = np.asarray(got) != np.asarray(want)
    top2 = np.sort(np.asarray(probs), axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) < TIE
    assert not (diff & ~tie).any(), int((diff & ~tie).sum())


def _op_counts(out_dir, name):
    ep = torch.export.load(os.path.join(out_dir, name))
    return collections.Counter(
        str(n.target) for n in ep.graph.nodes if n.op == "call_function"), ep


def test_split_path_export_roundtrip(tmp_path, params):
    """stage_roi.pt2 + stage_fine.pt2 + manifest; check=True asserts the
    loaded programs' labels and start equal the eager program's on the
    linspace canvas; on a case the exported labels equal the port's eager
    labels bitwise and the JAX package's live and StableHLO labels except on
    ties."""
    (jf, pf), (jc, pc) = params[0], params[1]
    pred = Predictor(_exp(presets), pf, pc, device="cpu")
    out = str(tmp_path / "torch_export")
    written = export_hlo.export_predict_program(pred, out, check=True)
    assert {os.path.basename(w) for w in written} == {
        "stage_roi.pt2", "stage_fine.pt2", "manifest.json"}
    man = json.load(open(os.path.join(out, "manifest.json")))
    assert man["checked"] and set(man["modules"]) == {"stage_roi", "stage_fine"}
    assert (man["device"], man["backend"], man["postproc"]) == ("cpu", "direct",
                                                                "host")
    assert man["torch_version"] == torch.__version__ and man["canvas"] == [32] * 3
    assert (man["card"], man["sm_count"]) == (None, 132)   # the H100's plans
    roi_sig = man["modules"]["stage_roi"]["inputs_flat"]
    assert roi_sig[-1] == {"name": "image", "shape": [32, 32, 32, 4],
                           "dtype": "bfloat16"}
    assert [s["name"] for s in roi_sig[:-1]] == [
        f"params_coarse/{k}" for k in sorted(pc)]
    assert [s["name"] for s in man["modules"]["stage_fine"]["inputs_flat"]][-2:] \
        == ["tiles", "start"]

    image = _image()
    live_t, start_t, image_t = _port_labels(pred, image)
    got, got_start = export_hlo.run_exported(out, pf, pc, image_t)
    np.testing.assert_array_equal(got.numpy(), live_t)
    np.testing.assert_array_equal(got_start.numpy(), start_t)

    jpred = JaxPredictor(_exp(jax_presets), jf, jc)
    jout = str(tmp_path / "stablehlo")
    export_predict_stablehlo(jpred, jout)
    image_j = jnp.asarray(image, jnp.bfloat16)
    live_j = jpred._fn(jf, jc, image_j)
    exp_j = jax_run_exported(jout, jf, jc, image_j)
    probs_j, _ = jpred._fn.probs_fn(jf, jc, image_j)
    for labels_j, s_j in (live_j, exp_j):
        np.testing.assert_array_equal(got_start.numpy(), np.asarray(s_j))
        _assert_equal_but_ties(got.numpy(), labels_j, probs_j)


def test_monolithic_export_roundtrip(tmp_path, params):
    """predict.pt2 (the monolithic program: no cascade, TTA over a sweep of
    two tiles; the reference's 16^3 tiles at an overlap of 0.5 give 27,
    which only lengthen the trace)."""
    (jf, pf) = params[0]
    pred = Predictor(_exp(presets, **MONO), pf, device="cpu")
    out = str(tmp_path / "torch_export")
    export_hlo.export_predict_program(pred, out, check=True)
    assert os.path.exists(os.path.join(out, "predict.pt2"))
    man = json.load(open(os.path.join(out, "manifest.json")))
    assert list(man["modules"]) == ["predict"] and man["checked"]
    names = [s["name"] for s in man["modules"]["predict"]["inputs_flat"]]
    assert names[-1] == "image" and all(n.startswith("params_fine/")
                                         for n in names[:-1])
    image = _image(3)
    live_t, start_t, image_t = _port_labels(pred, image)
    got, got_start = export_hlo.run_exported(out, pf, None, image_t)
    np.testing.assert_array_equal(got.numpy(), live_t)
    assert not got_start.any()
    jpred = JaxPredictor(_exp(jax_presets, **MONO), jf)
    image_j = jnp.asarray(image, jnp.bfloat16)
    labels_j, _ = jpred._fn(jf, None, image_j)
    probs_j, _ = jpred._fn.probs_fn(jf, None, image_j)
    _assert_equal_but_ties(got.numpy(), labels_j, probs_j)


def test_flagship_scale_export(tmp_path):
    """The flagship preset exports at its real shapes (tracing only: the
    kernels' fake implementations give the shapes); the weights stay inputs,
    so zero weights suffice and the programs stay small."""
    from brats2019_tpu_torch.models.unet3d import UNet3D

    exp = presets.get_preset("inference")
    zeros = lambda cfg: flat_from_state_dict(UNet3D(cfg).state_dict())
    pred = Predictor(exp, zeros(exp.unet), zeros(exp.coarse_unet), device="cpu")
    out = str(tmp_path / "torch_export")
    export_hlo.export_predict_program(pred, out)   # no check: it would run it
    man = json.load(open(os.path.join(out, "manifest.json")))
    assert set(man["modules"]) == {"stage_roi", "stage_fine"} and not man["checked"]
    roi_sig = man["modules"]["stage_roi"]["inputs_flat"]
    assert any(s["shape"] == [192, 224, 160, 4] and s["dtype"] == "bfloat16"
               for s in roi_sig)
    fine_sig = man["modules"]["stage_fine"]["inputs_flat"]
    assert fine_sig[-2]["shape"] == [8, 128, 128, 128, 4]
    weight_bytes = 4 * sum(np.prod(s["shape"]) for s in fine_sig[:-2])
    assert man["modules"]["stage_fine"]["bytes"] < weight_bytes / 4


def test_reexport_cleans_stale_modules(tmp_path, params):
    """A cascade -> no-cascade flip into the same directory leaves no stage
    program behind (run_exported dispatches on file existence)."""
    pf, pc = params[0][1], params[1][1]
    out = str(tmp_path / "torch_export")
    export_hlo.export_predict_program(
        Predictor(_exp(presets), pf, pc, device="cpu"), out)
    assert os.path.exists(os.path.join(out, "stage_roi.pt2"))
    export_hlo.export_predict_program(
        Predictor(_exp(presets, **MONO), pf, device="cpu"), out)
    assert sorted(os.listdir(out)) == ["manifest.json", "predict.pt2"]


def test_exported_program_refuses_another_sm_count(tmp_path, params):
    """The conv partials' shapes in a program follow the SM count its plans
    assumed, so a program whose manifest names another count (an H100 PCIe's
    114 SMs) refuses to run rather than mis-size them."""
    pf = params[0][1]
    out = str(tmp_path / "torch_export")
    export_hlo.export_predict_program(
        Predictor(_exp(presets, **MONO), pf, device="cpu"), out)
    path = os.path.join(out, "manifest.json")
    man = json.load(open(path))
    json.dump({**man, "sm_count": 114}, open(path, "w"))
    with pytest.raises(RuntimeError, match="export the program again"):
        export_hlo.run_exported(out, pf, None, torch.from_numpy(
            _image(3)).to(torch.bfloat16))


@pytest.mark.parametrize("backend", ["direct", "winograd"])
def test_graph_holds_a_kernel_op_per_call_and_no_weights(tmp_path, params,
                                                         backend):
    """Each program's graph holds one brats_torch:: node per conv, IN+act,
    up (into its concat) and down of its net, and no aten convolution; the
    conv is the direct STATS op (the f32 instance has the epilogue, so every
    IN takes partials) or the Winograd op, the backend set at export. No
    input is a parameter or a buffer."""
    pf, pc = params[0][1], params[1][1]
    out = str(tmp_path / "torch_export")
    ops.set_backend(backend)
    try:
        export_hlo.export_predict_program(
            Predictor(_exp(presets), pf, pc, device="cpu"), out)
    finally:
        ops.set_backend("direct")
    assert json.load(open(os.path.join(out, "manifest.json")))["backend"] == backend
    lv = UNET_KW["levels"]
    n_conv = 2 * (2 * lv - 1)
    conv = ("brats_torch.conv3d_stats.default" if backend == "direct"
            else "brats_torch.conv3d_winograd.default")
    for name in ("stage_roi.pt2", "stage_fine.pt2"):
        counts, ep = _op_counts(out, name)
        mine = {k: v for k, v in counts.items() if k.startswith("brats_torch.")}
        assert mine == {conv: n_conv,
                        "brats_torch.instance_norm_act.default": n_conv,
                        "brats_torch.downsample2x.default": lv - 1,
                        "brats_torch.upsample2x_concat.default": lv - 1}, mine
        assert not [k for k in counts if "convolution" in k], counts
        kinds = {s.kind.name for s in ep.graph_signature.input_specs}
        assert not kinds & {"PARAMETER", "BUFFER"}, kinds


# the monolithic program with a coarse ROI of two tiles: it reads all three
# cached device constants
ORDER_INFER = dict(roi_shape=(32, 16, 16), overlap=0.0)

_ORDER_SCRIPT = """
import json, sys
import torch
torch.set_num_threads(1)
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.infer import export_hlo
from brats2019_tpu_torch.infer.predictor import Predictor
from brats2019_tpu_torch.utils.weights import init_params

order, out = sys.argv[1], sys.argv[2]
u = presets.UNetConfig(**{unet})
exp = presets.ExperimentConfig(
    name="hlo", unet=u, coarse_unet=u,
    train=presets.TrainConfig(pool_shape=(32, 32, 32)),
    infer=presets.InferenceConfig(**{{**{infer}, **{order_infer}}}))
pf, pc = init_params(u, 0), init_params(u, 1)
pred = Predictor(exp, pf, pc, device="cpu")
assert type(pred.program).__name__ == "Monolithic"
image = export_hlo.linspace_canvas(pred.canvas, "cpu")
steps = ("export", "eager") if order == "export_first" else ("eager", "export")
for step in steps:
    if step == "export":
        export_hlo.export_predict_program(pred, out)
    else:
        eager = pred.predict_device(image)[0]
exported = export_hlo.run_exported(out, pf, pc, image)[0]
print(json.dumps([eager.flatten().tolist(), exported.flatten().tolist()]))
"""


def test_device_constants_in_either_order(tmp_path):
    """Export before the first eager call and after it, each in a fresh
    process: the cached device constants (the coarse grid's scale, the
    resize matrices, the sweep's blend weight) never hold a traced tensor,
    so the eager labels and the exported labels agree in both orders."""
    script = _ORDER_SCRIPT.format(unet=UNET_KW, infer=INFER_KW,
                                  order_infer=ORDER_INFER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = {order: subprocess.Popen(
        [sys.executable, "-c", script, order, str(tmp_path / order)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for order in ("export_first", "eager_first")}
    got = {}
    for order, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        got[order] = json.loads(out.strip().splitlines()[-1])
    eager_a, exported_a = got["export_first"]
    eager_b, exported_b = got["eager_first"]
    assert eager_a == exported_a == eager_b == exported_b


def test_device_const_caches_eagerly_and_builds_fresh_when_traced():
    """``ops.library.device_const``: an eager call builds once and keeps a
    tensor that is not an inference tensor, even under inference mode; a
    traced call builds its own and leaves the cache as it was."""
    from brats2019_tpu_torch.ops.library import device_const

    cache, built = {}, []

    def build():
        built.append(1)
        return torch.arange(3.0)

    with torch.inference_mode():
        first = device_const(cache, "eager", build)
    assert not first.is_inference()
    assert device_const(cache, "eager", build) is first and len(built) == 1

    class Add(torch.nn.Module):
        def forward(self, x):
            return x + device_const(cache, "traced", build)

    with torch.no_grad():
        ep = torch.export.export(Add(), (torch.zeros(3),), strict=False)
    assert set(cache) == {"eager"} and len(built) == 2
    assert torch.equal(ep.module()(torch.ones(3)), torch.arange(3.0) + 1)


class _Post(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, labels):
        return self.fn(labels)


def _crafted_labels():
    """(20, 20, 20) labels: 150 isolated single voxels (more than the 128
    components ``component_sizes`` measures), a 4^3 NCR block with 5 ET
    voxels in it (0 < n_ET < et_min_voxels), a 3^3 edema block."""
    lab = np.zeros((20, 20, 20), np.uint8)
    pts = [(x, y, z) for x in range(0, 20, 2) for y in range(0, 8, 2)
           for z in range(0, 20, 2)][:150]
    for i, p in enumerate(pts):
        lab[p] = 2 if i % 3 else 1
    lab[12:16, 12:16, 12:16] = 1
    lab[13, 13, 13:18] = 3
    lab[10:13, 2:5, 2:5] = 2
    return torch.from_numpy(lab)


def _serpentine():
    """A one-voxel-wide snake of 49 voxels in a (9, 9, 3) mask: five rows
    along the first axis joined at alternate ends, so its far end needs more
    pool iterations than a small cap gives (phase 2 runs)."""
    fg = np.zeros((9, 9, 3), bool)
    for y in range(0, 9, 2):
        fg[:, y, 1] = True
        if y + 2 < 9:
            fg[8 if (y // 2) % 2 == 0 else 0, y + 1, 1] = True
    return torch.from_numpy(fg)


@pytest.mark.parametrize("case", ["postprocess", "serpentine", "program"])
def test_device_postprocessing_exports_bitwise(tmp_path, params, case):
    """The connected components, traced, are one
    ``brats_torch::label_components`` node, and the exported program gives
    eager ``postprocess_device``'s labels bitwise: on crafted labels with more
    components than are measured and a tiny ET; on a serpentine mask with a
    small pool cap and a cap that is no multiple of check_every (phase 1's
    remainder, then phase 2: the node keeps the caps); and through the split
    cascade with ``postproc="device"`` (check=True: the program's labels and
    start)."""
    if case == "program":
        pf, pc = params[0][1], params[1][1]
        pred = Predictor(_exp(presets, postproc="device",
                              min_component_voxels=20, et_min_voxels=50),
                         pf, pc, device="cpu")
        out = str(tmp_path / "torch_export")
        export_hlo.export_predict_program(pred, out, check=True)
        counts, _ = _op_counts(out, "stage_fine.pt2")
        assert counts["brats_torch.label_components.default"] == 1, counts
        return
    if case == "postprocess":
        fn = lambda lab: cc.postprocess_device(lab, 3, 10)
        x = _crafted_labels()
        want = fn(x)
        assert (cc.component_sizes(cc.label_components(x > 0)) == cc.BIG).any()
        assert 0 < int((x == 3).sum()) < 10 and not (want == 3).any()
    else:
        fn = lambda fg: cc.label_components(fg, max_pool_iters=10,
                                            max_jump_rounds=16, check_every=4)
        x = _serpentine()
        want = fn(x)
        full = cc.label_components(x, max_pool_iters=10 ** 4, check_every=1)
        np.testing.assert_array_equal(want.numpy(), full.numpy())
    with torch.no_grad():
        ep = torch.export.export(_Post(fn), (x,), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("brats_torch.label_components.default") == 1, targets
    assert not any("while_loop" in t for t in targets), targets
    path = str(tmp_path / "post.pt2")
    torch.export.save(ep, path)
    got = torch.export.load(path).module()(x)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_predict_program_flops_matches_reference(name):
    """The same arithmetic as the JAX package's, at the canvas the preset's
    Predictor uses."""
    exp = presets.get_preset(name)
    canvas = tuple(exp.infer.canvas or exp.train.pool_shape)
    want = jax_flops.predict_program_flops(jax_presets.get_preset(name), canvas)
    assert flops.predict_program_flops(exp, canvas) == want > 0


def test_flops_of_a_program_without_cascade_or_tta():
    exp = dataclasses.replace(
        presets.get_preset("cascade"),
        infer=dataclasses.replace(presets.get_preset("cascade").infer,
                                  cascade=False, tta_flips=False))
    canvas = (192, 224, 160)
    want = jax_flops.predict_program_flops(dataclasses.replace(
        jax_presets.get_preset("cascade"),
        infer=dataclasses.replace(jax_presets.get_preset("cascade").infer,
                                  cascade=False, tta_flips=False)), canvas)
    assert flops.predict_program_flops(exp, canvas) == want
