"""PyTorch port: the ``serve`` daemon (``cli/serve.py``) and its HTTP API
on ``--device cpu`` with a tiny cascade preset: the behaviours
``tests/test_serve.py`` pins for the JAX daemon, and the port's daemon against
the JAX daemon on one synthetic case (same exported weights)."""

import ast
import inspect
import io
import json
import os
import shutil
import signal
import sys
import tarfile
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brats2019_tpu.cli import http_api as ref_http_api
from brats2019_tpu.cli import serve as jax_serve
from brats2019_tpu.configs import presets as jax_presets
from brats2019_tpu.data import synthetic
from brats2019_tpu.models.unet3d import UNet3D as JaxUNet3D
from brats2019_tpu.models.unet3d import UNetConfig as JaxUNetConfig
from brats2019_tpu.train.checkpoint import export_params
from brats2019_tpu.utils.nifti import read_nifti
from brats2019_tpu_torch.cli import common, http_api
from brats2019_tpu_torch.cli import serve as cli_serve
from brats2019_tpu_torch.configs import presets
from brats2019_tpu_torch.utils.weights import init_params, save_params_npz

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "accuracy",
                       "hard_member0.npz")
FINE_KW = dict(levels=2, base_features=8, compute_dtype="float32",
               stem_downsample=2)
COARSE_KW = dict(levels=2, base_features=8, compute_dtype="float32")
SHAPE = (48, 40, 36)
PRESET = "tiny_cascade"


def _exp(mod):
    return mod.ExperimentConfig(
        name=PRESET,
        unet=mod.UNetConfig(**FINE_KW),
        coarse_unet=mod.UNetConfig(**COARSE_KW),
        train=mod.TrainConfig(pool_shape=(64, 64, 48)),
        infer=mod.InferenceConfig(
            canvas=(64, 64, 48), tile=(32, 32, 32), roi_shape=(32, 32, 32),
            coarse_shape=(32, 32, 24), cascade=True, tta_flips=True,
            tta_precision="float32", compute_dtype="float32",
        ),
        workdir="unused",
    )


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """<workdir>/{fine,coarse}/params.npz written by the JAX exporter."""
    w = tmp_path_factory.mktemp("workdir")
    for stage in ("fine", "coarse"):
        os.makedirs(w / stage)
    pf = JaxUNet3D(JaxUNetConfig(**FINE_KW)).init(
        jax.random.PRNGKey(5), jnp.zeros((1, 16, 16, 16, 4)))
    export_params(str(w / "fine" / "params.npz"), pf)
    shutil.copy(FIXTURE, w / "coarse" / "params.npz")
    return str(w)


@pytest.fixture
def preset(monkeypatch):
    monkeypatch.setitem(presets.PRESETS, PRESET, _exp(presets))
    monkeypatch.setitem(jax_presets.PRESETS, PRESET, _exp(jax_presets))


@pytest.fixture
def keep_signal_handlers():
    """serve.main installs handlers and leaves them; put the old ones back."""
    sigs = (signal.SIGTERM, signal.SIGINT, signal.SIGHUP)
    old = {s: signal.getsignal(s) for s in sigs}
    yield
    for s, h in old.items():
        signal.signal(s, h)


def _args(watch, workdir, *extra):
    return [str(watch), "--preset", PRESET, "--workdir", workdir,
            "--device", "cpu", "--poll", "0.05", *extra]


def _log(path):
    with open(os.path.join(str(path), "serve_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _bare_server(retries=1):
    s = object.__new__(cli_serve.Server)
    s.retries, s.retry_backoff = retries, 0.0
    s.output_dir = None
    s._stop = False
    s.done = set()
    s.results, s.results_cv = {}, threading.Condition()
    s.counters = {"served": 0, "quarantined": 0, "prefilled": 0}
    return s


def _wait_for(cond, timeout=60.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


# ----------------------------------------------------------------- the pieces --

def test_case_ready_requires_stable_sizes(tmp_path):
    case = synthetic.write_case(str(tmp_path / "BraTS19_SYN_000_1"), seed=0,
                                shape=(16, 16, 16))
    sizes = {}
    assert not cli_serve._case_ready(case, sizes)      # first sight primes
    assert cli_serve._case_ready(case, sizes)
    t1 = os.path.join(case, os.path.basename(case) + "_t1.nii.gz")
    with open(t1, "ab") as f:
        f.write(b"x" * 10)                              # an upload in progress
    assert not cli_serve._case_ready(case, sizes)
    assert cli_serve._case_ready(case, sizes)
    os.remove(t1)
    assert not cli_serve._case_ready(case, sizes)


def test_stop_signal_flips_the_loop_condition():
    s = _bare_server()
    assert not s.stopping
    s.request_stop()
    assert s.stopping


def test_shard_assignment_matches_reference_and_partitions():
    from brats2019_tpu.cli import common as ref_common

    names = [f"BraTS19_X_{i:03d}_1" for i in range(40)]
    for n in (1, 2, 4):
        got = [common.shard_of(name, n) for name in names]
        assert got == [ref_common.shard_of(name, n) for name in names]
        assert set(got) <= set(range(n))
    assert common.parse_shard("1/4") == ref_common.parse_shard("1/4") == (1, 4)
    for bad in ("4/4", "a/b", "3", "-1/2"):
        with pytest.raises(ValueError):
            common.parse_shard(bad)


def test_shard_scan_is_disjoint_and_covering(tmp_path):
    dirs = synthetic.write_dataset(str(tmp_path), 6, shape=(16, 16, 16))
    seen = []
    for i in range(3):
        s = _bare_server()
        s.shard = (i, 3)
        sizes = {}
        s.scan(str(tmp_path), sizes)
        seen.append({os.path.basename(d) for d in s.scan(str(tmp_path), sizes)})
    assert set.union(*seen) == {os.path.basename(d) for d in dirs}
    assert sum(len(x) for x in seen) == 6


def test_classify_failure_by_type():
    cf = cli_serve.classify_failure
    assert cf(torch.cuda.OutOfMemoryError("CUDA out of memory")) == "transient"
    assert cf(ConnectionError("reset")) == "transient"
    assert cf(TimeoutError("slow")) == "transient"
    assert cf(ValueError("CUDA out of memory in a header")) == "permanent"
    assert cf(RuntimeError("shape mismatch")) == "permanent"
    sticky = RuntimeError("CUDA error: an illegal memory access was encountered")
    assert cf(sticky) == "transient" and cli_serve.is_sticky_device_error(sticky)
    assert not cli_serve.is_sticky_device_error(
        torch.cuda.OutOfMemoryError("CUDA error: out of memory"))


def test_transient_device_error_retries_not_quarantines(monkeypatch):
    s = _bare_server()
    calls = {"n": 0}

    class FakePredictor:
        def predict_dirs(self, dirs, output_paths=None):
            calls["n"] += 1
            if calls["n"] == 1:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return ["ok.nii.gz"]

    s.predictor = FakePredictor()
    monkeypatch.setattr(cli_serve.time, "sleep", lambda *_: None)
    out, err = s._predict_one_isolated("/case")
    assert out == "ok.nii.gz" and err is None and calls["n"] == 2

    class AlwaysBad:
        def predict_dirs(self, dirs, output_paths=None):
            raise ValueError("truncated gzip stream")

    s.predictor = AlwaysBad()
    out, err = s._predict_one_isolated("/case")
    assert out is None and "truncated gzip" in err[0] and err[1] == "permanent"


def test_restart_replay_retries_transient_skips_permanent(tmp_path):
    s = _bare_server(retries=0)
    s.log_dir = str(tmp_path)
    s.log_path = os.path.join(str(tmp_path), "serve_log.jsonl")

    class Flaky:
        def predict_dirs(self, dirs, output_paths=None):
            names = [os.path.basename(d) for d in dirs]
            if any("transient" in n for n in names):
                raise ConnectionError("storage dropped")
            if any("poison" in n for n in names):
                raise ValueError("corrupt NIfTI")
            return [f"{n}.nii.gz" for n in names]

    s.predictor = Flaky()
    s.process_batch([str(tmp_path / "case_ok"), str(tmp_path / "case_transient"),
                     str(tmp_path / "case_poison")])
    assert s.done == {"case_ok", "case_poison"}
    by = {r["case"]: r for r in _log(tmp_path)}
    assert by["case_ok"]["output"] == "case_ok.nii.gz"
    assert by["case_transient"]["error_class"] == "transient"
    assert by["case_poison"]["error_class"] == "permanent"
    assert s.counters == {"served": 1, "quarantined": 1, "prefilled": 0}
    s2 = _bare_server()
    s2.log_path = s.log_path
    assert s2._load_done() == {"case_ok", "case_poison"}


def test_lost_cuda_context_stops_retrying_and_exits_5(tmp_path):
    s = _bare_server(retries=3)
    s.log_dir = str(tmp_path)
    s.log_path = os.path.join(str(tmp_path), "serve_log.jsonl")
    calls = []

    class Dead:
        def predict_dirs(self, dirs, output_paths=None):
            calls.append(list(dirs))
            raise RuntimeError("CUDA error: unspecified launch failure")

    s.predictor = Dead()
    s.scan = lambda root, sizes: [str(tmp_path / "a"), str(tmp_path / "b")]
    assert s.run(str(tmp_path), 0.0, once=True) == cli_serve.EXIT_DEVICE_LOST
    assert len(calls) == 1                       # nothing retried in a dead context
    recs = _log(tmp_path)
    assert [r["error_class"] for r in recs] == ["transient", "transient"]
    assert s.done == set()                       # both come back after a restart


# ------------------------------------------------------------------ supervise --

def _counter_cmd(tmp_path, codes):
    """A stub child whose exit code is scripted by invocation count."""
    counter = tmp_path / "count"
    counter.write_text("0")
    script = (
        "import sys, pathlib\n"
        f"p = pathlib.Path({str(counter)!r})\n"
        "n = int(p.read_text()); p.write_text(str(n + 1))\n"
        f"codes = {list(codes)!r}\n"
        "sys.exit(codes[min(n, len(codes) - 1)])\n"
    )
    return [sys.executable, "-c", script], counter


@pytest.mark.parametrize("codes,cap,want_rc,want_runs,want_sleeps", [
    ([9, 9, 9, 9], 2, 9, 3, [1.0, 2.0]),          # gives up at the cap
    ([9, 5, 0], 3, 0, 3, [1.0, 2.0]),             # crash, lost context, drained
    ([2], 3, 2, 1, []),                           # config error passes through
    ([3], 3, 3, 1, []),
    ([0], 0, 0, 1, []),
    # exit 4, an --rss-limit-mb recycle: restarted at once (paced by 10 s
    # when the child lived under 30 s), however small the crash budget
    ([4, 4, 0], 0, 0, 3, [10.0, 10.0]),
    # a recycle resets the crash count: crash, recycle, crash, crash, give up
    ([9, 4, 9, 9, 9], 2, 9, 5, [1.0, 10.0, 1.0, 2.0]),
])
def test_supervise_restarts_crashed_child_up_to_the_cap(
        tmp_path, codes, cap, want_rc, want_runs, want_sleeps):
    cmd, counter = _counter_cmd(tmp_path, codes)
    sleeps = []
    rc = cli_serve.supervise_loop(cmd, max_crash_restarts=cap,
                                  _sleep=sleeps.append)
    assert rc == want_rc and counter.read_text() == str(want_runs)
    assert sleeps == want_sleeps


def test_supervise_stop_during_crash_backoff_is_clean_stop(tmp_path):
    cmd, counter = _counter_cmd(tmp_path, [9, 9])
    rc = cli_serve.supervise_loop(
        cmd, max_crash_restarts=5,
        _sleep=lambda _w: os.kill(os.getpid(), signal.SIGTERM))
    assert rc == 0 and counter.read_text() == "1"


def test_strip_supervisor_flags_and_parser():
    argv = ["watch", "--supervise", "--rss-limit-mb", "900",
            "--max-crash-restarts", "5", "--warmup"]
    # the child keeps --rss-limit-mb: it is the child that recycles
    assert cli_serve._strip_supervisor_flags(argv) == [
        "watch", "--rss-limit-mb", "900", "--warmup"]
    assert cli_serve._strip_supervisor_flags(["w", "--max-crash-restarts=5"]) == ["w"]
    parser = cli_serve.build_parser()
    with pytest.raises(SystemExit):
        parser.parse_args(["w", "--superv"])       # no abbreviations
    args = parser.parse_args(["w"])
    assert args.postproc == "device" and args.device == "cuda"
    assert args.poll == 0.5 and args.retries == 1 and not args.warmup
    # the serving left-outs parse as in the reference, with its choices
    args3 = parser.parse_args(["w", "--transfer-dtype", "int8", "--rss-limit-mb",
                               "9", "--batch-volumes", "2"])
    assert (args3.transfer_dtype, args3.rss_limit_mb, args3.batch_volumes) == (
        "int8", 9, 2)
    for flag in (["--transfer-dtype", "Int8"], ["--batch-volumes", "3"]):
        with pytest.raises(SystemExit):
            parser.parse_args(["w", *flag])
    # the ensemble, artifact and mesh flags are ported
    args2 = parser.parse_args(["w", "--ensemble", "x", "y", "--save-probs",
                               "--save-uncertainty", "--multichip", "cascade"])
    assert args2.ensemble == ["x", "y"] and args2.save_probs and args2.save_uncertainty
    assert args2.multichip == "cascade" and args.multichip is None
    # every ported flag has the reference's default
    ref = jax_serve.build_parser().parse_args(["w"])
    for k, v in vars(args).items():
        if k != "device":
            assert getattr(ref, k) == v, k


def test_http_api_is_the_reference_copy():
    """Every top-level statement of the copy equals the original's, except
    the module docstring."""
    def body(mod):
        return [ast.dump(n) for n in ast.parse(inspect.getsource(mod)).body[1:]]

    assert body(http_api) == body(ref_http_api)


# ------------------------------------------------------------ the daemon, live --

def test_cuda_device_without_a_card_is_an_error(tmp_path, workdir, preset, capsys,
                                                keep_signal_handlers):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = cli_serve.main([str(tmp_path), "--preset", PRESET, "--workdir", workdir,
                         "--once"])
    assert rc == 2 and "cuda" in capsys.readouterr().err.lower()
    rc = cli_serve.main(_args(tmp_path, str(tmp_path / "no_weights"), "--once"))
    assert rc == 2


def test_once_drains_logs_and_a_restart_skips(tmp_path, workdir, preset, capsys,
                                              keep_signal_handlers):
    watch = tmp_path / "incoming"
    dirs = synthetic.write_dataset(str(watch), 2, shape=SHAPE)
    out = tmp_path / "served"
    args = _args(watch, workdir, "--output-dir", str(out), "--once",
                 "--prep-cache", str(tmp_path / "cache"))
    assert cli_serve.main(args) == 0
    log = _log(out)
    assert {r["case"] for r in log} == {os.path.basename(d) for d in dirs}
    for r in log:
        assert r.get("error") is None and r["batch_size"] == 2
        seg, _ = read_nifti(r["output"], apply_scaling=False)
        assert seg.shape == SHAPE and set(np.unique(seg)) <= {0, 1, 2, 4}
    assert not any(f.endswith("_pred.nii.gz") for d in dirs for f in os.listdir(d))
    assert len(os.listdir(tmp_path / "cache")) == 2
    # a restarted daemon replays the log and serves nothing again
    capsys.readouterr()
    assert cli_serve.main(args) == 0
    assert len(_log(out)) == 2 and "case(s) in" not in capsys.readouterr().out


def test_corrupt_case_is_quarantined_and_the_others_served(
        tmp_path, workdir, preset, keep_signal_handlers):
    watch = tmp_path / "incoming"
    dirs = synthetic.write_dataset(str(watch), 3, shape=SHAPE)
    bad = os.path.basename(dirs[1])
    with open(os.path.join(dirs[1], f"{bad}_t2.nii.gz"), "wb") as f:
        f.write(b"this is not gzip")
    args = _args(watch, workdir, "--once", "--postproc", "host")
    assert cli_serve.main(args) == 0
    by = {r["case"]: r for r in _log(watch)}          # no output dir: the watch root
    assert by[bad]["error_class"] == "permanent" and by[bad]["output"] is None
    for d in (dirs[0], dirs[2]):
        name = os.path.basename(d)
        assert by[name].get("error") is None
        assert os.path.exists(os.path.join(d, f"{name}_pred.nii.gz"))
    assert cli_serve.main(args) == 0                  # the poison case stays done
    assert len(_log(watch)) == 3


def test_watch_loop_serves_arrivals_reloads_on_sighup_and_drains(
        tmp_path, workdir, preset, keep_signal_handlers):
    """One live daemon: a case dropped into the watch root is served; SIGHUP
    swaps in the re-exported weights for the next case; SIGTERM drains."""
    live = tmp_path / "live_workdir"
    shutil.copytree(workdir, live)
    watch, out, stage = tmp_path / "incoming", tmp_path / "served", tmp_path / "stage"
    watch.mkdir()
    dirs = synthetic.write_dataset(str(stage), 2, shape=SHAPE)
    names = [os.path.basename(d) for d in dirs]
    seen = {}

    def client():
        try:
            os.rename(dirs[0], watch / names[0])
            _wait_for(lambda: (out / f"{names[0]}_pred.nii.gz").exists(),
                      what="the first case")
            save_params_npz(str(live / "fine" / "params.npz"),
                            init_params(presets.UNetConfig(**FINE_KW), seed=9))
            os.kill(os.getpid(), signal.SIGHUP)
            time.sleep(0.3)
            # the same volume under a new name: new weights, other labels
            shutil.copytree(watch / names[0], stage / "again")
            for f in os.listdir(stage / "again"):
                os.rename(stage / "again" / f,
                          stage / "again" / f.replace(names[0], names[1]))
            shutil.rmtree(dirs[1])
            os.rename(stage / "again", watch / names[1])
            _wait_for(lambda: (out / f"{names[1]}_pred.nii.gz").exists(),
                      what="the case after the reload")
            seen["ok"] = True
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    rc = cli_serve.main(_args(watch, str(live), "--output-dir", str(out)))
    t.join(30)
    assert rc == 0 and seen.get("ok")
    a = read_nifti(str(out / f"{names[0]}_pred.nii.gz"), apply_scaling=False)[0]
    b = read_nifti(str(out / f"{names[1]}_pred.nii.gz"), apply_scaling=False)[0]
    assert a.shape == b.shape and (a != b).any()      # the reload took effect
    assert [r["case"] for r in _log(out)] == names


def _http(method, url, data=None, headers=None, timeout=120):
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_api_healthz_predict_result_and_token(tmp_path, workdir, preset):
    from brats2019_tpu_torch.cli.http_api import start_http

    monkey_exp = presets.PRESETS[PRESET]
    import dataclasses

    exp = dataclasses.replace(
        monkey_exp, workdir=workdir,
        infer=dataclasses.replace(monkey_exp.infer, postproc="device"))
    watch, out = tmp_path / "incoming", tmp_path / "served"
    watch.mkdir()
    server = cli_serve.Server(exp, output_dir=str(out), log_dir=str(watch),
                              device="cpu")
    server.warm = False
    httpd = start_http(server, str(watch), 0, token="s3cret")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    auth = {"Authorization": "Bearer s3cret"}
    loop = threading.Thread(target=server.run, args=(str(watch), 0.05, False),
                            daemon=True)
    try:
        code, body = _http("GET", base + "/healthz")          # no token needed
        assert code == 200 and json.loads(body)["warm"] is False
        server.warmup(stage="primary")
        assert json.loads(_http("GET", base + "/healthz")[1])["warm"] is True
        assert _http("GET", base + "/stats")[0] == 401
        assert _http("GET", base + "/stats",
                     headers={"Authorization": "Bearer nope"})[0] == 401
        loop.start()
        cases = synthetic.write_dataset(str(tmp_path / "elsewhere"), 2, shape=SHAPE)
        # co-located JSON submission
        n0 = os.path.basename(cases[0])
        code, body = _http(
            "POST", base + "/predict?format=json&timeout=100",
            data=json.dumps({"case_dir": cases[0]}).encode(),
            headers={**auth, "Content-Type": "application/json"})
        assert code == 200, body
        rec = json.loads(body)
        assert rec["case"] == n0 and rec.get("error") is None
        # tarball upload: the NIfTI bytes come back
        n1 = os.path.basename(cases[1])
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w:gz") as tf:
            for f in sorted(os.listdir(cases[1])):
                if not f.endswith("_seg.nii.gz"):
                    tf.add(os.path.join(cases[1], f), arcname=f"{n1}/{f}")
        code, body = _http("POST", base + f"/predict?name={n1}&timeout=100",
                           data=buf.getvalue(),
                           headers={**auth, "Content-Type": "application/x-tar"})
        assert code == 200, body[:200]
        with open(out / f"{n1}_pred.nii.gz", "rb") as f:
            assert body == f.read()
        seg, _ = read_nifti(str(out / f"{n1}_pred.nii.gz"), apply_scaling=False)
        assert seg.shape == SHAPE and set(np.unique(seg)) <= {0, 1, 2, 4}
        code, body = _http("GET", base + f"/result?case={n1}", headers=auth)
        assert code == 200 and json.loads(body)["output"].endswith("_pred.nii.gz")
        assert _http("GET", base + "/result?case=unknown", headers=auth)[0] == 404
        code, body = _http("GET", base + f"/artifact?case={n0}&kind=pred",
                           headers=auth)
        assert code == 200 and len(body) > 0
        stats = json.loads(_http("GET", base + "/stats", headers=auth)[1])
        assert stats["served"] == 2 and stats["quarantined"] == 0
        assert stats["latency"]["n"] == 2
        code, body = _http("GET", base + "/metrics", headers=auth)
        assert code == 200 and b"brats_served_total 2" in body
        assert _http("POST", base + "/predict?name=../x", data=b"x",
                     headers=auth)[0] == 400
    finally:
        server.request_stop()
        if loop.is_alive():
            loop.join(30)
        httpd.shutdown()
    assert not loop.is_alive()
    assert [r["case"] for r in _log(out)] == [n0, n1]


def test_port_daemon_and_jax_daemon_write_equal_labels(tmp_path, workdir, preset,
                                                       keep_signal_handlers):
    """One synthetic case through both daemons, same exported weights,
    device postprocessing on both: equal label volumes (f32, so only a
    numerical tie could differ; none does on this input)."""
    case = synthetic.write_dataset(str(tmp_path / "src"), 1, shape=SHAPE,
                                   seed0=22, hard=True)[0]
    name = os.path.basename(case)
    outs = {}
    for key, mod, extra in (("port", cli_serve, ["--device", "cpu"]),
                            ("jax", jax_serve, [])):
        watch, out = tmp_path / f"watch_{key}", tmp_path / f"out_{key}"
        watch.mkdir()
        shutil.copytree(case, watch / name)
        rc = mod.main([str(watch), "--preset", PRESET, "--workdir", workdir,
                       "--output-dir", str(out), "--once", "--poll", "0.05",
                       "--postproc", "device", *extra])
        assert rc == 0
        rec = _log(out)[0]
        assert rec["case"] == name and rec.get("error") is None
        outs[key] = read_nifti(rec["output"], apply_scaling=False)
    (got, hdr_g), (want, hdr_w) = outs["port"], outs["jax"]
    assert got.shape == SHAPE and (got > 0).sum() > 100
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(hdr_g.affine(), hdr_w.affine())


@pytest.mark.parametrize("flags", [["--no-tta"], ["--no-cascade"]])
def test_port_daemon_no_tta_no_cascade_match_jax_daemon(tmp_path, workdir, preset,
                                                         keep_signal_handlers,
                                                         flags):
    """--no-tta and --no-cascade on both daemons, same weights: the port's
    labels equal the JAX daemon's except on numerical ties."""
    case = synthetic.write_dataset(str(tmp_path / "src"), 1, shape=SHAPE,
                                   seed0=24, hard=True)[0]
    name = os.path.basename(case)
    outs = {}
    for key, mod, extra in (("port", cli_serve, ["--device", "cpu"]),
                            ("jax", jax_serve, [])):
        watch, out = tmp_path / f"watch_{key}", tmp_path / f"out_{key}"
        watch.mkdir()
        shutil.copytree(case, watch / name)
        rc = mod.main([str(watch), "--preset", PRESET, "--workdir", workdir,
                       "--output-dir", str(out), "--once", "--poll", "0.05",
                       "--postproc", "host", *flags, *extra])
        assert rc == 0
        rec = _log(out)[0]
        assert rec["case"] == name and rec.get("error") is None
        outs[key] = read_nifti(rec["output"], apply_scaling=False)[0]
    got, want = outs["port"], outs["jax"]
    assert got.shape == SHAPE and set(np.unique(got)) <= {0, 1, 2, 4}
    assert (got != want).mean() < 1e-4, int((got != want).sum())


def test_ensemble_daemon_artifacts_match_jax_daemon(tmp_path, workdir, preset,
                                                    keep_signal_handlers):
    """``--ensemble W --save-probs --save-uncertainty`` on both daemons, same
    exported weights (the second member another fine net, no coarse params:
    it reuses the primary's): the labels, the probability npz and the
    uncertainty maps agree; the artifacts sit beside the prediction."""
    member = tmp_path / "member"
    os.makedirs(member / "fine")
    pf = JaxUNet3D(JaxUNetConfig(**FINE_KW)).init(
        jax.random.PRNGKey(9), jnp.zeros((1, 16, 16, 16, 4)))
    export_params(str(member / "fine" / "params.npz"), pf)
    case = synthetic.write_dataset(str(tmp_path / "src"), 1, shape=SHAPE,
                                   seed0=23, hard=True)[0]
    name = os.path.basename(case)
    outs = {}
    for key, mod, extra in (("port", cli_serve, ["--device", "cpu"]),
                            ("jax", jax_serve, [])):
        watch, out = tmp_path / f"watch_{key}", tmp_path / f"out_{key}"
        watch.mkdir()
        shutil.copytree(case, watch / name)
        rc = mod.main([str(watch), "--preset", PRESET, "--workdir", workdir,
                       "--output-dir", str(out), "--once", "--poll", "0.05",
                       "--ensemble", str(member), "--save-probs",
                       "--save-uncertainty", *extra])
        assert rc == 0 and _log(out)[0].get("error") is None
        with np.load(out / f"{name}_probs.npz") as z:
            probs = z["probs"].astype(np.float32)
        unc = read_nifti(str(out / f"{name}_unc_whole.nii.gz"), apply_scaling=False)[0]
        seg = read_nifti(str(out / f"{name}_pred.nii.gz"), apply_scaling=False)[0]
        outs[key] = (seg, probs, unc.astype(int))
    (seg, probs, unc), (seg_j, probs_j, unc_j) = outs["port"], outs["jax"]
    assert seg.shape == SHAPE and probs.shape == SHAPE + (4,)
    np.testing.assert_allclose(probs, probs_j, atol=2e-3)      # f16 on disk
    assert (seg != seg_j).mean() < 1e-4
    assert np.abs(unc - unc_j).max() <= 1 and unc.max() <= 100


# ------------------------------------------------------- the RSS recycle --

def _server(workdir, out, rss_limit_mb):
    import dataclasses

    exp = dataclasses.replace(presets.PRESETS[PRESET], workdir=workdir)
    server = cli_serve.Server(exp, output_dir=str(out), device="cpu")
    server.rss_limit_mb = rss_limit_mb
    return server


def test_rss_limit_recycles_between_batches(tmp_path, workdir, preset, monkeypatch):
    """--rss-limit-mb: above the watermark from the start, the daemon still
    serves the batch it found, then exits with EXIT_RECYCLE (4); a
    restarted daemon replays the log; idle, it recycles after two empty
    scans; with the limit off the loop keeps running."""
    watch = tmp_path / "incoming"
    synthetic.write_dataset(str(watch), 1, shape=SHAPE)
    name = os.listdir(watch)[0]
    monkeypatch.setattr(cli_serve, "_self_rss_mb", lambda: 500.0)
    out = tmp_path / "served"
    server = _server(workdir, out, 123)
    box = {}
    t = threading.Thread(target=lambda: box.update(
        rc=server.run(str(watch), 0.05, False)), daemon=True)
    t.start()
    t.join(120)
    assert not t.is_alive()
    assert box["rc"] == cli_serve.Server.EXIT_RECYCLE == 4
    assert server.done == {name} and [r["case"] for r in _log(out)] == [name]
    # the restarted daemon replays the log, finds nothing new, and recycles
    # idle after two empty scans
    again = _server(workdir, out, 123)
    assert again.done == {name}
    assert again.run(str(watch), 0.05, False) == 4
    assert len(_log(out)) == 1
    # limit off (the default 0): the same conditions keep the loop running
    off = _server(workdir, tmp_path / "off", 0)
    t3 = threading.Thread(target=lambda: box.update(
        rc3=off.run(str(watch), 0.05, False)), daemon=True)
    t3.start()
    _wait_for(lambda: (tmp_path / "off" / f"{name}_pred.nii.gz").exists(),
              what="the case served with the limit off")
    time.sleep(0.3)
    assert t3.is_alive()
    off.request_stop()
    t3.join(30)
    assert not t3.is_alive() and box["rc3"] == 0


def test_self_rss_is_the_reference_copy():
    """The RSS reader is the reference's but for its docstring, and reads
    this process."""
    def body(fn):
        node = ast.parse(inspect.getsource(fn)).body[0]
        node.body = node.body[1:]
        return ast.dump(node)

    assert body(cli_serve._self_rss_mb) == body(jax_serve._self_rss_mb)
    assert cli_serve._self_rss_mb() > 1.0


def test_port_daemon_int8_and_pairing_match_jax_daemon(tmp_path, workdir, preset,
                                                       keep_signal_handlers):
    """--transfer-dtype int8 --batch-volumes 2 on both daemons, same weights,
    three cases (one pair and an odd tail): the port's labels equal the JAX
    daemon's except on numerical ties."""
    src = synthetic.write_dataset(str(tmp_path / "src"), 3, shape=SHAPE,
                                  seed0=26, hard=True)
    outs = {}
    for key, mod, extra in (("port", cli_serve, ["--device", "cpu"]),
                            ("jax", jax_serve, [])):
        watch, out = tmp_path / f"watch_{key}", tmp_path / f"out_{key}"
        watch.mkdir()
        for d in src:
            shutil.copytree(d, watch / os.path.basename(d))
        rc = mod.main([str(watch), "--preset", PRESET, "--workdir", workdir,
                       "--output-dir", str(out), "--once", "--poll", "0.05",
                       "--postproc", "host", "--transfer-dtype", "int8",
                       "--batch-volumes", "2", *extra])
        assert rc == 0
        recs = {r["case"]: r for r in _log(out)}
        assert len(recs) == 3 and all(r.get("error") is None for r in recs.values())
        outs[key] = {c: read_nifti(r["output"], apply_scaling=False)[0]
                     for c, r in recs.items()}
    for case, got in outs["port"].items():
        want = outs["jax"][case]
        assert got.shape == SHAPE and set(np.unique(got)) <= {0, 1, 2, 4}
        assert (got != want).mean() < 1e-4, int((got != want).sum())
