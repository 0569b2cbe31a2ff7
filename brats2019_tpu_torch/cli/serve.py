"""``serve``: the long-running prediction daemon of the PyTorch port
(reference: ``brats2019_tpu/cli/serve.py``).

Usage:
    python -m brats2019_tpu_torch.cli.serve <watch_root> [--preset cascade]
        [--workdir DIR] [--output-dir DIR] [--poll 0.5] [--once]
        [--device cuda|cpu] [--http PORT] [--warmup] [--supervise]
        [--rss-limit-mb N] [--transfer-dtype bfloat16|int8]
        [--batch-volumes 1|2] ...

Watches ``watch_root`` for BraTS case directories appearing (all four
modality files present and size-stable across one poll interval), runs the
pipelined predictor on each arrival batch (NIfTI decode, host->device copy,
the cascade + TTA program and postprocess/write overlap,
``infer/predictor.py``), and writes ``<case>_pred.nii.gz`` plus one JSONL
completion record per case to ``<output-dir>/serve_log.jsonl``. The weights
stay on the device across requests; new work is picked up within one poll
interval; SIGTERM/SIGINT drain the cases in flight before exit, SIGHUP
reloads the weights. ``--once`` processes what is present and exits.
``--device cuda`` (the default) on a host without a card is an error;
``--device cpu`` runs the plain torch ops.

A failing case is retried alone; a failure that is the case's fault is
quarantined (logged, never retried), a transient one (out of device memory,
a connection or timeout error) is retried here and after a restart. A CUDA
error other than out-of-memory leaves the process's context unusable, so no
retry in this process can succeed: the daemon logs the case as transient and
exits with code 5; under ``--supervise`` the supervisor restarts it and the
completion log replays what was served. ``--rss-limit-mb N`` makes the daemon
exit with code 4 once its resident memory reaches N MB, checked between
batches of a burst and after two empty scans (never mid-case); the
supervisor restarts it at once (paced by 10 s when it lived under 30 s) and
the completion log makes the recycle lossless.

``--transfer-dtype int8`` ships each case's brain crop quantized per modality
to int8 (half the host->device bytes; lossy), ``--batch-volumes 2`` pairs
consecutive cases of a batch into one fine forward at batch 16 (the split
cascade only; ``infer/predictor.py``).

``--no-tta`` and ``--no-cascade`` turn the 8-flip TTA and the coarse stage
off, as in the reference; every preset is served (``models/cascade.py``
``make_predict_fn`` picks the program).

``--ensemble W ...`` serves the checkpoint ensemble of the primary
``--workdir`` model and each listed workdir's model (mean probabilities,
``infer/ensemble.py``; postprocessing on the host). ``--save-probs`` and
``--save-uncertainty`` also write ``<case>_probs.npz`` and the QU-BraTS maps
``<case>_unc_{whole,core,enhance}.nii.gz`` per served case (one probability
pass shared by both, best effort: a failed artifact pass is logged and the
case stays served), before the case's completion is published, so ``GET
/artifact`` finds them as soon as ``/result`` does.

``--multichip MODE`` serves each case over a mesh of shards
(``infer/multichip.py``; the mesh is ``--device``: ``cuda`` every local card,
or a comma-separated list of shard devices such as ``cuda:0,cuda:0``):
``cascade`` the cascade predictor's masks, ``spatial``/``sweep`` the
single-stage decompositions; ``--ensemble`` composes with ``cascade`` only,
and ``--save-probs``/``--save-uncertainty`` are refused with it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from typing import Optional

from ..configs.presets import PRESETS
from ..data.case import discover_cases, modality_paths
from .common import (
    load_ensemble_members,
    load_serving_params,
    load_stage_params,
    mesh_from_device_arg,
    multichip_mode_notes,
    parse_shard,
    resolve_experiment,
    shard_of,
)

# exit code after a CUDA error that outlives the call (the context is gone)
EXIT_DEVICE_LOST = 5


def is_sticky_device_error(e: BaseException) -> bool:
    """A CUDA error other than out-of-memory: the process's CUDA context is
    unusable afterwards, so only a new process can serve again."""
    import torch

    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and "CUDA error" in str(e)


def classify_failure(e: BaseException) -> str:
    """'transient' (a device or runtime hiccup: retry, never quarantine) or
    'permanent' (the case's fault: quarantine). Keys on the exception type:
    out of device memory, a lost CUDA context, connection and timeout errors
    are transient; everything else (a NIfTI parse error, a shape error) is
    the case's."""
    import torch

    if isinstance(e, (torch.cuda.OutOfMemoryError, ConnectionError,
                      TimeoutError)):
        return "transient"
    if is_sticky_device_error(e):
        return "transient"
    return "permanent"


def build_parser() -> argparse.ArgumentParser:
    # allow_abbrev=False: the --supervise child is re-invoked with the raw
    # argv minus the supervisor flags, stripped by name; an abbreviated
    # `--superv` would parse as --supervise but dodge the strip and spawn
    # supervisors recursively
    p = argparse.ArgumentParser(prog="brats2019_tpu_torch.serve",
                                description=__doc__, allow_abbrev=False)
    p.add_argument("watch_root", help="directory where case dirs appear")
    p.add_argument("--preset", default="cascade", choices=sorted(PRESETS))
    p.add_argument("--workdir", default=None)
    p.add_argument("--output-dir", default=None,
                   help="write predictions+log here instead of the case dirs")
    p.add_argument("--poll", type=float, default=0.5,
                   help="seconds between watch-root scans")
    p.add_argument("--once", action="store_true",
                   help="drain current cases and exit")
    p.add_argument("--no-tta", action="store_true",
                   help="one forward per tile, no 8-flip TTA")
    p.add_argument("--no-cascade", action="store_true",
                   help="no coarse stage: sweep the whole canvas")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (hand-written kernels) or cpu "
                        "(plain torch ops); with --multichip, cuda (every "
                        "local card) or a comma-separated list of shard "
                        "devices")
    p.add_argument("--transfer-dtype", default=None,
                   choices=("bfloat16", "int8"),
                   help="host->device encoding: int8 halves the link bytes "
                        "(lossy: the masks may differ from the bf16 path's)")
    p.add_argument("--rss-limit-mb", type=int, default=0,
                   help="voluntary recycle watermark: exit with code 4 "
                        "(between batches, never mid-case) once resident "
                        "memory reaches this, so a supervisor restarts the "
                        "daemon (lossless through the completion-log "
                        "replay); 0 = off")
    p.add_argument("--batch-volumes", type=int, default=None, choices=(1, 2),
                   help="2 = pair two volumes' fine TTA stages into one "
                        "device program at batch 16 (the split cascade only; "
                        "an odd tail runs alone)")
    p.add_argument("--multichip", default=None,
                   choices=("spatial", "sweep", "cascade"),
                   help="serve each case over a mesh of shards: 'cascade' "
                        "gives the cascade predictor's masks, "
                        "'spatial'/'sweep' are the single-stage "
                        "decompositions; --ensemble composes with cascade, "
                        "--save-probs/--save-uncertainty do not compose")
    p.add_argument("--postproc", default="device", choices=("host", "device"),
                   help="where the connected-component filter runs. serve "
                        "defaults to the device: the host then only pastes, "
                        "un-crops and writes")
    p.add_argument("--min-component-voxels", type=int, default=None,
                   help="override the preset's small-component filter "
                        "(0 disables)")
    p.add_argument("--et-min-voxels", type=int, default=None,
                   help="override the preset's tiny-ET relabel threshold "
                        "(tiny ET -> NCR; 0 disables)")
    p.add_argument("--prep-cache", default=None, metavar="DIR",
                   help="on-disk transfer-payload cache: repeat arrivals of "
                        "the same case files skip NIfTI gzip decode, the "
                        "brain-bbox scan and crop/cast (the payload is "
                        "bitwise what the uncached path ships)")
    p.add_argument("--serving-depth", type=int, default=None,
                   help="volumes concurrently in host prep/postprocess")
    p.add_argument("--ensemble", default=None, nargs="+", metavar="WORKDIR",
                   help="checkpoint-ensemble serving: average the class "
                        "probabilities of the primary --workdir model and "
                        "each listed workdir's model (M member passes per "
                        "case; host postprocessing)")
    p.add_argument("--save-probs", action="store_true",
                   help="also write <case>_probs.npz per served case (one "
                        "more device pass per case)")
    p.add_argument("--save-uncertainty", action="store_true",
                   help="also write the QU-BraTS uncertainty maps "
                        "<case>_unc_{whole,core,enhance}.nii.gz per served "
                        "case (shares the --save-probs pass)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="also expose an HTTP API (GET /healthz /stats "
                        "/metrics /result /artifact, POST /predict with a "
                        "case tarball or a co-located {'case_dir': ...} "
                        "JSON); uploads spool into the watch root, device "
                        "work stays in the daemon loop (cli/http_api.py)")
    p.add_argument("--http-host", default="127.0.0.1",
                   help="HTTP bind address (default loopback)")
    p.add_argument("--http-token", default=None, metavar="SECRET",
                   help="require 'Authorization: Bearer SECRET' on every "
                        "HTTP endpoint except /healthz")
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="scale-out serving: this daemon handles only the "
                        "cases whose stable name-hash lands in shard I of N "
                        "(one daemon per card over a shared watch root). "
                        "Deterministic and disjoint; each daemon keeps its "
                        "own --output-dir/log")
    p.add_argument("--warmup", action="store_true",
                   help="build the kernels and run the serving program once "
                        "on a zero canvas before watching, so the first "
                        "arriving case pays no first-use cost; /healthz "
                        "reports warm:false until done")
    p.add_argument("--retries", type=int, default=1,
                   help="in-process retries for transient device failures")
    p.add_argument("--retry-backoff", type=float, default=1.0,
                   help="initial retry backoff seconds (doubles per retry)")
    p.add_argument("--supervise", action="store_true",
                   help="run the daemon as a supervised child process and "
                        "restart it on crashes (capped by "
                        "--max-crash-restarts), a lost CUDA context (exit 5) "
                        "included, and at once on an --rss-limit-mb recycle "
                        "(exit 4). The supervisor itself never touches the "
                        "device. Deliberate exits pass through (0 drained, 2 "
                        "config error); a forwarded SIGTERM/SIGINT always "
                        "exits 0 (clean stop)")
    p.add_argument("--max-crash-restarts", type=int, default=3,
                   help="with --supervise: give up after this many "
                        "consecutive unexpected child exits")
    p.add_argument("--seed", type=int, default=None)
    return p


def _strip_supervisor_flags(argv):
    """The child daemon gets the same CLI minus the supervisor-only flags."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--supervise" or a.startswith("--max-crash-restarts="):
            continue
        if a == "--max-crash-restarts":
            skip = True
            continue
        out.append(a)
    return out


def supervise_loop(cmd, max_crash_restarts=3, crash_backoff=1.0,
                   _sleep=time.sleep) -> int:
    """Restart policy around one serving daemon (serve --supervise).

    - exit 0 / 2 / 3 (drained / config error / deliberate): pass through.
    - exit 4 (``Server.EXIT_RECYCLE``, the --rss-limit-mb watermark): restart
      at once and reset the crash count; a child that recycled within 30 s
      of its start paces the next start by 10 s (a watermark at or below
      the daemon's baseline would otherwise hot-loop).
    - anything else (a crash, or exit 5 after a lost CUDA context): restart
      with doubling backoff, give up after ``max_crash_restarts``
      consecutive crashes. The completion log makes a restart lossless.

    SIGTERM/SIGINT/SIGHUP are forwarded to the child, so graceful stop and
    weight hot-reload work unchanged through the supervisor. Stop signals
    are sticky and the exit code deterministic: a supervisor that received a
    stop exits 0 whether the signal reached a draining child, killed one
    before it installed its handlers, or fell between two children (a child
    config error, exit 2, still passes through)."""
    child = {"proc": None, "stop": False}

    def forward(signum, _frame):
        if signum != getattr(signal, "SIGHUP", None):
            child["stop"] = True
        p = child["proc"]
        if p is not None and p.poll() is None:
            p.send_signal(signum)

    old = {}
    for s in (signal.SIGTERM, signal.SIGINT) + (
        (signal.SIGHUP,) if hasattr(signal, "SIGHUP") else ()
    ):
        old[s] = signal.signal(s, forward)
    crashes = 0
    try:
        while True:
            if child["stop"]:
                return 0  # the stop fell between two children: clean stop
            t_start = time.monotonic()
            child["proc"] = subprocess.Popen(cmd)
            if child["stop"]:
                # a stop that landed between the check above and Popen went
                # to the previous (exited) child or to none: deliver it
                try:
                    child["proc"].send_signal(signal.SIGTERM)
                except OSError:
                    pass
            rc = child["proc"].wait()
            uptime = time.monotonic() - t_start
            if child["stop"]:
                return rc if rc == 2 else 0
            if rc == Server.EXIT_RECYCLE:
                crashes = 0
                if uptime < 30.0:
                    print(f"supervise: daemon recycled after only "
                          f"{uptime:.1f}s; --rss-limit-mb is likely at or "
                          "below its baseline RSS; pacing restarts (10s)",
                          file=sys.stderr, flush=True)
                    _sleep(10.0)
                else:
                    print("supervise: daemon recycled (exit 4); restarting",
                          flush=True)
                continue
            if rc in (0, 2, 3):
                return rc
            crashes += 1
            if crashes > max_crash_restarts:
                print(f"supervise: giving up after {crashes} consecutive "
                      f"unexpected exits (last rc={rc})", file=sys.stderr,
                      flush=True)
                return rc
            wait = crash_backoff * (2 ** (crashes - 1))
            print(f"supervise: daemon exited rc={rc} (crash {crashes}/"
                  f"{max_crash_restarts}); restarting in {wait:.1f}s",
                  file=sys.stderr, flush=True)
            _sleep(wait)
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def _self_rss_mb() -> float:
    """This process's resident set in MB (Linux /proc; 0.0 where absent,
    and the RSS limit then never triggers)."""
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return 0.0


def _case_ready(case_dir: str, sizes: dict) -> bool:
    """All 4 modalities exist and their sizes did not change since the last
    scan (an uploader mid-copy never has a stable size across a poll)."""
    try:
        cur = tuple(os.path.getsize(p) for p in modality_paths(case_dir))
    except OSError:
        return False
    prev = sizes.get(case_dir)
    sizes[case_dir] = cur
    return prev == cur


class Server:
    # exit code of a voluntary --rss-limit-mb recycle (SIGTERM preemption is
    # 3, a lost CUDA context 5): the supervisor restarts the daemon at once
    EXIT_RECYCLE = 4
    # --rss-limit-mb; 0 = off
    rss_limit_mb = 0
    # payload prefill off until __init__ proves the predictor supports it
    # (keeps minimally constructed instances off the self.exp path)
    _can_prefill = False
    # None = warmup not requested; False = warming; True = warmed
    # (/healthz shows it only when not None)
    warm = None
    # set after a CUDA error that outlives the call: run() exits
    device_lost = False
    _warmup_rest_pending = False
    # --save-probs / --save-uncertainty / --ensemble (set by __init__)
    save_probs = False
    save_uncertainty = False
    ensemble_workdirs: tuple = ()

    def __init__(self, exp, output_dir=None, log_dir=None, retries=1,
                 retry_backoff=1.0, device="cuda", ensemble_workdirs=None,
                 save_probs=False, save_uncertainty=False, multichip=None):
        exp, params_fine, params_coarse = load_serving_params(exp)
        self.exp = exp
        self.save_probs = save_probs
        self.save_uncertainty = save_uncertainty
        self.ensemble_workdirs = list(ensemble_workdirs or [])
        self.multichip = multichip
        if multichip:
            # every case over the mesh: a predict_dirs / reload / warmup
            # drop-in; main() refused the probability artifacts and
            # ensembles outside cascade mode before this point
            from ..infer.multichip import MultichipPredictor

            members = None
            if self.ensemble_workdirs:
                members = load_ensemble_members(
                    exp, self.ensemble_workdirs, (params_fine, params_coarse))
            self.predictor = MultichipPredictor(
                exp, params_fine, mode=multichip,
                env=mesh_from_device_arg(device),
                params_coarse=params_coarse, members=members)
            print(f"serve: multichip mode={multichip} over "
                  f"{self.predictor.env.n_data} shards"
                  + (f", ensemble of {self.predictor.num_members} members"
                     if members else ""), flush=True)
        elif self.ensemble_workdirs:
            from ..infer.ensemble import EnsemblePredictor

            members = load_ensemble_members(
                exp, self.ensemble_workdirs, (params_fine, params_coarse))
            if exp.infer.postproc == "device":
                print("serve: --postproc device has no effect with "
                      "--ensemble: it postprocesses on the host (the device "
                      "connected components live in the label program, "
                      "which the ensemble's probability path bypasses)",
                      file=sys.stderr)
            self.predictor = EnsemblePredictor(exp, members, device=device)
            print(f"serve: ensemble of {self.predictor.num_members} members",
                  flush=True)
        else:
            from ..infer.predictor import Predictor

            self.predictor = Predictor(exp, params_fine, params_coarse,
                                       device=device)
        self.output_dir = output_dir
        self.retries = retries
        self.retry_backoff = retry_backoff
        # log + heartbeat live where a restarted daemon finds them from any
        # CWD: output_dir if given, else log_dir (main() passes the watch root)
        self.log_dir = output_dir or log_dir or "."
        self.log_path = os.path.join(self.log_dir, "serve_log.jsonl")
        for d in (output_dir, self.log_dir):
            if d:
                os.makedirs(d, exist_ok=True)
        self.done = self._load_done()
        self._stop = False
        self._reload = False
        # scale-out: (i, n) or None; scan() skips cases outside shard i
        self.shard = None
        # completion records of this process, for the HTTP API: case name ->
        # latest JSONL record, guarded by results_cv (wait_result blocks
        # HTTP threads on it)
        self.started_ts = time.time()
        self.results: dict = {}
        self.results_cv = threading.Condition()
        # monotonic completion counters for /metrics
        self.counters = {"served": 0, "quarantined": 0, "prefilled": 0}
        # payload-cache prefill: arrivals queued behind the current batch are
        # decoded and encoded into the on-disk payload cache by a background
        # thread while the device serves, so their prep is a warm hit
        self._prefill_q: "queue.Queue[str]" = queue.Queue()
        self._prefill_queued: set = set()
        self._prefill_thread: Optional[threading.Thread] = None
        # the mesh predictor's prep does not use the payload cache
        self._can_prefill = bool(self.exp.infer.prep_cache_dir) and not multichip

    def _queue_prefill(self, case_dirs) -> None:
        """Enqueue not-yet-seen cases for background payload prefill and
        start the worker on first use."""
        if not self._can_prefill or not case_dirs:
            return
        if self._prefill_thread is None:
            self._prefill_thread = threading.Thread(
                target=self._prefill_worker, daemon=True
            )
            self._prefill_thread.start()
        for d in case_dirs:
            if d not in self._prefill_queued:
                self._prefill_queued.add(d)
                self._prefill_q.put(d)

    def _prefill_worker(self) -> None:
        """Drain the prefill queue: host work only (gzip decode, bbox,
        crop/cast, atomic cache write), never the device. A failure is
        logged and left to the serving path's retry/quarantine."""
        while not self._stop:
            try:
                d = self._prefill_q.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                if self.predictor.prefill_payload_cache(d):
                    self.counters["prefilled"] += 1
                    print(f"serve: prefilled payload cache for "
                          f"{os.path.basename(d)}", flush=True)
            except Exception as e:  # noqa: BLE001 — the serve path will retry
                print(f"serve: payload prefill failed for {d}: "
                      f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)

    def _load_done(self) -> set:
        """Replay the completion log so a restarted daemon skips served and
        permanently quarantined cases (a poison case must never crash-loop)
        but retries cases whose last failure was transient."""
        done = set()
        try:
            with open(self.log_path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                        case = rec["case"]
                    except (ValueError, KeyError):
                        continue
                    if rec.get("error") is None or (
                        rec.get("error_class", "permanent") == "permanent"
                    ):
                        done.add(case)
                    else:
                        done.discard(case)  # transient: retry on restart
        except OSError:
            pass
        return done

    def request_stop(self, *_):
        self._stop = True

    def request_reload(self, *_):
        """SIGHUP: hot-reload weights at the next loop iteration."""
        self._reload = True

    def reload_weights(self) -> bool:
        """Swap the serving weights from the workdir (freshly exported
        params or a newer checkpoint) into the live modules
        (Predictor.reload_params). A failed reload keeps the current
        weights serving."""
        try:
            pf = load_stage_params(self.exp, "fine")
            pc = None
            if self.exp.infer.cascade and self.exp.coarse_unet is not None:
                pc = load_stage_params(self.exp, "coarse")
            if self.ensemble_workdirs:
                members = load_ensemble_members(
                    self.exp, self.ensemble_workdirs, (pf, pc))
                self.predictor.reload_members(members)
                print(f"serve: {len(members)} ensemble members hot-reloaded "
                      "(SIGHUP)", flush=True)
            else:
                self.predictor.reload_params(pf, pc)
                print("serve: weights hot-reloaded (SIGHUP)", flush=True)
            return True
        except Exception as e:  # noqa: BLE001 — keep serving on failure
            print(f"serve: weight reload FAILED, keeping current weights: "
                  f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
            return False

    def warmup(self, stage: str = "all") -> float:
        """Build and pre-run the serving device program on a zero canvas
        (--warmup; Predictor.warmup). Staged: the CLI warms
        ``stage="primary"``, the program the first queued case dispatches,
        before entering the watch loop; the loop runs ``stage="rest"`` after
        the first pending batch is served (or at once when idle). Returns
        wall seconds; sets ``self.warm`` for /healthz once the primary
        program is warm (the daemon can serve from that point)."""
        if stage in ("all", "primary"):
            self.warm = False
        t0 = time.time()
        self.predictor.warmup(probs=self.save_probs or self.save_uncertainty,
                              stage=stage)
        if stage in ("all", "primary"):
            self.warm = True
        return time.time() - t0

    def _finish_warmup_rest(self) -> None:
        """Run the deferred non-primary warmup arms once (watch loop)."""
        if not self._warmup_rest_pending:
            return
        self._warmup_rest_pending = False
        t = self.warmup(stage="rest")
        if t > 0.05:
            print(f"serve: deferred warmup done in {t:.1f}s", flush=True)

    @property
    def stopping(self) -> bool:
        return self._stop

    def _out_paths(self, case_dirs):
        if not self.output_dir:
            return None
        return [
            os.path.join(self.output_dir, os.path.basename(d) + "_pred.nii.gz")
            for d in case_dirs
        ]

    def _log(self, records) -> None:
        with open(self.log_path, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")

    def process_batch(self, case_dirs) -> list:
        """Run one pipelined batch (predict_dirs). A failing case is
        isolated by retrying the batch case by case; failures are
        quarantined (logged with an ``error`` field, marked done) so one
        corrupt upload can neither kill the daemon nor crash-loop it on
        restart. No in-batch prefill: predict_dirs' own prep threads are
        about to decode every case of this batch."""
        t0 = time.time()
        try:
            outs = self.predictor.predict_dirs(
                case_dirs, output_paths=self._out_paths(case_dirs)
            )
            errs = [None] * len(case_dirs)
        except Exception as first:  # noqa: BLE001 — isolate below
            outs, errs = [], []
            if is_sticky_device_error(first):
                self.device_lost = True
            for d in case_dirs:  # isolate the poison case
                o, e = self._predict_one_isolated(d)
                outs.append(o)
                errs.append(e)
        wall = time.time() - t0
        records = []
        for d, o, e in zip(case_dirs, outs, errs):
            rec = {
                "case": os.path.basename(d),
                "output": o,
                "batch_size": len(case_dirs),
                "batch_wall_s": round(wall, 3),
                "ts": time.time(),
            }
            if e is not None:
                msg, err_class = e
                rec["error"] = msg
                rec["error_class"] = err_class
                word = ("QUARANTINED" if err_class == "permanent"
                        else "DEFERRED (transient)")
                print(f"serve: {word} {d}: {msg}", file=sys.stderr, flush=True)
            records.append(rec)
        self._log(records)
        # served and permanently quarantined cases are done; a case whose
        # failure outlived the in-process retries but classified transient
        # stays retryable by this daemon (the next scan re-picks it)
        self.done.update(
            os.path.basename(d)
            for d, e in zip(case_dirs, errs)
            if e is None or e[1] == "permanent"
        )
        ok = sum(1 for e in errs if e is None)
        print(
            f"serve: {ok}/{len(case_dirs)} case(s) in {wall:.2f}s "
            f"({len(case_dirs) / wall:.3f} vol/s)",
            flush=True,
        )
        # best-effort artifacts of the served cases: the prediction already
        # succeeded and is logged, so an artifact failure must neither
        # quarantine the case nor stop the daemon
        if self.save_probs or self.save_uncertainty:
            from .predict import _emit_probs_artifacts

            for d, e in zip(case_dirs, errs):
                if e is not None:
                    continue
                try:
                    _emit_probs_artifacts(
                        self.predictor, [d], self.save_probs,
                        self.save_uncertainty, output_dir=self.output_dir)
                except Exception as ex:  # noqa: BLE001 — best effort
                    print(f"serve: artifact pass failed for {d}: "
                          f"{type(ex).__name__}: {ex}", file=sys.stderr,
                          flush=True)
        # publish last: an HTTP /predict waiter woken by this must find the
        # atomically renamed outputs and the artifacts in place
        self._publish(records)
        return outs

    def _predict_one_isolated(self, case_dir: str):
        """One case with transient-failure retry: a device hiccup must not
        permanently quarantine a healthy case. Retries/backoff come from
        --retries/--retry-backoff. After a CUDA error that outlives the call
        nothing is retried (no call in this process can succeed): the case
        is recorded transient and ``device_lost`` makes run() exit. Returns
        (output, None) on success or (None, (message, error_class))."""
        if self.device_lost:
            return None, ("CUDA context lost earlier in this batch",
                          "transient")
        err = None
        for attempt in range(self.retries + 1):
            try:
                return (
                    self.predictor.predict_dirs(
                        [case_dir], output_paths=self._out_paths([case_dir])
                    )[0],
                    None,
                )
            except Exception as e:  # noqa: BLE001 — classify below
                msg = f"{type(e).__name__}: {e}"
                err = (msg, classify_failure(e))
                if is_sticky_device_error(e):
                    self.device_lost = True
                    return None, err
                if err[1] == "transient" and attempt < self.retries:
                    backoff = self.retry_backoff * (2 ** attempt)
                    print(
                        f"serve: transient failure on {case_dir}, retrying "
                        f"in {backoff:.1f}s: {msg[:200]}",
                        file=sys.stderr, flush=True,
                    )
                    time.sleep(backoff)
                    continue
                return None, err
        return None, err

    def _publish(self, records) -> None:
        """Make completion records visible to HTTP waiters."""
        with self.results_cv:
            for rec in records:
                self.results[rec["case"]] = rec
                if rec.get("error") is None:
                    self.counters["served"] += 1
                elif rec.get("error_class") == "permanent":
                    self.counters["quarantined"] += 1
            self.results_cv.notify_all()

    def wait_result(self, case: str, timeout: float):
        """Block until ``case`` has a final record (success or permanent
        quarantine; a transient-deferred record is not final: the daemon
        retries the case at poll cadence). On timeout or daemon stop returns
        the latest record if any (possibly transient), else None."""

        def final(rec):
            return rec is not None and (
                rec.get("error") is None
                or rec.get("error_class") == "permanent"
            )

        deadline = time.time() + max(timeout, 0.0)
        with self.results_cv:
            while True:
                rec = self.results.get(case)
                if final(rec):
                    return rec
                remaining = deadline - time.time()
                if remaining <= 0 or self._stop:
                    return rec
                self.results_cv.wait(min(remaining, 1.0))

    def _mine(self, case_dir: str) -> bool:
        if self.shard is None:
            return True
        i, n = self.shard
        return shard_of(os.path.basename(case_dir), n) == i

    def scan(self, watch_root: str, sizes: dict) -> list:
        return [
            d
            for d in discover_cases(watch_root)
            if self._mine(d)
            and os.path.basename(d) not in self.done
            and _case_ready(d, sizes)
        ]

    def _lost(self) -> bool:
        if self.device_lost:
            print("serve: the CUDA context is lost; exiting with code "
                  f"{EXIT_DEVICE_LOST} so a supervisor restarts the daemon "
                  "(the completion log replays what was served)",
                  file=sys.stderr, flush=True)
        return self.device_lost

    def run(self, watch_root: str, poll: float, once: bool) -> int:
        sizes: dict = {}
        if once:
            self.scan(watch_root, sizes)  # prime the size table
            time.sleep(poll)  # a mid-upload case must see sizes change
            ready = self.scan(watch_root, sizes)
            if ready:
                self.process_batch(ready)
            return EXIT_DEVICE_LOST if self._lost() else 0
        print(f"serve: watching {watch_root} (poll {poll}s)", flush=True)
        self._last_hb = 0.0
        idle_scans = 0
        while not self._stop:
            if self._reload:
                self._reload = False
                self.reload_weights()
            self._heartbeat(poll)
            ready = self.scan(watch_root, sizes)
            idle_scans = 0 if ready else idle_scans + 1
            if ready:
                # cases beyond the first chunk wait while the device serves
                # it: prefill their payload cache in the background
                self._queue_prefill(ready[8:])
                # bounded chunks keep the heartbeat fresh under a burst
                recycle = False
                for i0 in range(0, len(ready), 8):
                    self.process_batch(ready[i0: i0 + 8])
                    self._heartbeat(poll)
                    if self._stop or self.device_lost:
                        break
                    # between chunks only: the chunk was served first, so a
                    # limit already crossed at start-up still makes progress
                    if self._over_rss_limit():
                        recycle = True
                        break
                if self._lost():
                    return EXIT_DEVICE_LOST
                if recycle:
                    return self.EXIT_RECYCLE
                self._finish_warmup_rest()
            else:
                self._finish_warmup_rest()
                # idle recycle only after two empty scans: a just-dropped
                # case needs a second sighting to become ready, and pending
                # work is served before a voluntary exit
                if idle_scans >= 2 and self._over_rss_limit():
                    return self.EXIT_RECYCLE
                time.sleep(poll)
        print("serve: drained, exiting", flush=True)
        return 0

    def _over_rss_limit(self) -> bool:
        """The --rss-limit-mb watermark (reference :872-893): True, with a
        note, once this process's resident memory reaches the limit; never
        with the limit off (0)."""
        limit = self.rss_limit_mb
        if not limit:
            return False
        rss = _self_rss_mb()
        if rss < limit:
            return False
        print(f"serve: RSS {rss:.0f} MB >= --rss-limit-mb {limit}; exiting "
              "for a supervisor restart (the completion log replays, exit "
              f"code {self.EXIT_RECYCLE})", flush=True)
        return True

    def _heartbeat(self, poll: float) -> None:
        now = time.time()
        if now - getattr(self, "_last_hb", 0.0) < max(poll, 5.0):
            return
        hb_path = os.path.join(self.log_dir, "serve_heartbeat.json")
        tmp = hb_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"ts": now, "done": len(self.done)}, f)
        os.replace(tmp, hb_path)
        self._last_hb = now


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.supervise:
        # the supervisor stays device-free (it must survive what kills the
        # child); the child re-enters main() with the same CLI minus the
        # supervisor flags
        src = list(sys.argv[1:]) if argv is None else list(argv)
        cmd = [sys.executable, "-m", "brats2019_tpu_torch.cli.serve",
               *_strip_supervisor_flags(src)]
        return supervise_loop(cmd, max_crash_restarts=args.max_crash_restarts)
    exp = resolve_experiment(args)
    infer = dataclasses.replace(exp.infer, postproc=args.postproc)
    if args.no_tta:
        infer = dataclasses.replace(infer, tta_flips=False)
    if args.no_cascade:
        infer = dataclasses.replace(infer, cascade=False)
    if args.transfer_dtype:
        infer = dataclasses.replace(infer, transfer_dtype=args.transfer_dtype)
    if args.serving_depth:
        infer = dataclasses.replace(infer, serving_depth=args.serving_depth)
    if args.prep_cache:
        infer = dataclasses.replace(infer, prep_cache_dir=args.prep_cache)
    if args.batch_volumes:
        infer = dataclasses.replace(infer, batch_volumes=args.batch_volumes)
    exp = dataclasses.replace(exp, infer=infer)

    if args.multichip:
        # the probs pass behind the artifacts is a single-device program:
        # refuse instead of serving something other than the flags promise
        for flag, name in ((args.save_probs, "--save-probs"),
                           (args.save_uncertainty, "--save-uncertainty")):
            if flag:
                print(f"error: --multichip does not compose with {name}",
                      file=sys.stderr)
                return 2
        if args.ensemble and args.multichip != "cascade":
            print("error: --ensemble composes only with --multichip "
                  "cascade (spatial/sweep are single-stage whole-canvas "
                  "programs)", file=sys.stderr)
            return 2
        multichip_mode_notes(args.multichip, exp,
                             batch_volumes=args.batch_volumes,
                             serving_depth=args.serving_depth)
    elif "," in args.device:
        print("error: a list of devices is a --multichip mesh", file=sys.stderr)
        return 2

    try:
        server = Server(
            exp, output_dir=args.output_dir, log_dir=args.watch_root,
            retries=args.retries, retry_backoff=args.retry_backoff,
            device=args.device, ensemble_workdirs=args.ensemble,
            save_probs=args.save_probs, save_uncertainty=args.save_uncertainty,
            multichip=args.multichip,
        )
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    server.rss_limit_mb = args.rss_limit_mb
    if args.warmup:
        server.warm = False  # /healthz says warm:false from the first reply
    if args.shard:
        try:
            server.shard = parse_shard(args.shard)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"serve: shard {server.shard[0]}/{server.shard[1]} of the "
              "watch root", flush=True)
    signal.signal(signal.SIGTERM, server.request_stop)
    signal.signal(signal.SIGINT, server.request_stop)
    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, server.request_reload)
    httpd = None
    if args.http is not None:
        from .http_api import start_http

        httpd = start_http(server, args.watch_root, args.http,
                           args.http_host, token=args.http_token)
    try:
        if args.warmup:
            # after start_http so /healthz answers (warm:false) meanwhile;
            # before the watch loop so the first case is warm
            print("serve: warming up (building and running the serving "
                  "program)...", flush=True)
            t = server.warmup(stage="primary")
            print(f"serve: warmup (primary program) done in {t:.1f}s",
                  flush=True)
            server._warmup_rest_pending = True
        return server.run(args.watch_root, args.poll, args.once)
    finally:
        if httpd is not None:
            httpd.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
