"""HTTP front end for the serving daemon (``serve --http PORT``); a copy
of ``brats2019_tpu/cli/http_api.py`` (standard library only), pinned to its
original by ``tests/test_torch_serve.py``. Endpoints:

  GET  /healthz                    liveness: {status, done, uptime_s, ts}
  GET  /stats                      served/failed counts + latency summary
  GET  /metrics                    the same counters, Prometheus format
  GET  /result?case=NAME[&timeout=S]   completion record for one case
  GET  /artifact?case=NAME&kind=pred   fetch a served case's output file
  POST /reload                     queue a weight hot-reload (= SIGHUP)
  POST /predict?name=NAME[&timeout=S][&format=json]
       body = tar (optionally gzipped) of the 4 modality NIfTIs
       (Content-Type application/x-tar), or JSON {"case_dir": "/path"}
       for co-located callers. Blocks until the daemon serves the case
       and returns the predicted segmentation NIfTI bytes
       (application/gzip), or the completion record with &format=json.

HTTP threads never touch the device. They only spool uploads into the
daemon's watch root, where the single device loop in ``Server.run`` picks
them up at poll cadence like file-system arrivals, and block on
``Server.wait_result``. Binds 127.0.0.1 by default. The ``probs`` and
``unc_{whole,core,enhance}`` artifact kinds exist for cases served by a
daemon started with ``--save-probs`` / ``--save-uncertainty`` (else a 404
with a hint).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import tarfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

# uploads larger than this are rejected outright (4 gzipped BraTS
# modalities are ~5-60 MB; 256 MiB covers uncompressed uploads with
# margin while bounding the per-request-thread memory on a small host)
MAX_UPLOAD_BYTES = 256 << 20
# cap on the EXTRACTED bytes of one upload — the compressed-body cap
# alone would let a small gzipped tar bomb fill the watch-root disk
MAX_EXTRACT_BYTES = 2 << 30
DEFAULT_WAIT_S = 600.0


class HttpApiError(ValueError):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _safe_case_name(name: str) -> str:
    name = (name or "").strip()
    if (
        not name
        or name != os.path.basename(name)
        or name.startswith(".")
        or "/" in name
        or "\\" in name
    ):
        raise HttpApiError(400, f"invalid case name {name!r}")
    return name


def extract_case_tar(data: bytes, dest_dir: str) -> int:
    """Safely extract an uploaded case archive: regular files only, each
    FLATTENED to its basename inside ``dest_dir`` (no paths from the
    archive ever touch the filesystem — traversal is structurally
    impossible), total extracted bytes bounded by MAX_EXTRACT_BYTES (a
    small gzipped bomb must not fill the watch-root disk). On ANY failure
    the partially-written ``dest_dir`` is removed — a half-extracted dir
    left behind would block corrected re-uploads of the same case forever.
    Returns the number of files written."""
    try:
        tf = tarfile.open(fileobj=io.BytesIO(data), mode="r:*")
    except tarfile.TarError as e:
        raise HttpApiError(400, f"unreadable tar archive: {e}")
    n = 0
    total = 0
    try:
        with tf:
            for member in tf:
                if not member.isreg():
                    continue  # dirs implied; links/devices never extracted
                base = os.path.basename(member.name.rstrip("/"))
                if not base or base.startswith("."):
                    raise HttpApiError(
                        400,
                        f"archive member with unusable name: {member.name!r}",
                    )
                src = tf.extractfile(member)
                if src is None:
                    continue
                os.makedirs(dest_dir, exist_ok=True)
                with open(os.path.join(dest_dir, base), "wb") as out:
                    while True:
                        chunk = src.read(1 << 20)
                        if not chunk:
                            break
                        total += len(chunk)
                        if total > MAX_EXTRACT_BYTES:
                            raise HttpApiError(
                                413, "archive expands past the "
                                     f"{MAX_EXTRACT_BYTES >> 20} MiB limit"
                            )
                        out.write(chunk)
                n += 1
        if n == 0:
            raise HttpApiError(400, "archive contained no files")
    except HttpApiError:
        shutil.rmtree(dest_dir, ignore_errors=True)
        raise
    except tarfile.TarError as e:
        shutil.rmtree(dest_dir, ignore_errors=True)
        raise HttpApiError(400, f"corrupt archive: {e}")
    except OSError as e:
        shutil.rmtree(dest_dir, ignore_errors=True)
        raise HttpApiError(507, f"extraction write failed: {e}")
    return n


def _latency_summary(records) -> dict:
    per_case = sorted(
        rec["batch_wall_s"] / max(rec.get("batch_size", 1), 1)
        for rec in records
        if rec.get("error") is None and "batch_wall_s" in rec
    )
    if not per_case:
        return {}

    def pct(p):
        import math

        idx = max(0, math.ceil(p * len(per_case)) - 1)  # nearest rank
        return round(per_case[min(len(per_case) - 1, idx)], 3)

    return {"p50_s": pct(0.5), "p95_s": pct(0.95), "n": len(per_case)}


def _stats_dict(app) -> dict:
    with app.results_cv:
        records = list(app.results.values())
        counters = dict(app.counters)
    return {
        # monotonic completion counts (Prometheus counter semantics) —
        # NOT the latest-record survey, which can decrease on resubmits
        "served": counters["served"],
        "quarantined": counters["quarantined"],
        "deferred": sum(
            1 for r in records
            if r.get("error") is not None
            and r.get("error_class") != "permanent"
        ),
        "done_total": len(app.done),
        "latency": _latency_summary(records),
    }


def _prometheus_text(app) -> str:
    """Prometheus exposition format of the serving counters — scrapeable
    by any standard monitoring stack, no client library needed."""
    s = _stats_dict(app)
    lines = [
        "# HELP brats_served_total cases served successfully this process",
        "# TYPE brats_served_total counter",
        f"brats_served_total {s['served']}",
        "# HELP brats_quarantined_total cases permanently quarantined",
        "# TYPE brats_quarantined_total counter",
        f"brats_quarantined_total {s['quarantined']}",
        "# HELP brats_deferred_total transient failures awaiting retry",
        "# TYPE brats_deferred_total gauge",
        f"brats_deferred_total {s['deferred']}",
        "# HELP brats_done_total done-set size incl. replayed prior runs",
        "# TYPE brats_done_total gauge",
        f"brats_done_total {s['done_total']}",
        "# HELP brats_uptime_seconds daemon uptime",
        "# TYPE brats_uptime_seconds gauge",
        f"brats_uptime_seconds {time.time() - app.started_ts:.1f}",
    ]
    lat = s["latency"]
    if lat:
        lines += [
            "# HELP brats_case_latency_seconds per-case serve latency",
            "# TYPE brats_case_latency_seconds summary",
            f'brats_case_latency_seconds{{quantile="0.5"}} {lat["p50_s"]}',
            f'brats_case_latency_seconds{{quantile="0.95"}} {lat["p95_s"]}',
            f"brats_case_latency_seconds_count {lat['n']}",
        ]
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    # self.server is the _ApiServer below (.app = serve.Server instance)
    protocol_version = "HTTP/1.1"

    def _authorized(self) -> bool:
        """Optional shared-secret gate (`serve --http-token`). Constant-
        time comparison; /healthz stays open so probes don't need the
        secret."""
        token = self.server.token
        if not token:
            return True
        got = self.headers.get("Authorization", "")
        import hmac

        # compare BYTES: compare_digest on str raises TypeError for
        # non-ASCII (header values arrive latin-1-decoded), which would
        # escape the HttpApiError handlers and drop the connection
        return hmac.compare_digest(
            got.encode("utf-8", "surrogateescape"),
            f"Bearer {token}".encode("utf-8", "surrogateescape"),
        )

    # ------------------------------------------------------------------ util

    def _send_json(self, code: int, obj: dict) -> None:
        body = (json.dumps(obj) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if code >= 400:
            # an errored request may have an unread body; never let the
            # leftover bytes be parsed as the next keep-alive request
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(body)

    def _send_file(self, path: str) -> None:
        """Stream a file at constant memory (probs npz can be tens of MB;
        N concurrent fetches must not each hold the whole file). Raises
        HttpApiError(404) if the file vanished between check and open."""
        try:
            f = open(path, "rb")
            size = os.fstat(f.fileno()).st_size
        except OSError:
            raise HttpApiError(404, f"artifact vanished: "
                                    f"{os.path.basename(path)}")
        with f:
            self.send_response(200)
            ctype = ("application/gzip" if path.endswith(".gz")
                     else "application/octet-stream")
            self.send_header("Content-Type", ctype)
            self.send_header(
                "Content-Disposition",
                f'attachment; filename="{os.path.basename(path)}"',
            )
            self.send_header("Content-Length", str(size))
            self.end_headers()
            shutil.copyfileobj(f, self.wfile, length=1 << 20)

    def log_message(self, fmt, *args):  # route through the daemon's stdout
        print(f"serve-http: {self.address_string()} {fmt % args}", flush=True)

    def _query(self):
        u = urlparse(self.path)
        return u.path, {k: v[-1] for k, v in parse_qs(u.query).items()}

    @staticmethod
    def _float_param(q, key, default):
        """Query floats must 400 on garbage, not drop the connection with
        an uncaught ValueError."""
        try:
            return float(q.get(key, default))
        except (TypeError, ValueError):
            raise HttpApiError(400, f"query param {key!r} must be a number, "
                                    f"got {q.get(key)!r}")

    # ----------------------------------------------------------------- GET

    def do_GET(self):  # noqa: N802 (stdlib naming)
        app = self.server.app
        path, q = self._query()
        try:
            if path != "/healthz" and not self._authorized():
                raise HttpApiError(401, "missing/invalid Authorization "
                                        "bearer token")
            if path == "/healthz":
                body = {
                    "status": "stopping" if app.stopping else "ok",
                    "done": len(app.done),
                    "uptime_s": round(time.time() - app.started_ts, 1),
                    "ts": time.time(),
                }
                # readiness signal for supervisors when --warmup was
                # requested (None = warmup off: field omitted, the daemon
                # compiles lazily on the first case as always)
                if getattr(app, "warm", None) is not None:
                    body["warm"] = bool(app.warm)
                self._send_json(200, body)
            elif path == "/stats":
                self._send_json(200, _stats_dict(app))
            elif path == "/metrics":
                body = _prometheus_text(app).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/artifact":
                self._serve_artifact(app, q)
            elif path == "/result":
                name = _safe_case_name(q.get("case", ""))
                rec = app.wait_result(name,
                                      self._float_param(q, "timeout", 0.0))
                if rec is None:
                    if name in app.done:
                        # served/quarantined by a PREVIOUS daemon run —
                        # the replayed done-set has no record payload
                        self._send_json(200, {
                            "case": name, "done": True,
                            "note": "completed in a previous daemon run "
                                    "(see serve_log.jsonl)",
                        })
                    else:
                        self._send_json(404, {"error": f"no result for "
                                                       f"{name!r}"})
                else:
                    self._send_json(200, rec)
            else:
                self._send_json(404, {"error": f"unknown path {path!r}"})
        except HttpApiError as e:
            self._send_json(e.code, {"error": str(e)})

    # artifact kinds -> the FIXED filename patterns the daemon writes
    # (cli/predict.py _emit_probs_artifacts + Server._out_paths); only
    # these names are ever served — no path from the client touches disk
    _ARTIFACTS = {
        "pred": "{case}_pred.nii.gz",
        "probs": "{case}_probs.npz",
        "unc_whole": "{case}_unc_whole.nii.gz",
        "unc_core": "{case}_unc_core.nii.gz",
        "unc_enhance": "{case}_unc_enhance.nii.gz",
    }

    def _serve_artifact(self, app, q) -> None:
        """GET /artifact?case=X&kind=pred|probs|unc_* — fetch a served
        case's output files (the --save-probs / --save-uncertainty QA
        artifacts land next to the prediction; remote clients need a way
        to retrieve them)."""
        name = _safe_case_name(q.get("case", ""))
        kind = q.get("kind", "pred")
        if kind not in self._ARTIFACTS:
            raise HttpApiError(
                400, f"kind must be one of {sorted(self._ARTIFACTS)}"
            )
        base_dir = getattr(app, "output_dir", None) or os.path.join(
            self.server.watch_root, name
        )
        path = os.path.join(base_dir, self._ARTIFACTS[kind].format(case=name))
        if not os.path.exists(path):
            if kind == "pred":
                hint = ("case not served yet or unknown — check "
                        "GET /result?case=...")
            else:
                hint = "was the daemon started with the matching --save-* flag?"
            raise HttpApiError(404, f"no {kind} artifact for {name!r} ({hint})")
        self._send_file(path)

    # ---------------------------------------------------------------- POST

    def do_POST(self):  # noqa: N802
        app = self.server.app
        path, q = self._query()
        try:
            if not self._authorized():
                raise HttpApiError(401, "missing/invalid Authorization "
                                        "bearer token")
            if path == "/reload":
                # HTTP twin of SIGHUP for deployments where signaling the
                # process is awkward; the swap happens on the daemon loop
                # (never in a request thread), so this only queues it
                app.request_reload()
                self._send_json(202, {"reload": "queued"})
                return
            if path != "/predict":
                raise HttpApiError(404, f"unknown path {path!r}")
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                raise HttpApiError(400, "malformed Content-Length")
            if length <= 0:
                raise HttpApiError(411, "Content-Length required")
            if length > MAX_UPLOAD_BYTES:
                raise HttpApiError(413, "upload too large")
            timeout = self._float_param(q, "timeout", DEFAULT_WAIT_S)
            body = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]

            if ctype == "application/json":
                name = self._submit_json(app, body)
            else:
                name = self._submit_tar(app, body, q.get("name", ""))

            if name in app.done and name not in app.results:
                # completed by a PREVIOUS daemon run (restart replay):
                # scan() will never reprocess it, so waiting would block
                # the full timeout and 504 forever
                self._send_json(200, {
                    "case": name, "done": True,
                    "note": "completed in a previous daemon run "
                            "(see serve_log.jsonl)",
                })
                return
            rec = app.wait_result(name, timeout)
            if rec is None:
                raise HttpApiError(
                    504, f"case {name!r} not completed within {timeout}s "
                         "(still queued — poll GET /result)"
                )
            if rec.get("error") is not None:
                code = 422 if rec.get("error_class") == "permanent" else 503
                raise HttpApiError(
                    code, f"prediction failed ({rec.get('error_class')}): "
                          f"{rec['error']}"
                )
            if q.get("format") == "json":
                self._send_json(200, rec)
            else:
                self._send_file(rec["output"])
        except HttpApiError as e:
            self._send_json(e.code, {"error": str(e)})

    def _submit_json(self, app, body: bytes) -> str:
        """Co-located submission: {"case_dir": "/abs/path"} — symlinked
        into the watch root so the daemon discovers it like any arrival."""
        try:
            req = json.loads(body)
            case_dir = req["case_dir"]
        except (ValueError, KeyError, TypeError):
            raise HttpApiError(400, 'body must be {"case_dir": "/path"}')
        case_dir = os.path.abspath(case_dir)
        if not os.path.isdir(case_dir):
            raise HttpApiError(400, f"not a directory: {case_dir}")
        name = _safe_case_name(os.path.basename(os.path.normpath(case_dir)))
        link = os.path.join(self.server.watch_root, name)
        if os.path.realpath(link) != os.path.realpath(case_dir):
            try:
                os.symlink(case_dir, link)
            except FileExistsError:
                # concurrent submission of the SAME case_dir races here
                # (realpath of a missing link is the link path itself) —
                # only a genuinely different target is a conflict
                if os.path.realpath(link) != os.path.realpath(case_dir):
                    raise HttpApiError(
                        409,
                        f"a different case named {name!r} already exists",
                    )
        return name

    def _submit_tar(self, app, body: bytes, name: str) -> str:
        name = _safe_case_name(name)
        dest = os.path.join(self.server.watch_root, name)
        if name in app.done or os.path.isdir(dest):
            # idempotent: an already-known case is not re-extracted
            # (failed extractions/validations below never leave a dir)
            return name
        extract_case_tar(body, dest)
        # validate NOW that the archive actually forms a case for `name`
        # (modality files are keyed <dirname>_<mod>.nii[.gz]) — otherwise
        # the daemon would never see it ready and the client would block
        # its whole timeout for a 504
        from ..data.case import modality_paths

        try:
            modality_paths(dest)
        except FileNotFoundError as e:
            shutil.rmtree(dest, ignore_errors=True)
            raise HttpApiError(
                400, f"archive is not a complete case for {name!r}: {e}"
            )
        return name


class _ApiServer(ThreadingHTTPServer):
    daemon_threads = True
    # request threads only spool files + wait; they must not inherit a
    # huge backlog
    request_queue_size = 16

    def __init__(self, addr, app, watch_root, token=None):
        self.app = app
        self.watch_root = watch_root
        self.token = token
        super().__init__(addr, _Handler)


def start_http(app, watch_root: str, port: int, host: str = "127.0.0.1",
               token: str = None):
    """Start the HTTP API on a daemon thread. Returns the HTTPServer
    (use ``.server_address`` for the bound port, ``.shutdown()`` to
    stop). ``token`` gates every endpoint except /healthz behind
    ``Authorization: Bearer <token>``."""
    httpd = _ApiServer((host, port), app, watch_root, token=token)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="serve-http")
    t.start()
    print(f"serve: HTTP API on http://{host}:{httpd.server_address[1]} "
          "(endpoints: /healthz /stats /metrics /result /artifact "
          "/predict)", flush=True)
    return httpd
