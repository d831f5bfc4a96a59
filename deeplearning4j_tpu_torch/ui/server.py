"""The training UI and serving HTTP server (the port of
``deeplearning4j_tpu/ui/server.py``: its routes on a stdlib
``ThreadingHTTPServer``).

    GET  /, /index.html    the sessions of every attached stats storage
    GET  /train/<i>/<sid>  storage ``i``'s session ``sid`` as the dashboard
                    page (``render_session_html``)
    GET  /trace     the ``obs.trace`` ring buffer as Chrome trace-event JSON
                    (an empty trace with a hint while tracing is off)
    POST /remote    {"session_id", "record"} or a list of them, stored in
                    the first attached storage (``RemoteStatsRouter``'s
                    posts): 403 unless ``enable_remote_listener()``, 503
                    with no storage attached, 200 stored, 400 malformed

    POST /predict   {"inputs": [[...]], "slo_ms"?, "tenant"?, "model"?} →
                    {"outputs", "model"} through an attached predict
                    ``Engine`` (``model`` names a placed named model,
                    ``tenant`` the request's tenant lane and quota)
    POST /generate  {"prompt_ids": [...], "max_tokens"?, "temperature"?,
                    "top_k"?, "top_p"?, "seed"?, "slo_ms"?, "tenant"?,
                    "model"?} → {"tokens", "n_prompt", "finish_reason",
                    "model", "ttft_ms", "tpot_ms"} through an attached
                    ``DecodeEngine`` (or a ``FleetRouter``); a
                    prefill-role engine answers 409 ``prefill_role``
    GET  /healthz   readiness of every attached engine (200 / 503)
    GET  /metrics   {"serving": [one snapshot per attached provider],
                    "sessions": {sid: {"updates", "last_iteration",
                    "last_score"}} over the attached storages,
                    "registry": the process-wide ``obs.metrics`` registry's
                    snapshot (every live engine's metrics as a collector)}

Every error is structured JSON with a stable ``error_class``: 429
``tenant_overloaded`` (with ``tenant``, ``shed_count`` and ``reason``: a
tenant's own quota) or ``overloaded``, 404 ``model_not_loaded``, 504
``deadline_exceeded``, 422 ``poison_input``, 500 ``replica_failure``, 400
``bad_request``, 503 ``unavailable``, 500 ``internal`` (exception type
and message only, never a traceback).
"""

from __future__ import annotations

import html
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from .render import render_session_html


def _error_reply(e: BaseException):
    """(status, payload) of a request that raised ``e``.  The order is the
    reference's: the typed serving errors before ``ValueError`` and its
    kin, so a poison input answers 422, never 400."""
    from ..serving import (DeadlineExceededError, ModelNotLoadedError,
                           OverloadedError, PoisonInputError, ReplicaCrashError,
                           ReplicaHungError, TenantOverloadedError)
    if isinstance(e, TenantOverloadedError):
        # the tenant's own quota, not the engine's: clients back off
        # rather than retry elsewhere
        return 429, {"error": str(e), "error_class": "tenant_overloaded",
                     "tenant": e.tenant, "shed_count": e.shed_count,
                     "reason": e.reason}
    if isinstance(e, OverloadedError):
        return 429, {"error": str(e), "error_class": "overloaded"}
    if isinstance(e, ModelNotLoadedError):
        return 404, {"error": str(e), "error_class": "model_not_loaded"}
    if isinstance(e, DeadlineExceededError):
        return 504, {"error": str(e), "error_class": "deadline_exceeded"}
    if isinstance(e, PoisonInputError):
        return 422, {"error": str(e), "error_class": "poison_input"}
    if isinstance(e, (ReplicaCrashError, ReplicaHungError)):
        return 500, {"error": str(e), "error_class": "replica_failure"}
    if isinstance(e, (KeyError, ValueError, TypeError)):
        return 400, {"error": f"{type(e).__name__}: {e}", "error_class": "bad_request"}
    return 500, {"error": f"{type(e).__name__}: {e}", "error_class": "internal"}


class UIServer:
    """``UIServer(port).attach(storage).start()`` → browse /;
    ``attach_engine(eng)`` → POST /predict."""

    def __init__(self, port: int = 9000, host: str = "127.0.0.1",
                 enable_remote: bool = False):
        self.port = port
        self.host = host
        self.enable_remote = enable_remote
        self._storages: List = []
        self._metrics_providers: List = []
        self._engine = None
        self._decode_engine = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def attach(self, storage) -> "UIServer":
        """Serve a stats storage's sessions on / and /train/<i>/<sid>, count
        them in /metrics ``sessions``; the first attached one receives
        POST /remote."""
        self._storages.append(storage)
        return self

    def enable_remote_listener(self) -> "UIServer":
        """Accept POSTed stats on /remote into the first attached storage
        (reference RemoteReceiverModule: UIServer.enableRemoteListener())."""
        self.enable_remote = True
        return self

    def attach_metrics(self, provider) -> "UIServer":
        """Export a metrics source on GET /metrics: a zero-argument
        callable returning a JSON-able dict, or an object with
        ``snapshot()``."""
        self._metrics_providers.append(provider)
        return self

    def attach_engine(self, engine) -> "UIServer":
        """Serve POST /predict through a predict ``Engine`` and export its
        metrics on /metrics."""
        self._engine = engine
        return self.attach_metrics(engine.metrics_snapshot)

    def attach_decode_engine(self, engine) -> "UIServer":
        """Serve POST /generate through a ``DecodeEngine`` and export its
        TTFT/TPOT histograms and counters on /metrics."""
        self._decode_engine = engine
        return self.attach_metrics(engine.metrics_snapshot)

    def _metrics_json(self) -> str:
        from ..obs.metrics import get_registry
        serving = [p() if callable(p) else p.snapshot()
                   for p in self._metrics_providers]
        sessions = {}
        for storage in self._storages:
            for sid in storage.list_session_ids():
                ups = storage.get_updates(sid)
                last = ups[-1] if ups else {}
                sessions[sid] = {"updates": len(ups),
                                 "last_iteration": last.get("iteration"),
                                 "last_score": last.get("score")}
        return json.dumps({"serving": serving, "sessions": sessions,
                           "registry": get_registry().snapshot()})

    def _trace_json(self) -> str:
        """GET /trace: the ring buffer as a Chrome trace-event JSON object;
        an empty trace with a hint when tracing is off."""
        from ..obs import trace as obs_trace
        rec = obs_trace.get_recorder()
        if rec is None:
            return json.dumps({"traceEvents": [], "metadata": {
                "tracing": "disabled — enable with --trace PATH or "
                           "obs.enable_tracing()"}})
        return json.dumps(rec.export())

    def _handle_remote(self, body: bytes) -> int:
        """POST /remote body: {"session_id": ..., "record": {...}} or a list
        of such — returns the HTTP status."""
        if not self.enable_remote:
            return 403
        if not self._storages:
            return 503
        payload = json.loads(body)
        items = payload if isinstance(payload, list) else [payload]
        for item in items:
            self._storages[0].put_update(item["session_id"], item["record"])
        return 200

    def _render_index(self) -> str:
        rows = []
        for si, storage in enumerate(self._storages):
            for sid in storage.list_session_ids():
                href = f"/train/{si}/{urllib.parse.quote(sid, safe='')}"
                rows.append(f'<li><a href="{href}">'
                            f"{html.escape(sid)}</a></li>")
        return ("<html><body><h1>deeplearning4j_tpu UI</h1><ul>"
                + "".join(rows) + "</ul></body></html>")

    def _predict_json(self, body: bytes):
        """(status, payload) for POST /predict."""
        if self._engine is None:
            return 503, {"error": "no serving engine attached",
                         "error_class": "unavailable"}
        try:
            payload = json.loads(body)
            x = np.asarray(payload["inputs"], np.float32)
            kw = {}
            # the tenancy fields go on only when present, so a duck-typed
            # engine without them still serves
            if payload.get("tenant") is not None:
                kw["tenant"] = str(payload["tenant"])
            if payload.get("model") is not None:
                kw["model"] = str(payload["model"])
            out = self._engine.output(x, slo_ms=payload.get("slo_ms"), **kw)
            return 200, {"outputs": np.asarray(out).tolist(),
                         "model": self._engine.current_tag}
        except Exception as e:  # model exceptions too: no traceback leaks
            return _error_reply(e)

    def _generate_json(self, body: bytes):
        """(status, payload) for POST /generate; a deadline hit in the
        middle of decoding answers 200 with ``finish_reason: "deadline"``
        and the tokens made inside the budget."""
        if self._decode_engine is None:
            return 503, {"error": "no decode engine attached",
                         "error_class": "unavailable"}
        if getattr(self._decode_engine, "role", "unified") == "prefill":
            # a prefill host's result is a page handoff, not tokens: only
            # a fleet router can carry it on to a decode-role host
            return 409, {"error": "this host is a prefill-role engine; "
                                  "its output is a KV-page handoff, not "
                                  "tokens — send /generate traffic to a "
                                  "fleet router or a unified/decode host",
                         "error_class": "prefill_role"}
        try:
            payload = json.loads(body)
            kw = {}
            if payload.get("tenant") is not None:
                kw["tenant"] = str(payload["tenant"])
            if payload.get("model") is not None:
                kw["model"] = str(payload["model"])
            res = self._decode_engine.generate(
                payload["prompt_ids"],
                max_new_tokens=payload.get("max_tokens"),
                temperature=payload.get("temperature", 0.0),
                top_k=payload.get("top_k", 0),
                top_p=payload.get("top_p", 1.0),
                seed=payload.get("seed", 0),
                slo_ms=payload.get("slo_ms"), **kw)
            return 200, {"tokens": res.tokens, "n_prompt": res.n_prompt,
                         "finish_reason": res.finish_reason,
                         "model": res.model_tag, "ttft_ms": res.ttft_ms,
                         "tpot_ms": res.tpot_ms}
        except Exception as e:
            return _error_reply(e)

    def _healthz_json(self):
        """(status, payload) for GET /healthz: 200 when every attached
        engine is ready, 503 when none is attached or one is not."""
        engines = {}
        if self._engine is not None:
            engines["predict"] = self._engine
        if self._decode_engine is not None:
            engines["decode"] = self._decode_engine
        if not engines:
            return 503, {"status": "unready", "ready": False,
                         "error": "no serving engine attached"}

        def snap(e):
            s = e.health_snapshot()
            tag = getattr(e, "current_tag", None)
            if tag and "model" not in s:
                s["model"] = tag
            return s

        if len(engines) == 1:
            s = snap(next(iter(engines.values())))
            return (200 if s.get("ready") else 503), s
        per = {k: snap(e) for k, e in engines.items()}
        ready = all(s.get("ready") for s in per.values())
        status = ("ok" if all(s.get("status") == "ok" for s in per.values())
                  else "degraded" if ready else "unready")
        return (200 if ready else 503), {"status": status, "ready": ready,
                                         "engines": per}

    def start(self) -> "UIServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no per-request logging
                pass

            def _reply(self, code, data: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _json(self, code, payload):
                self._reply(code, json.dumps(payload).encode(), "application/json")

            def do_GET(self):
                try:
                    path = urllib.parse.urlsplit(self.path).path
                    if path == "/metrics":
                        self._reply(200, server._metrics_json().encode(), "application/json")
                    elif path == "/trace":
                        self._reply(200, server._trace_json().encode(), "application/json")
                    elif path == "/healthz":
                        self._json(*server._healthz_json())
                    elif path.startswith("/train/"):
                        _, _, si, sid = path.split("/", 3)
                        page = render_session_html(server._storages[int(si)],
                                                   urllib.parse.unquote(sid))
                        self._reply(200, page.encode(), "text/html; charset=utf-8")
                    elif path in ("", "/", "/index.html"):
                        self._reply(200, server._render_index().encode(),
                                    "text/html; charset=utf-8")
                    else:   # unknown paths are 404s, not the index page
                        self._reply(404, b"not found", "text/plain")
                except Exception as e:  # a bad storage index, a broken record
                    self._reply(500, str(e).encode(), "text/plain")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                if self.path == "/predict":
                    self._json(*server._predict_json(self.rfile.read(n)))
                elif self.path == "/generate":
                    self._json(*server._generate_json(self.rfile.read(n)))
                elif self.path == "/remote":
                    try:
                        code = server._handle_remote(self.rfile.read(n))
                    except Exception:   # malformed body or record
                        code = 400
                    self._reply(code, b"", "text/plain")
                else:
                    self._reply(404, b"not found", "text/plain")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolves port=0
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="ui-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
