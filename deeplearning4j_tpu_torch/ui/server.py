"""The serving HTTP server (mirrors ``deeplearning4j_tpu/ui/server.py``:
the routes of the serving engines on a stdlib ``ThreadingHTTPServer``).

    POST /predict   {"inputs": [[...]], "slo_ms"?, "tenant"?, "model"?} →
                    {"outputs", "model"} through an attached predict
                    ``Engine`` (``model`` names a placed named model,
                    ``tenant`` the request's tenant lane and quota)
    POST /generate  {"prompt_ids": [...], "max_tokens"?, "temperature"?,
                    "top_k"?, "top_p"?, "seed"?, "slo_ms"?} → {"tokens",
                    "n_prompt", "finish_reason", "model", "ttft_ms",
                    "tpot_ms"} through an attached ``DecodeEngine``
    GET  /healthz   readiness of every attached engine (200 / 503)
    GET  /metrics   {"serving": [one snapshot per attached provider],
                    "registry": the process-wide ``obs.metrics`` registry's
                    snapshot (every live engine's metrics as a collector)}

Every error is structured JSON with a stable ``error_class``: 429
``tenant_overloaded`` (with ``tenant``, ``shed_count`` and ``reason``: a
tenant's own quota) or ``overloaded``, 404 ``model_not_loaded``, 504
``deadline_exceeded``, 422 ``poison_input``, 500 ``replica_failure``, 400
``bad_request``, 503 ``unavailable``, 500 ``internal`` (exception type
and message only, never a traceback).  The reference's stats sessions,
dashboard, ``/trace`` and ``/remote`` are not ported here.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np


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
    """``UIServer(port).attach_engine(eng).start()`` → POST /predict."""

    def __init__(self, port: int = 9000, host: str = "127.0.0.1"):
        self.port = port
        self.host = host
        self._metrics_providers: List = []
        self._engine = None
        self._decode_engine = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

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
        return json.dumps({"serving": serving, "registry": get_registry().snapshot()})

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
        try:
            payload = json.loads(body)
            res = self._decode_engine.generate(
                payload["prompt_ids"],
                max_new_tokens=payload.get("max_tokens"),
                temperature=payload.get("temperature", 0.0),
                top_k=payload.get("top_k", 0),
                top_p=payload.get("top_p", 1.0),
                seed=payload.get("seed", 0),
                slo_ms=payload.get("slo_ms"))
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
                path = urllib.parse.urlsplit(self.path).path
                if path == "/metrics":
                    self._reply(200, server._metrics_json().encode(), "application/json")
                elif path == "/healthz":
                    self._json(*server._healthz_json())
                else:
                    self._reply(404, b"not found", "text/plain")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                if self.path == "/predict":
                    self._json(*server._predict_json(self.rfile.read(n)))
                elif self.path == "/generate":
                    self._json(*server._generate_json(self.rfile.read(n)))
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
