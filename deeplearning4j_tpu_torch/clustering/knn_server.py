"""K-nearest-neighbors REST server + client.

Parity target: reference
deeplearning4j-nearestneighbors-parent/deeplearning4j-nearestneighbor-server/
.../NearestNeighborsServer.java:42 (Play REST server over a VPTree index:
POST /knn — neighbors of an already-indexed point by id; POST /knnnew —
neighbors of a posted vector) and the sibling client module
(NearestNeighborsClient).

The port of ``deeplearning4j_tpu/clustering/knn_server.py``: the index is
the port's brute-force ``NearestNeighbors`` (clustering/knn.py, points on
the card) instead of a VPTree, served by the same stdlib
``ThreadingHTTPServer``.  The routes and the JSON (ids + distances,
matching the reference's NearestNeighborsResults shape) are the
reference's, so either package's client talks to either's server.  A
``/knn`` query reads its point from the index on the device, never a host
copy of the whole index.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from ..utils.device import DeviceLike
from .knn import NearestNeighbors


class NearestNeighborsServer:
    """``NearestNeighborsServer(points).start()`` → POST /knn, /knnnew; the
    index lives on ``device`` (default the card).

    /knn     {"id": int, "k": int}        → neighbors of indexed point
    /knnnew  {"vector": [...], "k": int}  → neighbors of a new vector
    Responses: {"results": [{"index": i, "distance": d}, ...]}
    """

    def __init__(self, points, metric: str = "euclidean",
                 host: str = "127.0.0.1", port: int = 0,
                 device: DeviceLike = None):
        self.index = NearestNeighbors(points, metric=metric, device=device)
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "NearestNeighborsServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code: int, payload: dict) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    k = int(req.get("k", 5))
                    if self.path == "/knn":
                        idx = int(req["id"])
                        pts = server.index.points
                        if not (0 <= idx < pts.shape[0]):
                            return self._reply(400, {"error": f"id {idx} out of "
                                                     f"range [0,{pts.shape[0]})"})
                        # k+1 then drop the query point itself (reference
                        # /knn semantics: neighbors of an indexed point)
                        d, i = server.index.knn(pts[idx][None, :], k + 1)
                        pairs = [(int(ii), float(dd))
                                 for dd, ii in zip(d[0], i[0]) if ii != idx][:k]
                    elif self.path == "/knnnew":
                        vec = np.asarray(req["vector"], np.float32)
                        d, i = server.index.knn(vec[None, :], k)
                        pairs = [(int(ii), float(dd)) for dd, ii in zip(d[0], i[0])]
                    else:
                        return self._reply(404, {"error": f"no route {self.path}"})
                    self._reply(200, {"results": [
                        {"index": ii, "distance": dd} for ii, dd in pairs]})
                except (KeyError, ValueError, TypeError) as e:
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()


class NearestNeighborsClient:
    """HTTP client for NearestNeighborsServer (reference
    deeplearning4j-nearestneighbors-client's NearestNeighborsClient)."""

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _post(self, route: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.url + route, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def knn(self, index: int, k: int) -> List[dict]:
        """Neighbors of an indexed point: [{"index", "distance"}, ...]."""
        return self._post("/knn", {"id": index, "k": k})["results"]

    def knn_new(self, vector, k: int) -> List[dict]:
        """Neighbors of a new vector."""
        return self._post("/knnnew", {"vector": np.asarray(vector).tolist(),
                                      "k": k})["results"]
