"""Remote stats routing — train in one process, dashboard in another (the
port of ``deeplearning4j_tpu/ui/remote.py``: the same wire format, so a
router of either package posts to a server of either).

Parity targets: reference
deeplearning4j-core/.../api/storage/impl/RemoteUIStatsStorageRouter.java:32
(HTTP-POSTs serialized stats records to a UIServer with retry/backoff) and
deeplearning4j-ui-parent/deeplearning4j-play/.../module/remote/
RemoteReceiverModule.java (the /remote receiver endpoint).

``RemoteStatsRouter`` implements the same ``put_update(session_id,
record)`` surface as ui/storage.py's storages, so a ``StatsListener`` can
write to it unchanged; records become JSON POSTs to the receiving
``UIServer(enable_remote=True)`` (or ``enable_remote_listener()``).  Failed posts are retried with capped
exponential backoff, then buffered and flushed on the next success —
matching the reference's retryCount/retryBackoffFactor semantics without
a background thread (posts happen on the listener's throttled cadence)."""

from __future__ import annotations

import json
import logging
import time
import urllib.error
import urllib.request
from typing import List, Optional

from ..obs import trace as obs_trace
from ..obs.metrics import get_registry

logger = logging.getLogger("deeplearning4j_tpu_torch")


class RemoteStatsRouter:
    """StatsStorage-shaped router that POSTs updates to a remote UIServer.

    >>> router = RemoteStatsRouter("http://ui-host:9000")
    >>> net.add_listener(StatsListener(router))
    """

    def __init__(self, url: str, max_retries: int = 3,
                 backoff: float = 0.25, timeout: float = 5.0,
                 max_buffer: int = 1000):
        self.url = url.rstrip("/") + "/remote"
        self.max_retries = max_retries
        self.backoff = backoff
        self.timeout = timeout
        self.max_buffer = max_buffer
        self._pending: List[dict] = []
        self.dropped = 0
        # silent data loss is the failure mode a dashboard can't show:
        # dropped records count into the unified registry and the FIRST
        # drop warns loudly (once — steady-state drops would spam)
        self._dropped_counter = get_registry().counter(
            "ui_remote_dropped_records_total")
        self._drop_warned = False

    # -- StatsStorage surface (ui/storage.py contract) ---------------------

    def put_update(self, session_id: str, record: dict) -> None:
        self._pending.append({"session_id": session_id, "record": record})
        self.flush()

    def register_listener(self, fn) -> None:  # router has no local readers
        raise NotImplementedError(
            "RemoteStatsRouter is write-only — attach a storage on the "
            "UIServer side to read")

    def close(self) -> None:
        self.flush()

    # -- transport ---------------------------------------------------------

    def _post(self, items: List[dict]) -> bool:
        data = json.dumps(items).encode()
        delay = self.backoff
        for attempt in range(self.max_retries):
            try:
                req = urllib.request.Request(
                    self.url, data=data,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return 200 <= r.status < 300
            except (urllib.error.URLError, OSError) as e:
                if attempt == self.max_retries - 1:
                    logger.warning("remote stats POST failed after %d tries: "
                                   "%s — buffering %d record(s)",
                                   self.max_retries, e, len(items))
                    return False
                time.sleep(delay)
                delay *= 2
        return False

    def flush(self) -> bool:
        """Try to deliver everything buffered; keep (bounded) on failure."""
        if not self._pending:
            return True
        if self._post(self._pending):
            self._pending = []
            return True
        overflow = len(self._pending) - self.max_buffer
        if overflow > 0:
            # drop OLDEST records; a dashboard cares about the recent ones
            self._pending = self._pending[overflow:]
            self.dropped += overflow
            self._dropped_counter.inc(overflow)
            obs_trace.instant("ui/remote_drop", cat="ui", dropped=overflow,
                              total_dropped=self.dropped)
            if not self._drop_warned:
                self._drop_warned = True
                logger.warning(
                    "RemoteStatsRouter is DROPPING stats records: buffer "
                    "full (max_buffer=%d) while %s is unreachable — %d "
                    "record(s) discarded so far; this warning fires once, "
                    "watch the ui_remote_dropped_records_total counter "
                    "(/metrics) for the running total",
                    self.max_buffer, self.url, self.dropped)
        return False
