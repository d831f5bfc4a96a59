"""Stats storage — the persistence seam between collection and rendering
(the port of ``deeplearning4j_tpu/ui/storage.py``, host code copied: a
file or database written by either package is read by the other).

Parity target: reference api/storage/StatsStorage.java +
InMemoryStatsStorage / FileStatsStorage / (MapDB) implementations.
Records are plain JSON dicts keyed by (session_id, worker_id, timestamp);
listeners can attach to storage for live routing (the reference's
StatsStorageListener callback path)."""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import Callable, Dict, List, Optional


class BaseStatsStorage:
    """put_update / list_session_ids / get_updates + routing callbacks."""

    def __init__(self):
        self._listeners: List[Callable[[str, dict], None]] = []

    def register_listener(self, fn: Callable[[str, dict], None]) -> None:
        self._listeners.append(fn)

    def _notify(self, session_id: str, record: dict) -> None:
        for fn in self._listeners:
            fn(session_id, record)

    # -- implemented by subclasses --
    def put_update(self, session_id: str, record: dict) -> None:
        raise NotImplementedError

    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def get_updates(self, session_id: str) -> List[dict]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryStatsStorage(BaseStatsStorage):
    """Reference InMemoryStatsStorage: ephemeral, for tests/UI sessions."""

    def __init__(self):
        super().__init__()
        self._data: Dict[str, List[dict]] = {}
        self._lock = threading.Lock()

    def put_update(self, session_id: str, record: dict) -> None:
        with self._lock:
            self._data.setdefault(session_id, []).append(record)
        self._notify(session_id, record)

    def list_session_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._data)

    def get_updates(self, session_id: str) -> List[dict]:
        with self._lock:
            return list(self._data.get(session_id, []))


class FileStatsStorage(BaseStatsStorage):
    """JSONL-per-session directory (reference FileStatsStorage's role:
    durable single-machine storage; JSONL instead of MapDB)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._lock = threading.Lock()

    def _file(self, session_id: str) -> str:
        safe = session_id.replace("/", "_")
        return os.path.join(self.path, f"{safe}.jsonl")

    def put_update(self, session_id: str, record: dict) -> None:
        with self._lock, open(self._file(session_id), "a") as f:
            f.write(json.dumps(record) + "\n")
        self._notify(session_id, record)

    def list_session_ids(self) -> List[str]:
        return sorted(os.path.splitext(f)[0] for f in os.listdir(self.path)
                      if f.endswith(".jsonl"))

    def get_updates(self, session_id: str) -> List[dict]:
        p = self._file(session_id)
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return [json.loads(line) for line in f if line.strip()]


class SqliteStatsStorage(BaseStatsStorage):
    """Sqlite-backed storage — concurrent-reader friendly, queryable."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS updates ("
            "session_id TEXT, iteration INTEGER, record TEXT)")
        self._conn.execute(
            "CREATE INDEX IF NOT EXISTS idx_session ON updates(session_id)")
        self._conn.commit()

    def put_update(self, session_id: str, record: dict) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO updates VALUES (?, ?, ?)",
                (session_id, int(record.get("iteration", 0)), json.dumps(record)))
            self._conn.commit()
        self._notify(session_id, record)

    def list_session_ids(self) -> List[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT session_id FROM updates ORDER BY session_id")
            return [r[0] for r in rows.fetchall()]

    def get_updates(self, session_id: str) -> List[dict]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT record FROM updates WHERE session_id=? ORDER BY iteration",
                (session_id,))
            return [json.loads(r[0]) for r in rows.fetchall()]

    def close(self) -> None:
        self._conn.close()
