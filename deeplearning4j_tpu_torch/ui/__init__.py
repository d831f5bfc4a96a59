"""Observability: stats collection → storage → dashboard, and the serving
HTTP surface (the port of ``deeplearning4j_tpu/ui``; replaces
deeplearning4j-ui-parent).

The reference splits this into BaseStatsListener (per-iteration collection)
→ StatsStorage (routing/persistence) → Play web server (rendering).  The
same three seams exist here: the listener computes each parameter leaf's
statistics on the network's device and copies back only the numbers,
storage is in-memory / JSONL / sqlite (files either package reads),
rendering emits a self-contained static HTML dashboard (no CDN scripts,
inline SVG) served by a stdlib http server, and ``profile_trace`` wraps
``torch.profiler`` for deep performance traces.
"""

from .stats import StatsListener
from .storage import FileStatsStorage, InMemoryStatsStorage, SqliteStatsStorage
from .render import render_dashboard, render_embedding_html
from .remote import RemoteStatsRouter
from .server import UIServer
from .profiler import input_pipeline_snapshot, profile_trace

__all__ = [
    "StatsListener",
    "InMemoryStatsStorage", "FileStatsStorage", "SqliteStatsStorage",
    "render_dashboard", "render_embedding_html", "RemoteStatsRouter", "UIServer", "profile_trace",
    "input_pipeline_snapshot",
]
