"""The serving HTTP surface (mirrors ``deeplearning4j_tpu/ui``: the
``UIServer`` routes of the serving engines; the stats storage, the
dashboard, ``/trace`` and ``/remote`` are later work)."""

from .server import UIServer

__all__ = ["UIServer"]
