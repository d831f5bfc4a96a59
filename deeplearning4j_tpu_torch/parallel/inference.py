"""ParallelInference: the back-compatible shim over the serving engine
(mirrors ``deeplearning4j_tpu/parallel/inference.py``; the reference's
parallelism/ParallelInference.java BATCHED mode).

The old constructor and ``output`` / ``output_async`` / ``shutdown``
semantics over one ``serving.Engine``: requests are answered in arrival
order, fused up to ``max_batch``; a model error reaches every waiter of
the failed batch; ``shutdown()`` fails queued and late requests with
RuntimeError instead of leaving them hanging.  ``queue_timeout_s`` is
the batch-forming window.  New code should use ``serving.Engine``.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import List, Optional

import numpy as np

from ..serving.engine import Engine
from ..utils.device import DeviceLike

# the old queue had no deadline: a deadline far beyond any real wait
_NO_DEADLINE_MS = 3_600_000.0


class ParallelInference:
    """Batched inference around a network with ``.output(x)``.

    ``max_batch`` caps the fused batch (the reference's batchLimit);
    ``bucket_sizes`` quantizes batch shapes (one prepared program each,
    a CUDA graph on the card); ``queue_timeout_s`` bounds how long the
    oldest request waits for companions.  Requests of the network's
    configured input shape are served from the warmed buckets."""

    def __init__(self, model, max_batch: int = 32, queue_timeout_s: float = 0.005,
                 bucket_sizes: Optional[List[int]] = None, device: DeviceLike = None):
        self.model = model
        self.max_batch = max_batch
        self.timeout = queue_timeout_s
        self.engine = Engine(
            model, max_batch=max_batch, bucket_sizes=bucket_sizes,
            slo_ms=_NO_DEADLINE_MS, max_wait_ms=queue_timeout_s * 1000.0,
            replicas=1, max_queue=1_000_000, admission="block",
            device=device if device is not None else getattr(model, "device", None))
        if self.engine._infer_example_shape() is not None:
            self.engine.load()
        self.buckets = list(self.engine.batcher.buckets)

    def output(self, x) -> np.ndarray:
        """Submit one request (any leading batch size); blocks for the result."""
        return self.engine.output(np.asarray(x))

    def output_async(self, x) -> Future:
        return self.engine.output_async(np.asarray(x))

    def shutdown(self) -> None:
        self.engine.shutdown()
