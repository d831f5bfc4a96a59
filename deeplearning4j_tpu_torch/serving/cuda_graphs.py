"""CUDA graphs of the serving engines (no reference counterpart: XLA
compiles each program into one executable ahead of time, and a captured
graph is its form on the card).

``ForwardGraph`` is the predict engine's forward for one (bucket, input
dtype) pair of one replica; ``StepMultiGraph`` the decode engine's fused
multi-step decode.

The fused multi-step decode (``DecodeProgram.step_multi``) as one CUDA
graph per engine.

A decode step launches about 1,300 small kernels, and the host's
enqueueing of them, not the card, sets the time per token.  The graph
holds H steps with their sampling and is replayed in one call, so the
host pays once per H tokens.

Every input lives in a static device buffer that the graph reads: the
page table, tokens, positions, active mask, temperatures, top-k, top-p,
seeds, steps, budgets and the EOS id.  A dispatch copies the host's
arrays into them, replays, and hands back the static outputs (tokens
[H, S], finite [H, S], logits [H, S, V]), valid until the next replay.
The KV pool and the parameters are read and written in place at the
addresses they had at capture.

A capture or replay that fails raises; nothing falls back to the eager
path.  ``det_attention_cuda.launches`` counts D1's launches: a replay
launches the captured ones again, so each replay adds the captured
count (and the capture itself, which launches nothing, adds none).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import attention, kv_cache, lstm_kernel

#: the forward-path kernels' launch counters, by name (``flash_fwd``
#: counts both dtypes, ``flash_fwd_tc`` the bf16 launches)
FORWARD_COUNTERS = {"flash_fwd": attention.flash_forward_cuda,
                    "flash_fwd_tc": attention.flash_forward_tc_cuda,
                    "lstm_seq_fwd": lstm_kernel.lstm_seq_fwd_cuda,
                    "det_attention": kv_cache.det_attention_cuda}

# replicas replay (and a swap captures) on several threads: the counters'
# read-modify-writes of a capture's measure and of a replay's add hold it
_COUNT_LOCK = threading.Lock()


class _Gate:
    """Replays share it; a capture holds it alone, so no replica replays
    or copies its rows to the host while another thread allocates, warms
    up and captures a forward graph on the same card (under full-width
    traffic such an overlap was seen to hang the capturing thread inside
    a device allocation).  A waiting capture blocks new replays, so
    steady traffic cannot starve it."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            while self._writer:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            while self._writer:
                self._cond.wait()
            self._writer = True
            while self._readers:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


_GATE = _Gate()


class ForwardGraph:
    """``fwd(x)`` for an input of ``shape`` and ``dtype`` on ``device``,
    captured at construction on a stream of its own, with a static input
    buffer and the captured output buffer.  Each replica of the predict
    engine holds its own graphs, so no two replicas share a buffer.

    ``fwd`` reads everything else (the parameters) at the addresses it
    had at capture.  The capture itself launches nothing: the forward
    kernels' counters (``FORWARD_COUNTERS``) are taken back after it and
    advanced by the captured counts at every replay.  A capture or replay
    that fails raises; nothing falls back to the eager forward.

    Rows reach the host through a page-locked buffer of the bucket's
    output size, allocated at capture: the copy is a DMA on the graph's
    stream that the host waits for on an event.  A pageable copy of a
    full-width output (GPT-2's [4, 1024, 50304] logits are 824 MB) holds
    the driver for the whole copy, and two replicas copying back to back
    were seen to starve another thread's CUDA calls for minutes."""

    def __init__(self, fwd: Callable[[torch.Tensor], torch.Tensor], shape,
                 dtype: torch.dtype, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self.replays = 0
        #: device ms of the last replay (events around it on its stream)
        self.last_ms: Optional[float] = None
        self.stream = torch.cuda.Stream(device)
        self._events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        with _GATE.exclusive(), torch.inference_mode():
            self.input = torch.zeros(tuple(shape), dtype=dtype, device=device)
            # warm up on the graph's stream: kernel libraries load and
            # cuBLAS picks its kernels before capture
            self.stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(self.stream):
                for _ in range(2):
                    fwd(self.input)
            self.stream.synchronize()
            with _COUNT_LOCK:
                before = {k: c.launches for k, c in FORWARD_COUNTERS.items()}
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph, stream=self.stream,
                                      capture_error_mode="thread_local"):
                    # graftcheck: disable=GC103 (binds the graph's static output buffer once, at capture; every replay writes into it)
                    self.output = fwd(self.input)
                self.launches = {k: c.launches - before[k]
                                 for k, c in FORWARD_COUNTERS.items()}
                for k, c in FORWARD_COUNTERS.items():
                    c.launches = before[k]
            # the host side of the output, as rows_to_host hands it back
            host_dtype = (torch.float32 if self.output.dtype == torch.bfloat16
                          else self.output.dtype)
            self.host = torch.empty(self.output.shape, dtype=host_dtype, pin_memory=True)
            self.copied = torch.cuda.Event()

    def __call__(self, x: np.ndarray, rows: int) -> Tuple[np.ndarray, bool]:
        """Copy ``x`` into the static input, replay, check the first
        ``rows`` output rows for finiteness on the device and copy them to
        the host through the page-locked buffer → (rows [rows, ...] as
        numpy, finite).  The output buffer is overwritten by the next
        replay; the rows returned are a copy.  ``last_ms`` then holds the
        replay's device time."""
        start, end = self._events
        with _GATE.shared(), torch.inference_mode(), torch.cuda.stream(self.stream):
            self.input.copy_(torch.from_numpy(np.ascontiguousarray(x)))
            start.record(self.stream)
            self.graph.replay()
            end.record(self.stream)
            with _COUNT_LOCK:
                self.replays += 1
                for k, n in self.launches.items():
                    FORWARD_COUNTERS[k].launches += n
            out = rows_to_host(self.output, rows, (self.host, self.copied))
            self.last_ms = start.elapsed_time(end)
            return out

    def release(self) -> None:
        """Free the graph, its private memory pool and its host buffer."""
        self.graph = None
        self.output = None
        self.host = None


def rows_to_host(y: torch.Tensor, rows: int,
                 pinned: Optional[Tuple[torch.Tensor, torch.cuda.Event]] = None
                 ) -> Tuple[np.ndarray, bool]:
    """(the first ``rows`` rows of ``y`` on the host, whether they are all
    finite): the check runs where ``y`` lives, before the copy
    (``host_copy``, through ``pinned`` where given)."""
    y = y[:rows]
    finite = bool(torch.isfinite(y).all())
    return host_copy(y, pinned), finite


def host_copy(y: torch.Tensor,
              pinned: Optional[Tuple[torch.Tensor, torch.cuda.Event]] = None) -> np.ndarray:
    """``y`` on the host as numpy; bfloat16 widens to float32, which numpy
    can hold.  With ``pinned`` (a page-locked host tensor of at least
    ``y``'s shape in that dtype, and an event) the copy goes into it on
    the current stream, the host waits on the event recorded after it,
    and a numpy copy of the rows is returned; else it is a pageable copy.
    Either way the bits are the same."""
    y = y.float() if y.dtype == torch.bfloat16 else y
    if pinned is None:
        return y.cpu().numpy()
    host, copied = pinned
    dst = host[:y.shape[0]]
    dst.copy_(y, non_blocking=True)
    copied.record()
    copied.synchronize()
    return dst.numpy().copy()

#: the graph's inputs in ``step_multi``'s argument order, with their dtype
INPUTS = (("page_table", torch.int64), ("tokens", torch.int64),
          ("positions", torch.int64), ("active", torch.bool),
          ("temps", torch.float32), ("top_ks", torch.int64),
          ("top_ps", torch.float32), ("seeds", torch.int64),
          ("steps", torch.int64), ("budgets", torch.int64), ("eos", torch.int64))


class StepMultiGraph:
    """``step_multi`` of ``program`` for ``n_slots`` slots and ``horizon``
    steps, captured at construction over ``params`` and ``cache`` (a
    ``KVCache`` on ``device``).  Call it with host arrays, one per name
    of ``INPUTS``; it returns the device outputs (toks, fins, lgs)."""

    def __init__(self, program, params, cache, n_slots: int, horizon: int,
                 device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self.horizon = int(horizon)
        self.replays = 0
        pps = program.pages_per_slot
        kp, vp = cache
        with torch.inference_mode():
            self.inputs: Dict[str, torch.Tensor] = {
                name: torch.zeros((n_slots, pps) if name == "page_table" else
                                  () if name == "eos" else (n_slots,),
                                  dtype=dtype, device=device)
                for name, dtype in INPUTS}
            self.inputs["top_ps"].fill_(1.0)
            self.inputs["budgets"].fill_(1)
            self.inputs["eos"].fill_(-1)
            args = [self.inputs[name] for name, _ in INPUTS]

            def run():
                _, _, toks, fins, lgs = program.step_multi(params, kp, vp, *args,
                                                           self.horizon)
                return toks, fins, lgs

            # warm up on a side stream: D1's library loads and cuBLAS
            # picks its kernels before capture (no slot is active, so the
            # writes land in the scratch page)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(2):
                    run()
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
            before = kv_cache.det_attention_cuda.launches
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                # graftcheck: disable=GC103 (binds the graph's static output buffers once, at capture; every replay writes into them)
                self.outputs = run()
            self.launches = {"det_attention": kv_cache.det_attention_cuda.launches - before}
            kv_cache.det_attention_cuda.launches = before
        if self.launches["det_attention"] < 1:
            raise RuntimeError("the captured step_multi launched no D1 kernel")

    def __call__(self, **host: np.ndarray):
        """Copy ``host`` (numpy arrays named as ``INPUTS``) into the static
        buffers, replay, and return (toks [H, S], fins [H, S], lgs [H, S,
        V]) on the device."""
        with torch.inference_mode():
            for name, _ in INPUTS:
                self.inputs[name].copy_(torch.from_numpy(np.asarray(host[name])))
            self.graph.replay()
        self.replays += 1
        kv_cache.det_attention_cuda.launches += self.launches["det_attention"]
        return self.outputs

    def release(self) -> None:
        """Free the graph and its private memory pool."""
        self.graph = None
        self.outputs = None
