"""The fused multi-step decode (``DecodeProgram.step_multi``) as one CUDA
graph per engine (no reference counterpart: XLA compiles ``step_multi``
into one executable, and a captured graph is its form on the card).

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

from typing import Dict

import numpy as np
import torch

from ..ops import kv_cache

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
