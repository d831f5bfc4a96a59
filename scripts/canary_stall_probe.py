#!/usr/bin/env python3
"""Whether two replica threads copying full-width rows to the host starve
a third thread's CUDA calls (one GPU).

    python3 scripts/canary_stall_probe.py [--seconds 45] [--limit 60]

The predict engine's canary arm (``chip_smoke.py``, predict_features (e))
has stopped for minutes with one thread in a CUDA call (a finiteness read,
or the release of a rolled-back version's graphs) while both replica
threads went on replaying bucket-1 graphs and copying their [1, 1024,
50304] f32 rows (206 MB) to the host.  This script makes that load without
the engine: two replica threads replay a ``ForwardGraph`` of GPT-2-small's
output projection (x [1, 1024, 768] @ W [768, 50304], random weights from
a seed) and copy its rows to the host as fast as they can, while the main
thread does what a canary does, again and again: capture a graph (the
gate's exclusive hold), call it once (replay, finiteness read, host copy),
and release it.  Each of the main thread's steps is timed.

Arms: ``pageable`` copies the rows by ``y.cpu()`` (``ForwardGraph.__call__``
before its page-locked buffer: ``rows_to_host`` without one); ``pinned``
calls ``ForwardGraph.__call__`` as it is (a DMA into the graph's
page-locked buffer, the host waiting on an event).  The arms run in turns,
pageable, pinned, pinned, pageable, each in a process of its own for
``--seconds``; a step of the main thread that takes longer than
``--limit`` seconds stops its process with every thread's stack
(``faulthandler``) and counts as a stall.  Prints one JSON line per run
(steps by kind: count, median and max ms; the replicas' copies and GB/s;
``stalled``, with the stack's tail), then the card's name and power
limit.  Exits non-zero without a CUDA device, or where a run failed
other than by a stall.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = ("pageable", "pinned")
ORDER = ("pageable", "pinned", "pinned", "pageable")


def run_arm(arm: str, seconds: float, limit: float) -> dict:
    """One arm in this process → its record (see the module's text)."""
    import faulthandler

    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.serving import cuda_graphs as cg

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    w = torch.randn(cs.D_MODEL, cs.VOCAB, generator=gen, device=dev) * 0.02

    def fwd(x):
        return x @ w

    shape = (1, cs.MAX_LEN, cs.D_MODEL)

    def call(g, x):
        if arm == "pinned":
            return g(x, 1)
        # ForwardGraph.__call__ with a pageable host copy
        with cg._GATE.shared(), torch.inference_mode(), torch.cuda.stream(g.stream):
            g.input.copy_(torch.from_numpy(x))
            g.graph.replay()
            return cg.rows_to_host(g.output, 1)

    replicas = [cg.ForwardGraph(fwd, shape, torch.float32, dev) for _ in range(2)]
    stop = threading.Event()
    copies = [0, 0]

    def serve(i):
        x = np.random.default_rng(i).standard_normal(shape, dtype=np.float32)
        while not stop.is_set():
            call(replicas[i], x)
            copies[i] += 1

    steps = {"capture": [], "call": [], "release": []}

    def step(kind, fn):
        faulthandler.dump_traceback_later(limit, exit=True)
        t0 = time.perf_counter()
        out = fn()
        steps[kind].append((time.perf_counter() - t0) * 1e3)
        faulthandler.cancel_dump_traceback_later()
        return out

    threads = [threading.Thread(target=serve, args=(i,), daemon=True) for i in range(2)]
    x = np.random.default_rng(2).standard_normal(shape, dtype=np.float32)
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    while time.perf_counter() - t_start < seconds:
        g = step("capture", lambda: cg.ForwardGraph(fwd, shape, torch.float32, dev))
        step("call", lambda: call(g, x))

        def release():
            nonlocal g
            g.release()
            g = None            # the graph and its pool go here
        step("release", release)
    stop.set()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    nbytes = 4 * cs.MAX_LEN * cs.VOCAB
    return {"arm": arm, "seconds": wall, "stalled": False,
            "steps": {k: {"n": len(v), "median_ms": float(np.median(v)) if v else None,
                          "max_ms": max(v) if v else None} for k, v in steps.items()},
            "replica_copies": sum(copies),
            "replica_copy_GBps": sum(copies) * nbytes / wall / 1e9}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--limit", type=float, default=60.0)
    ap.add_argument("--arm", choices=ARMS, help="run one arm in this process")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("canary_stall_probe: no CUDA device", file=sys.stderr)
        return 2
    if a.arm:
        print(json.dumps(run_arm(a.arm, a.seconds, a.limit)), flush=True)
        return 0
    bad = 0
    for run, arm in enumerate(ORDER):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--arm", arm,
                            "--seconds", str(a.seconds), "--limit", str(a.limit)],
                           capture_output=True, text=True, timeout=a.seconds + a.limit + 300)
        lines = [s for s in p.stdout.splitlines() if s.startswith("{")]
        if p.returncode == 0 and lines:
            rec = json.loads(lines[-1])
        else:
            rec = {"arm": arm, "stalled": "Timeout" in p.stderr, "rc": p.returncode,
                   "stderr_tail": p.stderr[-3000:]}
            bad += not rec["stalled"]       # a stall is a finding, not a failure
        print(json.dumps({"run": run, **rec}), flush=True)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    print(cs.card_line(), flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
