"""GC102 positive: host side effects in code a capture runs: they run
once, at capture, never at a replay."""
import time

import torch


def step(x):
    print("step!")                         # GC102: runs at capture only
    t = time.perf_counter()                # GC102: frozen at capture
    return x * t


def capture(x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(x)
    return graph, out
