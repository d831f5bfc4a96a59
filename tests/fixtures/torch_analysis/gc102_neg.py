"""GC102 negative: side effects in the warm-up and after the capture."""
import time

import torch


def step(x):
    return x * 2


def capture(x):
    print("warming up", time.perf_counter())
    step(x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(x)
    print("captured", time.perf_counter())
    return graph, out
