"""GC103 positive: host-state writes in code a capture runs."""
import torch


def kernel(x):
    return x + 1


kernel.launches = 0


def launch(x):
    kernel.launches += 1                   # GC103: module state, once at capture
    return kernel(x)


class Model:
    def step(self, x):
        self.last = x                      # GC103: self state at capture
        return launch(x)

    def capture(self, x):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.step(x)
        return graph, out
