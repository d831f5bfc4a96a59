"""GC103 negative: host-state writes around the capture block."""
import torch


def kernel(x):
    return x + 1


kernel.launches = 0


class Model:
    def step(self, x):
        return kernel(x)

    def capture(self, x):
        before = kernel.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.step(x)
        kernel.launches = before           # the capturer resets the count
        self.graph = graph
        return out
