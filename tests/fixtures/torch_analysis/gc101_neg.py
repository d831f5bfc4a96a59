"""GC101 negative: syncs outside the capture block, and in an autograd
Function no capture reaches."""
import torch


class Unreached(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.peak = x.max().item()          # eager: no capture applies it
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * 2


def eager(x):
    return Unreached.apply(x)


def step(x, scale: float, n: int):
    b = int(x.shape[0])                    # metadata: no sync
    return x * float(scale) * int(n) + b


class Captured:
    def __init__(self, x):
        # warm-up outside the block: eager code may sync freely
        s = step(x, 2.0, 3).sum().item()
        host = x.cpu()
        torch.cuda.synchronize()
        w = torch.tensor([s], device=x.device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = step(x, 2.0, 3)
        torch.cuda.synchronize()
        self.result = (out, host, w)
