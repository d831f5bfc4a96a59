"""GC101 positive: host syncs in code a CUDA-graph capture runs."""
import torch


class Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.peak = x.max().item()          # GC101: reached by .apply
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * 2


def step(x, host):
    y = Scale.apply(x)
    s = y.sum().item()                     # GC101: .item()
    z = y.cpu()                            # GC101: .cpu()
    torch.cuda.synchronize()               # GC101: device sync
    w = torch.tensor(host, device=x.device)    # GC101: host -> device copy
    idx = torch.nonzero(y)                 # GC101: data-dependent shape
    return y + s + z.sum() + w + idx.sum()


class Captured:
    def __init__(self, x, host):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = step(x, host)       # GC103 too: see gc103_pos


class Replays:
    """Runs a callable passed in under a capture."""

    def __call__(self, fn, *inputs):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*inputs)
        graph.replay()
        return out


def chunk(x):
    return x.tolist()                      # GC101: passed into a capture


def fit(x):
    replay = Replays()
    replay(chunk, x)
    return replay(lambda t: t.numpy(), x)  # GC101: a captured lambda
