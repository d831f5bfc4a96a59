"""``fit_batches`` of a ``MultiLayerNetwork`` or a ``ComputationGraph`` on
the card: k optimizer steps as one CUDA graph (no reference counterpart:
the reference runs the k steps in one ``lax.scan`` dispatch,
``deeplearning4j_tpu/nn/multilayer.py:736`` and ``nn/graph.py:957``, and
one captured graph is its form here).

A step is the network's own ``_loss_and_grads`` and ``_apply_updates``
(forward, autograd backward, gradient normalization, updater, K4 where
switched on, constraints).  The updaters are functional: they return new
tensors.  Inside the capture each step copies its new parameters, layer
state (BatchNormalization's running statistics) and updater state back
into the network's own tensors, so every replay reads and writes the same
buffers, and step i + 1 reads what step i wrote.  The iteration counter
is a static device scalar the graph advances; the k losses land in a
static [k] buffer.  The container supplies the batch of step i from the
stacked inputs (``net._batch_at``): a ``DataSet`` or a ``MultiDataSet``.

Capture warms the steps up once on a side stream (cuBLAS picks its
kernels, the kernel libraries load), puts back the parameters, updater
state and generator state it started from, and records.  The network's
generator is registered with the graph, so every replay draws fresh
dropout and weight noise from it: the stream differs from k ``fit_batch``
calls', and repeats from the same seed.  The capture launches nothing:
the kernels' counters are taken back after it and advanced by the
captured counts at each replay (``TRAIN_COUNTERS``).

The warm-up and the capture hold every live ``DevicePrefetchIterator``
producer (``datasets.device_prefetch.producers_paused``: a producer in
the middle of a batch finishes enqueueing it first), and the capture runs
in ``thread_local`` mode, so another thread's CUDA call cannot invalidate
it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..datasets.device_prefetch import producers_paused
from ..ops import attention, lstm_kernel, update_kernel
from .updaters import tree_leaves

Tensor = torch.Tensor

#: the training path's kernels' launch counters, by name (``flash_fwd``,
#: ``flash_bwd_dkdv`` and ``flash_bwd_dq`` count both dtypes; the ``_tc``
#: counters the bf16 launches, which run the tensor-core kernels)
TRAIN_COUNTERS = {"flash_fwd": attention.flash_forward_cuda,
                  "flash_fwd_tc": attention.flash_forward_tc_cuda,
                  "flash_bwd_dkdv": attention.flash_bwd_dkdv_cuda,
                  "flash_bwd_dkdv_tc": attention.flash_bwd_dkdv_tc_cuda,
                  "flash_bwd_dq": attention.flash_bwd_dq_cuda,
                  "flash_bwd_dq_tc": attention.flash_bwd_dq_tc_cuda,
                  "fused_update": update_kernel.fused_update_cuda,
                  "lstm_seq_fwd": lstm_kernel.lstm_seq_fwd_cuda,
                  "lstm_cell_bwd": lstm_kernel.lstm_cell_bwd_cuda}



def _leaves(*trees) -> List[Tensor]:
    """Every tensor of each per-layer tree (a list of layers, or a dict of
    them keyed by vertex name), tree by tree, layer by layer in
    ``tree_leaves`` order."""
    return [t for tree in trees
            for layer in (tree.values() if isinstance(tree, dict) else tree)
            for t in tree_leaves(layer)]


class TrainStepsGraph:
    """``k`` training steps of ``net`` on batches shaped like ``stacked``
    (the container's ``_stacked``: one [k, ...] tensor per input, label
    and mask, or None), captured at construction over the network's
    current parameter, state and updater-state tensors."""

    def __init__(self, net, stacked: Dict[str, Optional[Tensor]], k: int):
        dev = net.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {dev}")
        self.k = int(k)
        self.inputs = {n: None if t is None else torch.empty_like(t)
                       for n, t in stacked.items()}
        for n, t in stacked.items():
            if t is not None:
                self.inputs[n].copy_(t)
        loss_dt = (torch.float64 if net._compute_dtype() == torch.float64
                   else torch.float32)
        self.losses = torch.zeros(self.k, dtype=loss_dt, device=dev)
        self.it = torch.zeros((), dtype=torch.float32, device=dev)
        # the buffers the graph reads and writes: the network's own trees
        self.params, self.state, self.opt_state = net.params, net.state, net.opt_state
        self._static = _leaves(net.params, net.state, net.opt_state)

        with producers_paused():
            snapshot = [t.clone() for t in self._static]
            gen_state = net._gen.get_state()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.it.fill_(float(net.iteration))
                self._steps(net)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            with torch.no_grad():
                for t, s in zip(self._static, snapshot):
                    t.copy_(s)
            del snapshot
            net._gen.set_state(gen_state)

            before = {n: c.launches for n, c in TRAIN_COUNTERS.items()}
            self.graph = torch.cuda.CUDAGraph()
            self.graph.register_generator_state(net._gen)
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self._steps(net)
            self.launches = {n: c.launches - before[n] for n, c in TRAIN_COUNTERS.items()}
            for n, c in TRAIN_COUNTERS.items():
                c.launches = before[n]

    def _steps(self, net) -> None:
        for i in range(self.k):
            new_s = type(net.state)()
            loss, grads, _ = net._loss_and_grads(net._batch_at(self.inputs, i),
                                                 state_out=new_s)
            with torch.no_grad():
                new_p, new_o = net._apply_updates(grads, net.params, net.opt_state,
                                                  self.it)
                for old, new in zip(self._static, _leaves(new_p, new_s, new_o)):
                    old.copy_(new)
                self.it.add_(1.0)
                self.losses[i].copy_(loss)

    def __call__(self, net, stacked: Dict[str, Optional[Tensor]]) -> Tensor:
        """Copy the stacked batches in, replay, and return a copy of the k
        losses.  A network (the one captured) whose trees were replaced
        since (an eager step builds new tensors) has its values copied
        into the graph's buffers first, and is bound to them again.  The
        graph holds no reference to the network itself."""
        with torch.no_grad():
            current = _leaves(net.params, net.state, net.opt_state)
            if any(a is not b for a, b in zip(current, self._static)):
                for t, c in zip(self._static, current):
                    t.copy_(c)
                net.params, net.state, net.opt_state = self.params, self.state, self.opt_state
            for n, t in stacked.items():
                if t is not None:
                    self.inputs[n].copy_(t)
            self.it.fill_(float(net.iteration))
            self.graph.replay()
        for n, c in self.launches.items():
            TRAIN_COUNTERS[n].launches += c
        return self.losses.clone()


def replay_steps(net, stacked: Dict[str, Optional[Tensor]], k: int) -> Tensor:
    """``net.fit_batches``' card path: the k steps of ``stacked`` through
    the network's graph for these (k, shapes, dtypes, K4 switch), captured
    at first use; advances the iteration → a copy of the k losses."""
    key = (k, update_kernel.enabled()) + tuple(
        None if t is None else (tuple(t.shape), t.dtype) for t in stacked.values())
    graph = net._fit_graphs.get(key)
    if graph is None:
        graph = net._fit_graphs[key] = TrainStepsGraph(net, stacked, k)
    losses = graph(net, stacked)
    net.iteration += k
    net._it_dev, net._it_dev_val = graph.it, net.iteration
    return losses
