"""StatsListener — per-iteration training telemetry (the port of
``deeplearning4j_tpu/ui/stats.py``: the same constructor, record keys and
``requires_model_state``).

Parity target: reference ui/stats/BaseStatsListener.java:304-420
(iterationDone: score, timing, minibatch rate, param/update/activation
histograms + mean-magnitude ratios, JVM/off-heap memory) routed through a
StatsStorage.

The reference copies every parameter leaf to the host on every recorded
iteration and computes each leaf's moments and numpy histogram there.  The
port computes the same record on the network's device and copies only the
statistics back:

* the parameters are laid end to end in one buffer a dtype (the record's
  device copy, against which the next record subtracts: one subtraction
  gives every delta), and each pass over a buffer covers many leaves
  (segmented reductions, per-leaf values spread over their elements), so
  a record costs a few dozen launches, not a few dozen a leaf;
* per leaf, for the parameter and for its delta: mean, std, min, max,
  mean magnitude (sums accumulated in float64, each result rounded to
  float32 as numpy's float32 reductions give it) and the
  ``histogram_bins`` histogram;
* the histogram counts exactly as ``np.histogram`` does on the leaf in
  float32: every leaf's min and max come to the host in one copy, numpy
  itself computes the edges from them (so the edges are the installed
  numpy's, bit for bit) together with the dtypes its index arithmetic
  runs in, and the device then applies numpy's index rule — the scaled
  offset truncated, the last edge inclusive, one decrement where a value
  lies below its computed edge and one increment where it reaches the
  next;
* one more copy brings every leaf's numbers back (without histograms,
  that copy is the only one).

The update:param mean-magnitude ratio — the quantity DL4J users watch
(rule of thumb ~1e-3) — comes from parameter DELTAS between recorded
iterations, which under any SGD-family updater IS the applied update.
Device memory is ``torch.cuda.memory_allocated`` / ``max_memory_allocated``
on a card and absent on the CPU, as the reference's is there.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..optimize.listeners import TrainingListener

Tensor = torch.Tensor

_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}

#: elements one partial reduction covers: a leaf longer than this is
#: reduced in chunks (many blocks), then the chunks' results per leaf
_CHUNK = 1 << 20
#: elements one group of leaves covers: the temporaries of a group's
#: element-wise passes are a few of its size
_GROUP = 1 << 26


def histogram_plan(mn: np.float32, mx: np.float32, bins: int) -> Tuple[np.ndarray, float,
                                                                      float, tuple]:
    """What ``np.histogram(a, bins)`` derives from a float32 leaf's min and
    max: its float32 edges, the first edge and the range as its index
    arithmetic uses them, and the dtypes of that arithmetic's three steps
    (subtract, divide, scale).  numpy's own operations compute all of it,
    on the two-element array [min, max], whose range is the leaf's."""
    probe = np.array([mn, mx], np.float32)
    edges = np.histogram_bin_edges(probe, bins)
    first, last = probe.min(), probe.max()
    if first == last:
        first, last = first - 0.5, last + 0.5
    denom = np.subtract(last, first, dtype=np.result_type(last, first))
    sub = np.subtract(probe, first, dtype=np.result_type(probe, first))
    div = sub / denom
    scaled = div * bins
    dtypes = (sub.dtype, div.dtype, scaled.dtype)
    return (edges, float(np.asarray(first).astype(sub.dtype)),
            float(np.asarray(denom).astype(div.dtype)), dtypes)


def _groups(sizes: List[int], keys: Optional[list] = None) -> List[Tuple[int, int]]:
    """Contiguous ranges of leaves [i0, i1) of at most ``_GROUP`` elements
    (a longer leaf alone), a range never spanning two ``keys``."""
    out, i0, total = [], 0, 0
    for i, n in enumerate(sizes):
        if i > i0 and (total + n > _GROUP or (keys is not None and keys[i] != keys[i0])):
            out.append((i0, i))
            i0, total = i, 0
        total += n
    out.append((i0, len(sizes)))
    return out


class _Segments:
    """Consecutive leaves of one flat buffer: per-leaf reductions in two
    segmented passes (chunks of at most ``_CHUNK``, then each leaf's
    chunks) and per-leaf values spread over the leaves' elements through
    one index of each element's leaf (a scan of leaf starts).  No call
    syncs with the device: the lengths are known to be right."""

    def __init__(self, sizes: List[int], device: torch.device):
        per_leaf = [-(-n // _CHUNK) for n in sizes]
        chunks = [min(_CHUNK, n - c * _CHUNK) for n, k in zip(sizes, per_leaf)
                  for c in range(k)]
        starts = np.cumsum(sizes)[:-1].tolist()
        counts = torch.tensor(sizes + per_leaf + starts + chunks, dtype=torch.int64).to(device)
        n = len(sizes)
        self.lengths, self.per_leaf = counts[:n], counts[n:2 * n]
        self.starts, self.chunks = counts[2 * n:3 * n - 1], counts[3 * n - 1:]
        self.n = self.lengths.to(torch.float64)
        self.total = sum(sizes)
        self._leaf: Optional[Tensor] = None

    def reduce(self, x: Tensor, op: str) -> Tensor:
        part = torch.segment_reduce(x, op, lengths=self.chunks, unsafe=True)
        return torch.segment_reduce(part, op, lengths=self.per_leaf, unsafe=True)

    @property
    def leaf(self) -> Tensor:
        """Each element's leaf (int32)."""
        if self._leaf is None:
            marks = torch.zeros(self.total, dtype=torch.int32, device=self.n.device)
            marks.index_fill_(0, self.starts, 1)
            self._leaf = marks.cumsum(0, dtype=torch.int32)
        return self._leaf

    def spread(self, v: Tensor) -> Tensor:
        return v.index_select(0, self.leaf)


def _moments(x: Tensor, seg: _Segments) -> Tensor:
    """[mean, std, mean magnitude] of each leaf of the float32 buffer ``x``
    as a float64 [leaves, 3] tensor on its device, each the float32 value
    numpy's float32 reductions give: sums accumulated in float64, then
    rounded to float32 as numpy's results are, the std from the deviations
    from that float32 mean as ``np.std`` takes them (so a leaf whose spread
    is a few float32 spacings reads as the reference reads it)."""
    f32, f64 = torch.float32, torch.float64
    wide = x.to(f64)
    total = seg.reduce(wide, "sum")
    magnitude = seg.reduce(wide.abs_(), "sum")
    del wide
    mean = (total / seg.n).to(f32)
    dev = (x - seg.spread(mean)).to(f64)
    var = seg.reduce(dev.square_(), "sum") / seg.n
    del dev
    return torch.stack([mean, var.to(f32).sqrt(), (magnitude / seg.n).to(f32)], dim=1).to(f64)


def _histograms(x: Tensor, seg: _Segments, edges: Tensor, first: Tensor, denom: Tensor,
                dtypes: tuple, bins: int) -> Tensor:
    """``np.histogram``'s counts of each leaf of the float32 buffer ``x``
    ([leaves, bins] int64) from :func:`histogram_plan`'s edges ([leaves,
    bins + 1] float32), first edges and ranges (float64 tensors on the
    device holding the values numpy computes with) and dtypes.  The divisor
    is a device tensor: a CUDA division by a host scalar multiplies by its
    reciprocal, which is not numpy's division."""
    sub_dt, div_dt, mul_dt = (_DTYPES[np.dtype(d)] for d in dtypes)
    f = x.to(sub_dt) - seg.spread(first.to(sub_dt))
    f = f.to(div_dt) / seg.spread(denom.to(div_dt))
    f = f.to(mul_dt) * bins
    i32 = torch.int32
    idx = f.to(i32)
    del f
    idx -= (idx == bins).to(i32)
    table = edges.reshape(-1)
    at = seg.leaf * (bins + 1)
    # the computed index is within one bin of the edges' own: numpy's
    # correction of values that land on or beside a computed edge
    idx -= (x < table[at + idx]).to(i32)
    idx += ((x >= table[at + idx + 1]) & (idx != bins - 1)).to(i32)
    counts = torch.bincount(seg.leaf * bins + idx, minlength=len(first) * bins)
    return counts.reshape(len(first), bins)


def _stats_dict(row: np.ndarray, hist: Optional[np.ndarray],
                edges: Optional[np.ndarray]) -> Dict[str, Any]:
    out = {"mean": float(row[0]), "std": float(row[1]), "min": float(row[2]),
           "max": float(row[3]), "mean_magnitude": float(row[4])}
    if hist is not None:
        out["histogram"] = [int(c) for c in hist]
        out["histogram_edges"] = [float(edges[0]), float(edges[-1])]
    return out


def flat_stats(parts: List[Tuple[Tensor, List[int]]], bins: int,
               with_histogram: bool = True) -> List[List[Dict[str, Any]]]:
    """The reference's ``_leaf_stats`` of every leaf of ``parts`` — pairs of
    a float32 buffer holding leaves end to end and their sizes, all on one
    device — computed there, leaves grouped so each pass covers many of
    them: one device-to-host copy of every leaf's numbers, and with
    histograms one copy of the mins and maxes before it (numpy makes the
    edges from them while the device sums).  An empty leaf gives ``{}``."""
    out: List[List[Dict[str, Any]]] = [[{} for _ in sizes] for _, sizes in parts]
    live = [[i for i, n in enumerate(sizes) if n] for _, sizes in parts]
    if not any(live):
        return out
    device = next(x for x, _ in parts).device
    segments: Dict[tuple, _Segments] = {}

    def spans(keys=None):
        """(first leaf, end leaf, the group's buffer, its segments) of every
        group of every part, leaves counted over all parts; ``keys`` (one a
        leaf) split groups where they change."""
        j = 0
        for p, (x, sizes) in enumerate(parts):
            lsizes = [sizes[i] for i in live[p]]
            starts = np.concatenate([[0], np.cumsum(lsizes)]).astype(int).tolist()
            for i0, i1 in (_groups(lsizes, keys and keys[j:j + len(lsizes)])
                           if lsizes else []):
                if (p, i0, i1) not in segments:
                    segments[p, i0, i1] = _Segments(lsizes[i0:i1], device)
                yield j + i0, j + i1, x[starts[i0]:starts[i1]], segments[p, i0, i1]
            j += len(lsizes)

    groups = list(spans())
    ranges = torch.cat([torch.stack([seg.reduce(v, "min"), seg.reduce(v, "max")], dim=1)
                        for _, _, v, seg in groups])
    host_ranges = ranges.cpu().numpy() if with_histogram else None
    # queued behind the ranges' copy: the device sums while the host makes
    # the histograms' plans
    moments = torch.cat([_moments(v, seg) for _, _, v, seg in groups])
    rows = torch.cat([moments[:, :2], ranges.to(torch.float64), moments[:, 2:]], dim=1)
    hist = None
    if with_histogram:
        plans = []
        for mn, mx in host_ranges:
            if not (np.isfinite(mn) and np.isfinite(mx)):
                # np.histogram's own refusal of a non-finite leaf
                raise ValueError(
                    "autodetected range of [{}, {}] is not finite".format(mn, mx))
            plans.append(histogram_plan(mn, mx, bins))
        # every leaf's edges, first edge and range in one host-to-device
        # copy (float64 holds each float32 value exactly)
        table = torch.from_numpy(np.stack([np.concatenate([p[0], [p[1], p[2]]])
                                           for p in plans])).to(device)
        edges = table[:, :bins + 1].to(torch.float32)
        keys = [p[3] for p in plans]
        counts = [_histograms(v, seg, edges[a:b], table[a:b, bins + 1], table[a:b, bins + 2],
                              keys[a], bins) for a, b, v, seg in spans(keys)]
        rows = torch.cat([rows, torch.cat(counts).to(torch.float64)], dim=1)
        hist = [p[0] for p in plans]
    rows = rows.cpu().numpy()
    j = 0
    for p, idx in enumerate(live):
        for i in idx:
            out[p][i] = _stats_dict(rows[j, :5], None if hist is None else rows[j, 5:],
                                    None if hist is None else hist[j])
            j += 1
    return out


def leaf_stats(leaves: List[Tensor], bins: int,
               with_histogram: bool = True) -> List[Dict[str, Any]]:
    """:func:`flat_stats` of separate leaves (tensors on one device, each
    read as float32)."""
    x = torch.cat([v.detach().reshape(-1).to(torch.float32) for v in leaves])
    return flat_stats([(x, [v.numel() for v in leaves])], bins, with_histogram)[0]


class _Flat:
    """The parameter leaves laid end to end, one buffer per dtype, in the
    leaves' own dtype: the record's device copy of the parameters, and the
    operand of the next record's deltas."""

    def __init__(self, pids: List[str], leaves: List[Tensor]):
        self.pids = pids
        self.signature = [(p, v.dtype, v.numel()) for p, v in zip(pids, leaves)]
        self.index: Dict[torch.dtype, List[int]] = {}
        for i, v in enumerate(leaves):
            self.index.setdefault(v.dtype, []).append(i)
        self.buffers = {dt: torch.cat([leaves[i].detach().reshape(-1) for i in idx])
                        for dt, idx in self.index.items()}
        self.sizes = {dt: [leaves[i].numel() for i in idx] for dt, idx in self.index.items()}

    def parts(self) -> List[Tuple[Tensor, List[int]]]:
        return [(self.buffers[dt].to(torch.float32), self.sizes[dt]) for dt in self.index]

    def leaf(self, i: int) -> Tensor:
        dt = self.signature[i][1]
        k = self.index[dt].index(i)
        start = sum(self.sizes[dt][:k])
        return self.buffers[dt][start:start + self.sizes[dt][k]]

    def deltas(self, last: "_Flat") -> Tuple[List[int], List[Tuple[Tensor, List[int]]]]:
        """(the leaves that have a delta, their deltas as float32 parts):
        each delta in the leaf's own dtype, as the reference subtracts its
        arrays; one subtraction a dtype when the leaves are the last
        record's, else one a leaf the last record had at the same dtype and
        size (where the reference's subtraction of another shape raises,
        the leaf gets no delta)."""
        if self.signature == last.signature:
            return ([i for dt in self.index for i in self.index[dt]],
                    [((self.buffers[dt] - last.buffers[dt]).to(torch.float32),
                      self.sizes[dt]) for dt in self.index])
        prev = {p: i for i, p in enumerate(last.pids)}
        have = [i for i, s in enumerate(self.signature)
                if s[0] in prev and last.signature[prev[s[0]]][1:] == s[1:]]
        if not have:
            return [], []
        d = [(self.leaf(i) - last.leaf(prev[self.pids[i]])).to(torch.float32) for i in have]
        return have, [(torch.cat(d), [t.numel() for t in d])]


class StatsListener(TrainingListener):
    """Collects per-iteration stats into a StatsStorage.

    ``update_frequency`` throttles collection (reference updateFrequency);
    histograms are optional (they dominate record size, as in DL4J).

    ``clock`` is injectable (defaults to wall time): dashboard records
    are deliberately wall-anchored — session ids, timestamps and
    examples/sec all describe when training *actually* ran — but tests
    (and deterministic replays that diff record streams) can pin it.
    """

    def __init__(self, storage, session_id: Optional[str] = None,
                 update_frequency: int = 1, collect_histograms: bool = True,
                 histogram_bins: int = 20, collect_memory: bool = True,
                 collect_input_stats: bool = True,
                 clock=time.time):
        self.storage = storage
        self.clock = clock
        self.session_id = session_id or f"session_{int(self.clock())}"
        self.update_frequency = max(1, update_frequency)
        self.collect_histograms = collect_histograms
        self.histogram_bins = histogram_bins
        self.collect_memory = collect_memory
        self.collect_input_stats = collect_input_stats
        self._last_time: Optional[float] = None
        #: the last recorded parameters: a device copy, laid end to end
        self._last_params: Optional[_Flat] = None
        self._start_time = self.clock()

    # -- helpers -----------------------------------------------------------

    def _param_items(self, model):
        """Normalize MLN (list of dicts) / graph (dict of dicts) params to
        (layer_name, key, tensor) triples."""
        params = model.params
        if isinstance(params, dict):
            for name, p in params.items():
                for k, v in (p or {}).items():
                    yield name, k, v
        else:
            for i, p in enumerate(params):
                name = getattr(model.conf.layers[i], "name", None) or f"layer_{i}"
                for k, v in (p or {}).items():
                    yield name, k, v

    def _memory(self, device: Optional[torch.device] = None) -> Dict[str, Any]:
        """Bytes allocated on the model's card now and at peak; ``{}`` on
        the CPU (no allocator statistics there)."""
        if device is None or device.type != "cuda":
            return {}
        return {"bytes_in_use": int(torch.cuda.memory_allocated(device)),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device))}

    # -- TrainingListener --------------------------------------------------

    # reads model.params each callback → needs each chunk's params, not
    # end-of-batch params, under fused multi-step (TBPTT scan) paths
    requires_model_state = True

    def iteration_done(self, model, iteration: int, loss: float) -> None:
        if iteration % self.update_frequency != 0:
            return
        now = self.clock()
        record: Dict[str, Any] = {
            "iteration": int(iteration),
            "timestamp": now,
            "relative_time": now - self._start_time,
            "score": float(loss),
        }
        if self._last_time is not None:
            dt = max(now - self._last_time, 1e-9)
            record["iterations_per_sec"] = self.update_frequency / dt
        self._last_time = now

        pids, leaves = [], []
        for name, key, v in self._param_items(model):
            pids.append(f"{name}/{key}")
            leaves.append(v)
        param_stats: Dict[str, Dict[str, Any]] = {}
        update_stats: Dict[str, Dict[str, Any]] = {}
        ratios: Dict[str, float] = {}
        if leaves:
            with torch.no_grad():
                current = _Flat(pids, leaves)
                order = [i for dt in current.index for i in current.index[dt]]
                parts = current.parts()
                moved, dparts = (current.deltas(self._last_params)
                                 if self._last_params is not None else ([], []))
                stats = flat_stats(parts + dparts, self.histogram_bins,
                                   self.collect_histograms)
            by_leaf = dict(zip(order, (d for part in stats[:len(parts)] for d in part)))
            param_stats = {pid: by_leaf[i] for i, pid in enumerate(pids)}
            moved_stats = dict(zip(moved, (d for part in stats[len(parts):] for d in part)))
            for i in sorted(moved_stats):
                pid, ustats = pids[i], moved_stats[i]
                update_stats[pid] = ustats
                pm = param_stats[pid].get("mean_magnitude", 0.0)
                um = ustats.get("mean_magnitude", 0.0)
                # the DL4J "mean magnitude ratio" users watch (~1e-3
                # healthy); the delta spans update_frequency optimizer
                # steps, so normalize to a PER-STEP ratio
                ratios[pid] = (um / pm / self.update_frequency) if pm > 0 else 0.0
            self._last_params = current
        record["parameters"] = param_stats
        if update_stats:
            record["updates"] = update_stats
            record["update_ratios"] = ratios
        if self.collect_memory:
            mem = self._memory(leaves[0].device if leaves else None)
            if mem:
                record["memory"] = mem
        if self.collect_input_stats:
            # input-pipeline health rides the same record stream: stall
            # fraction ~0 = feeding hidden under compute, → 1 = the step
            # is input-bound
            from .profiler import input_pipeline_snapshot
            snap = input_pipeline_snapshot()
            if snap:
                record["input_pipeline"] = snap
        self.storage.put_update(self.session_id, record)

    def epoch_done(self, model, epoch: int) -> None:
        self.storage.put_update(self.session_id, {
            "iteration": int(getattr(model, "iteration", 0)),
            "timestamp": self.clock(),
            "epoch_done": int(epoch),
        })
