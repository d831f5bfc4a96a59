"""ShardedTransformerLM — the 4-D parallel (data × model × seq × pipe)
decoder-only LM (mirrors ``deeplearning4j_tpu/parallel/transformer.py``).

One process is one rank of a ``RankMesh`` over the axes
``("data", "model", "seq", "pipe")`` (absent axes have size 1):

  - ``data``  splits the batch rows;
  - ``model`` splits attention heads and FFN columns (Megatron: column-
    parallel ``Wq/Wk/Wv/W1/b1``, row-parallel ``Wo/W2`` summed over the
    axis before their biases, ``models.transformer.block_apply``'s
    ``psum_axis``) and the vocabulary columns of ``head``, so the loss is
    a vocabulary-parallel cross-entropy (``ops.losses.sparse_softmax_xent``
    with an axis);
  - ``seq``   splits the sequence; attention runs as ring attention
    (``ring.py``) or Ulysses (``ulysses.py``, kernels K1-K3 per rank);
  - ``pipe``  splits the block stack into stages (``pipeline.py``, GPipe
    or 1F1B).

A rank keeps only its slice of each parameter and of the updater state:
its pipe stage's blocks, and its ``model`` columns or rows.  The
embedding, positions and final norm are replicated.  The loss is the
mean over the GLOBAL batch (each rank's token sum over the global token
count, summed over ``data`` and ``seq``), and the gradients of every
leaf are summed over ``data`` and ``seq``, the lines that share it; the
updater then runs per leaf (``updater.update``) on this rank's slices.

With no ``model``, ``seq`` or ``pipe`` axis the blocks are unrolled and
attention is ``flash_mha`` (K1 forward, K2/K3 backward on the card) or
plain ``mha`` with ``attention_impl="xla"``; otherwise the blocks run
through ``pipeline_apply``, as in the reference.  ``fit_batches`` on a
one-rank mesh on the card is one CUDA graph of k steps
(``nn.train_graph``); across ranks it is k eager steps of the same math,
since collectives over gloo cannot be captured.

``decode_program`` serves the LM through ``serving.DecodeEngine``:
one-way, or tensor-parallel over a ``data`` mesh (heads split into
shards held by this one process on ``decode_devices``).
``load_params`` / ``params_numpy`` carry the reference's whole parameter
tree (and Adam's moments) across, each rank keeping its slice.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..models import transformer as tm
from ..nn.layers.normalization import layer_norm
from ..nn.updaters import Adam, tree_leaves, tree_map, tree_unflatten
from ..ops.attention import flash_mha, mha
from ..ops.dtypes import canonical_dtype, matmul
from ..ops.losses import sparse_softmax_xent
from ..optimize.score import LazyScore
from ..utils.device import DeviceLike, resolve_device
from .collectives import Axis, all_gather, all_reduce, pvary
from .distributed import process_count
from .mesh import build_mesh
from .pipeline import SCHEDULES, pipeline_apply
from .ring import ring_attention
from .ulysses import ulysses_attention

Tensor = torch.Tensor

CANONICAL = ("data", "model", "seq", "pipe")

#: the dim of a block's (unstacked) leaf split over ``model``: the
#: column-parallel products by columns, the row-parallel ones by rows;
#: the norms, ``bo`` and ``b2`` are replicated (reference ``_block_tp_specs``)
BLOCK_TP_DIM = {"Wq": 1, "Wk": 1, "Wv": 1, "W1": 1, "b1": 0, "Wo": 0, "W2": 0}


def _sorted(d: dict) -> dict:
    return {k: d[k] for k in sorted(d)}


class ShardedTransformerLM:
    """Decoder-only LM trained with DP×TP×SP×PP over a rank mesh.

    >>> initialize(init_method="file:///tmp/rdv", num_processes=4, process_id=r)
    >>> lm = ShardedTransformerLM(vocab_size=256, n_layers=4, d_model=128,
    ...                           n_heads=8, mesh=build_mesh({"model": 2, "seq": 2}))
    >>> loss = lm.fit_batch(tokens, targets)   # the global [B, T] ids, every rank

    Entry points run on ``device`` (default ``cuda``)."""

    def __init__(self, vocab_size: int, n_layers: int, d_model: int,
                 n_heads: int, mesh, d_ff: int = 0, max_len: int = 512,
                 n_microbatches: int = 2, seed: int = 0, updater=None,
                 compute_dtype=None, seq_parallel: str = "ring",
                 attention_impl: str = "flash", schedule: str = "gpipe",
                 device: DeviceLike = None):
        d_ff = d_ff or 4 * d_model
        unknown = [n for n in mesh.shape if n not in CANONICAL]
        if unknown:
            raise ValueError(f"unexpected mesh axes {unknown}; use {CANONICAL}")
        if tuple(mesh.shape) != CANONICAL:
            mesh = build_mesh({n: mesh.shape.get(n, 1) for n in CANONICAL},
                              world_size=mesh.size)
        tp = mesh.shape["model"]
        if n_heads % tp:
            raise ValueError(f"n_heads {n_heads} not divisible by model={tp}")
        if seq_parallel not in ("ring", "ulysses"):
            raise ValueError(f"seq_parallel must be 'ring' or 'ulysses', "
                             f"got {seq_parallel!r}")
        if seq_parallel == "ulysses" and (n_heads // tp) % mesh.shape["seq"]:
            raise ValueError(
                f"ulysses scatters heads over seq={mesh.shape['seq']} "
                f"but only {n_heads // tp} heads remain after TP — use "
                "seq_parallel='ring' or raise n_heads")
        if attention_impl not in ("flash", "xla"):
            raise ValueError(f"attention_impl must be 'flash' or 'xla', "
                             f"got {attention_impl!r}")
        if attention_impl == "xla" and mesh.shape["seq"] > 1:
            raise ValueError(
                "attention_impl='xla' requires seq=1 — the sequence-"
                "parallel paths (ring/ulysses) are built on the blockwise/"
                "flash update and cannot honor plain einsum attention")
        if n_layers % mesh.shape["pipe"]:
            raise ValueError(
                f"n_layers {n_layers} not divisible by pipe={mesh.shape['pipe']}")
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, "
                             f"got {schedule!r}")
        if vocab_size % tp:
            raise ValueError(f"vocab_size {vocab_size} not divisible by model={tp} "
                             "(the head is split by vocabulary columns)")
        self.seq_parallel = seq_parallel
        self.attention_impl = attention_impl
        self.schedule = schedule
        self.mesh = mesh
        self.vocab_size = vocab_size
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_heads_local = n_heads // tp
        self.n_microbatches = n_microbatches
        self.compute_dtype = None if compute_dtype is None else canonical_dtype(compute_dtype)
        self.updater = updater or Adam(lr=3e-4)
        self.iteration = 0
        self.device = resolve_device(device)
        #: the devices of the tensor-parallel decode program's head shards
        #: (default: this LM's device for every shard)
        self.decode_devices: Optional[Sequence[torch.device]] = None
        self._axes: Optional[Dict[str, Axis]] = None
        self._decode_cache: dict = {}
        # the duck-typed surface nn.train_graph's k-step graph reads
        self.state: dict = {}
        self._fit_graphs: dict = {}
        self._gen = torch.Generator(device=self.device)
        self._it_dev = self._it_dev_val = None

        g = torch.Generator().manual_seed(int(seed))
        blocks = [tm.block_params(g, d_model, n_heads, d_ff) for _ in range(n_layers)]
        full = {
            "embed": 0.02 * torch.randn((vocab_size, d_model), generator=g),
            "pos": 0.02 * torch.randn((max_len, d_model), generator=g),
            "blocks": {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]},
            "lnf_g": torch.ones(d_model), "lnf_b": torch.zeros(d_model),
            "head": 0.02 * torch.randn((d_model, vocab_size), generator=g),
        }
        self.params = self._local(full)
        self.opt_state = self.updater.init_state(self.params)

    # -- layout ------------------------------------------------------------

    @property
    def tp(self) -> int:
        return self.mesh.shape["model"]

    def _coord(self, axis: str) -> int:
        return self.mesh.coords.get(axis, 0)

    def _local(self, full: dict) -> dict:
        """This rank's slice of a whole tree (the reference's layout:
        ``blocks`` stacked with a leading layer axis), on the device, keys
        sorted (as the updaters rebuild trees)."""
        tp, mi = self.tp, self._coord("model")
        pp, pi = self.mesh.shape["pipe"], self._coord("pipe")
        per = self.n_layers // pp

        def cut(t, dim):
            return t if dim is None or tp == 1 else t.chunk(tp, dim=dim)[mi]

        blocks = {k: cut(v[pi * per:(pi + 1) * per], None if k not in BLOCK_TP_DIM
                         else BLOCK_TP_DIM[k] + 1)
                  for k, v in full["blocks"].items()}
        out = {k: v for k, v in full.items() if k != "blocks"}
        out["head"] = cut(full["head"], 1)
        out["blocks"] = _sorted(blocks)
        return _sorted({k: v.contiguous().to(self.device) if k != "blocks" else
                        {b: t.contiguous().to(self.device) for b, t in v.items()}
                        for k, v in out.items()})

    def _gathered(self, tree: dict) -> dict:
        """The whole tree from every rank's slices (a collective over
        ``model`` and ``pipe``: every rank calls it)."""
        tp = self.tp
        if tp == 1 and self.mesh.shape["pipe"] == 1:
            return tree
        ax = self._axes_()

        def join(t, dim, axis):
            return t if axis.size == 1 else all_gather(t.detach(), axis, dim)

        blocks = {}
        for k, v in tree["blocks"].items():
            if k in BLOCK_TP_DIM and tp > 1:
                v = join(v, BLOCK_TP_DIM[k] + 1, ax["model"])
            blocks[k] = join(v, 0, ax["pipe"])
        out = {k: v for k, v in tree.items() if k != "blocks"}
        out["head"] = join(tree["head"], 1, ax["model"]) if tp > 1 else tree["head"]
        out["blocks"] = _sorted(blocks)
        return _sorted(out)

    def _axes_(self) -> Dict[str, Axis]:
        if self._axes is None:
            if self.mesh.size != process_count():
                raise RuntimeError(
                    f"the mesh spans {self.mesh.size} ranks but the process group has "
                    f"{process_count()}: call distributed.initialize() in every rank "
                    "before building the mesh")
            # graftcheck: disable=GC103 (memoized once: the axes are fixed for the model's life, so binding them at capture is what every replay reads)
            self._axes = {n: Axis(self.mesh, n) for n in CANONICAL}
        return self._axes

    # -- weights across packages -----------------------------------------------

    def load_params(self, params, opt_state=None) -> None:
        """Adopt the reference's whole parameter tree (numpy arrays:
        ``embed``, ``pos``, ``blocks`` stacked with a leading layer axis,
        ``lnf_g``, ``lnf_b``, ``head``) and optionally its updater state
        (Adam: ``{"m": tree, "v": tree}``, bfloat16 moments included);
        this rank keeps its slice.  The iteration is not touched."""
        from ..utils.params import params_from_numpy

        self.params = self._local(params_from_numpy(params, device="cpu"))
        if opt_state is None:
            self.opt_state = self.updater.init_state(self.params)
        else:
            self.opt_state = {k: self._local(params_from_numpy(v, device="cpu"))
                              if isinstance(v, dict) and "blocks" in v else v
                              for k, v in opt_state.items()}

    def params_numpy(self) -> dict:
        """The whole parameter tree as numpy arrays, gathered from every
        rank's slices (a collective: every rank calls it)."""
        from ..utils.params import params_to_numpy

        return params_to_numpy(self._gathered(self.params))

    def opt_state_numpy(self) -> dict:
        """The whole updater state as numpy (bf16 moments widen to f32)."""
        from ..utils.params import params_to_numpy

        return {k: params_to_numpy(self._gathered(v)) if isinstance(v, dict) and "blocks" in v
                else params_to_numpy(v) for k, v in self.opt_state.items()}

    # -- forward -----------------------------------------------------------

    def _attention(self):
        if self.mesh.shape["seq"] == 1:
            if self.attention_impl == "xla":
                return lambda q, k, v: mha(q, k, v, causal=True)
            return lambda q, k, v: flash_mha(q, k, v, True)
        fn = ulysses_attention if self.seq_parallel == "ulysses" else ring_attention
        return functools.partial(fn, axis=self._axes_()["seq"], causal=True)

    def _forward(self, params: dict, tokens: Tensor) -> Tensor:
        """This rank's logits [B_local, T_local, V / model] of its tokens."""
        cd = self.compute_dtype
        cast = (lambda a: a) if cd is None else (lambda a: a.to(cd))
        sh = self.mesh.shape
        model_axis = self._axes_()["model"] if self.tp > 1 else None
        t = tokens.shape[1]
        off = self._coord("seq") * t
        # an embedding lookup (its backward a sorted, deterministic segment
        # sum on the card, where indexing's would be atomic adds)
        h = F.embedding(tokens, cast(params["embed"])) + cast(params["pos"])[off:off + t]
        blocks = {k: cast(v) for k, v in params["blocks"].items()}
        block_fn = functools.partial(tm.block_apply, n_heads=self.n_heads_local,
                                     causal=True, attention_fn=self._attention(),
                                     psum_axis=model_axis)
        if sh["pipe"] == 1 and sh["seq"] == 1 and sh["model"] == 1:
            for i in range(self.n_layers):
                h = block_fn({k: v[i] for k, v in blocks.items()}, h)
        else:
            h = pipeline_apply(block_fn, blocks, h, self.mesh,
                               n_microbatches=self.n_microbatches,
                               schedule=self.schedule, stage_local=True)
        h = layer_norm(h, params["lnf_g"].to(h.dtype), params["lnf_b"].to(h.dtype))
        return matmul(pvary(h, model_axis), cast(params["head"]))

    def _local_loss(self, params: dict, tokens: Tensor, targets: Tensor) -> Tensor:
        """This rank's share of the global mean token loss."""
        sh = self.mesh.shape
        n = tokens.numel() * sh["data"] * sh["seq"]
        axis = self._axes_()["model"] if self.tp > 1 else None
        v0 = self._coord("model") * (self.vocab_size // self.tp)
        return sparse_softmax_xent(self._forward(params, tokens), targets, n, axis, v0)

    def _local_batch(self, a) -> Tensor:
        """This rank's block of a global [B, T] (or [k, B, T]) id array:
        its ``data`` rows and ``seq`` columns, on the device."""
        t = a if isinstance(a, Tensor) else torch.as_tensor(np.asarray(a))
        t = t.to(device=self.device, dtype=torch.long)
        sh = self.mesh.shape
        b, s = t.shape[-2], t.shape[-1]
        if b % sh["data"]:
            raise ValueError(f"global batch {b} not divisible by data={sh['data']}")
        if s % sh["seq"]:
            raise ValueError(f"sequence length {s} not divisible by seq={sh['seq']}")
        rb, rs = b // sh["data"], s // sh["seq"]
        di, si = self._coord("data"), self._coord("seq")
        return t[..., di * rb:(di + 1) * rb, si * rs:(si + 1) * rs].contiguous()

    def _sum_over_batch_lines(self, t: Tensor) -> Tensor:
        """``t`` summed over the ``data`` and ``seq`` lines."""
        ax = self._axes_() if self.mesh.size > 1 else {}
        for name in ("data", "seq"):
            if name in ax and ax[name].size > 1:
                t = all_reduce(t, ax[name])
        return t

    # -- training ----------------------------------------------------------

    def _compute_dtype(self):
        return torch.float32

    def _batch_at(self, inputs: dict, i: int):
        return inputs["tokens"][i], inputs["targets"][i]

    def _loss_and_grads(self, batch, carries=None, state_out=None):
        """(the global-batch loss, this rank's gradient slices summed over
        ``data`` and ``seq``, no carries) for this rank's (tokens,
        targets) block."""
        tokens, targets = batch
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(self.params)]
        live = tree_unflatten(self.params, leaves)
        with torch.enable_grad():
            loss = self._local_loss(live, tokens, targets)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        if self.mesh.shape["data"] * self.mesh.shape["seq"] > 1:
            flat = self._sum_over_batch_lines(torch.cat([g.reshape(-1) for g in grads]))
            grads = [c.view_as(g) for c, g in
                     zip(flat.split([g.numel() for g in grads]), grads)]
            loss = self._sum_over_batch_lines(loss.detach().reshape(1))[0]
        return loss.detach(), tree_unflatten(self.params, list(grads)), []

    def _apply_updates(self, grads, params, opt_state, it: Tensor):
        """The reference's step: ``updater.update`` per leaf (``moment_dtype``
        honoured), then ``p - u`` in the parameter's dtype."""
        updates, new_opt = self.updater.update(grads, opt_state, it)
        new_params = tree_map(lambda p, u: p - u.to(p.dtype), params, updates)
        return new_params, new_opt

    def _iter_tensor(self) -> Tensor:
        return torch.full((), float(self.iteration), dtype=torch.float32, device=self.device)

    def fit_batch(self, tokens, targets) -> LazyScore:
        """One step on the global [B, T] ``tokens``/``targets`` (int ids,
        the same on every rank; each rank takes its block) → the
        global-batch mean loss as a ``LazyScore``."""
        batch = (self._local_batch(tokens), self._local_batch(targets))
        loss, grads, _ = self._loss_and_grads(batch)
        with torch.no_grad():
            self.params, self.opt_state = self._apply_updates(
                grads, self.params, self.opt_state, self._iter_tensor())
        self.iteration += 1
        return LazyScore(loss)

    def fit_batches(self, tokens, targets) -> List[LazyScore]:
        """k steps on stacked [k, B, T] ``tokens``/``targets`` → k scores.

        On a one-rank mesh on the card the k steps are one CUDA graph
        (``nn.train_graph``: captured at the first call for these shapes,
        replayed after; bitwise the eager steps).  Across ranks, or on the
        CPU, they are k ``fit_batch`` steps with the same math: the
        collectives run over gloo through host copies, which a CUDA graph
        cannot capture."""
        if self.mesh.size == 1 and self.device.type == "cuda":
            from ..nn.train_graph import replay_steps

            stacked = {"tokens": self._local_batch(tokens),
                       "targets": self._local_batch(targets)}
            losses = replay_steps(self, stacked, int(stacked["tokens"].shape[0]))
            return [LazyScore(losses[i]) for i in range(losses.shape[0])]
        return [self.fit_batch(t, y) for t, y in zip(tokens, targets)]

    def logits(self, tokens) -> Tensor:
        """The whole [B, T, V] logits of the global ``tokens`` on every rank
        (a collective across ranks)."""
        with torch.no_grad():
            out = self._forward(self.params, self._local_batch(tokens))
            if self.mesh.size > 1:
                ax = self._axes_()
                out = all_gather(all_gather(all_gather(out, ax["model"], 2),
                                            ax["seq"], 1), ax["data"], 0)
        return out

    # -- autoregressive decode (serving/decode.py) -------------------------

    def decode_program(self, page_size: int = 16, max_len: Optional[int] = None):
        """Prefill / step / re-encode (and prefill_at, spec_step,
        step_multi) over the paged KV cache, for ``serving.DecodeEngine``.

        One-way on a one-rank mesh: the decode adapter's program
        (``models.transformer.build_decode_program``) with this LM's final norm
        and head; every per-position op runs through ``per_row`` and
        attention through ``det_attention`` (D1 on the card), so step
        logits are bitwise the re-encode's.

        On a mesh with every rank on ``data`` the program is
        TENSOR-PARALLEL, single-controller as the reference's is: this
        process holds ``data``-many head shards (shard s on
        ``decode_devices[s]``) with the page pool split to match
        (``ops.kv_cache.ShardedPages``), each shard projecting its head
        group (column slices of ``Wq/Wk/Wv``) and its rows of ``Wo``; the
        partial products are summed in shard order on the first device,
        and the FFN and head run once.  Its step logits are bitwise its
        own re-encode's (an n-way program's bits match its own re-encode,
        not a one-way program's).  Int8 pages and ``compute_dtype`` are
        refused, as in the reference."""
        n_dev = self.mesh.size
        tp = 1
        if n_dev != 1:
            tp = int(self.mesh.shape["data"])
            if tp != n_dev:
                raise NotImplementedError(
                    "sharded decode shards attention heads over the "
                    "'data' axis only — fold all devices into data= "
                    f"(got {dict(self.mesh.shape)})")
            if self.n_heads % tp:
                raise ValueError(
                    f"n_heads {self.n_heads} not divisible by the decode "
                    f"mesh's data={tp}")
        if self.compute_dtype is not None:
            raise NotImplementedError(
                "decode_program serves the f32 params path; compute_dtype "
                "casting would break the re-encode bit-identity contract")
        pos_rows = int(self.params["pos"].shape[0])
        n_heads = self.n_heads

        def layers(params):
            blocks = params["blocks"]
            return [{k: v[i] for k, v in blocks.items()} for i in range(self.n_layers)]

        def head(params, h):
            def rows(x):
                return matmul(layer_norm(x, params["lnf_g"], params["lnf_b"]),
                              params["head"])
            return tm.per_row(rows, h)

        if tp == 1:
            run_blocks = tm.one_way_blocks(layers, n_heads)
            devices = None
        else:
            devices = [torch.device(d) for d in (self.decode_devices or [self.device] * tp)]
            if len(devices) != tp:
                raise ValueError(f"decode_devices names {len(devices)} devices for "
                                 f"{tp} shards")
            run_blocks = tm.tensor_parallel_blocks(layers, n_heads, devices,
                                                   self._decode_cache)
        return tm.build_decode_program(
            tok_embed=lambda params, idx: params["embed"][idx],
            pos_embed=lambda params, pos: params["pos"][pos.clamp(0, pos_rows - 1)],
            head=head, run_blocks=run_blocks, n_layers=self.n_layers,
            n_heads=n_heads, d_head=int(self.params["embed"].shape[1]) // n_heads,
            vocab_size=self.vocab_size, pos_rows=pos_rows, page_size=page_size,
            max_len=max_len, tp=tp, shard_devices=devices)
