"""TransformerLM — the flagship decoder-only LM (mirrors
``deeplearning4j_tpu/models/transformer.py``; scoring, training and
decode).

``block_params``/``block_apply`` hold the block math; the
``TransformerBlock`` layer (full-sequence scoring and training through
``MultiLayerNetwork``, attention through the flash kernels K1-K3) and
the decode adapter's prefill/step/re-encode (``kv_rows`` +
``ops.kv_cache.det_attention`` + ``finish_rows``) share every
per-position op.  ``build_decode_program`` assembles that program from a
decoder's pieces, for the adapter and for
``parallel.ShardedTransformerLM``: one-way (``one_way_blocks``) or over
head shards held by one process (``tensor_parallel_blocks``).

The decode program holds the reference's contract that decode logits
are bitwise the re-encode logits.  cuBLAS and PyTorch's reductions pick
their kernels, and with them the order of their sums, by shape, so the
program runs every per-position op through ``per_row``: rows in chunks
of exactly ``DECODE_ROWS``, zero-padded, so each GEMM and layer norm
sees the same shape whether it serves a 4-slot step, a prefill bucket
or a re-encode.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Union

import torch

from ..nn.conf.inputs import InputType
from ..nn.layers import EmbeddingSequence, RnnOutputLayer
from ..nn.layers.base import ForwardOut, Layer, register_layer
from ..nn.layers.normalization import layer_norm
from ..nn.multilayer import MultiLayerNetwork, NeuralNetConfiguration
from ..nn.updaters import Adam, GradientNormalization, Updater
from ..ops.activations import gelu
from ..ops.attention import flash_mha, merge_heads, mha, split_heads
from ..ops.dtypes import matmul
from ..ops.initializers import init_weight
from ..parallel.collectives import psum, pvary
from ..utils.device import DeviceLike

Tensor = torch.Tensor

#: rows per chunk of every per-position op in the decode program
DECODE_ROWS = 64


def block_params(generator: torch.Generator, d_model: int, n_heads: int,
                 d_ff: int, dtype=torch.float32,
                 weight_init: str = "xavier") -> Dict[str, Tensor]:
    """One pre-LN transformer block's parameter dict (on the CPU)."""
    d = d_model

    def w(shape, fi, fo):
        return init_weight(shape, weight_init, fi, fo, dtype, generator)

    return {
        "ln1_g": torch.ones(d, dtype=dtype), "ln1_b": torch.zeros(d, dtype=dtype),
        "Wq": w((d, d), d, d), "Wk": w((d, d), d, d),
        "Wv": w((d, d), d, d), "Wo": w((d, d), d, d),
        "bo": torch.zeros(d, dtype=dtype),
        "ln2_g": torch.ones(d, dtype=dtype), "ln2_b": torch.zeros(d, dtype=dtype),
        "W1": w((d, d_ff), d, d_ff), "b1": torch.zeros(d_ff, dtype=dtype),
        "W2": w((d_ff, d), d_ff, d), "b2": torch.zeros(d, dtype=dtype),
    }


def kv_rows(p: Dict[str, Tensor], x: Tensor, psum_axis=None) -> tuple:
    """First half of the block: (q, k, v) projections of LN(x), each
    [..., d_model] (heads not yet split).  ``psum_axis`` (a
    ``parallel.collectives.Axis``): ``Wq/Wk/Wv`` hold this rank's
    columns, so LN(x) enters them through ``pvary`` (its gradient is
    summed over the axis)."""
    u = pvary(layer_norm(x, p["ln1_g"], p["ln1_b"]), psum_axis)
    return matmul(u, p["Wq"]), matmul(u, p["Wk"]), matmul(u, p["Wv"])


def finish_rows(p: Dict[str, Tensor], x: Tensor, att: Tensor, psum_axis=None) -> Tensor:
    """Second half of the block: output projection of the merged heads
    ``att``, residual and FFN.  ``psum_axis``: ``att`` holds this rank's
    heads and ``Wo`` their rows, ``W1/b1`` this rank's columns and ``W2``
    their rows, so each row-parallel product is summed over the axis
    before its bias (the reference's ``block_apply`` psums)."""
    return ffn_rows(p, x, psum(matmul(att, p["Wo"]), psum_axis), psum_axis)


def ffn_rows(p: Dict[str, Tensor], x: Tensor, proj: Tensor, ffn_axis=None) -> Tensor:
    """The block after the output projection ``proj`` (merged heads ·
    ``Wo``): bias, residual and FFN (``finish_rows``' tail); ``ffn_axis``
    splits the FFN's columns as ``finish_rows``' axis does."""
    h = x + (proj + p["bo"])
    u = pvary(layer_norm(h, p["ln2_g"], p["ln2_b"]), ffn_axis)
    f = gelu(matmul(u, p["W1"]) + p["b1"])
    return h + psum(matmul(f, p["W2"]), ffn_axis) + p["b2"]


def block_apply(p: Dict[str, Tensor], h: Tensor, n_heads: int, *,
                causal: bool = True,
                attention_fn: Optional[Callable] = None,
                psum_axis=None) -> Tensor:
    """Pre-LN block: h + attn(LN(h)); h + FFN(LN(h)).  Attention
    defaults to ``flash_mha`` (kernels K1-K3 on the card).
    ``psum_axis`` (a ``parallel.collectives.Axis``): the projections are
    tensor-parallel over it (heads and FFN columns split), so the
    row-parallel ``Wo`` and ``W2`` products are summed over it before
    their biases; None on one device."""
    q, k, v = (split_heads(a, n_heads) for a in kv_rows(p, h, psum_axis))
    if attention_fn is None:
        attention_fn = lambda q, k, v: flash_mha(q, k, v, causal)
    return finish_rows(p, h, merge_heads(attention_fn(q, k, v)), psum_axis)


def per_row(fn: Callable, *xs: Tensor, rows: Optional[int] = None):
    """``fn`` over inputs [..., K_i] that share their leading shape, in
    chunks of exactly ``rows`` rows (``DECODE_ROWS``, read at each call,
    by default) of one zero-padded [n_chunks·rows, K_i] buffer, so every
    call of ``fn`` sees the same shapes and alignment and a row's bits do
    not depend on how many rows came with it.  ``fn`` returns a tensor or
    a tuple of tensors of [rows, N]; the result has the inputs' leading
    shape."""
    rows = DECODE_ROWS if rows is None else rows
    lead = xs[0].shape[:-1]
    n = xs[0].numel() // xs[0].shape[-1]
    padded = -(-n // rows) * rows
    bufs = []
    for x in xs:
        buf = x.new_zeros(padded, x.shape[-1])
        buf[:n] = x.reshape(n, x.shape[-1])
        bufs.append(buf)
    outs = [fn(*(b[a:a + rows] for b in bufs)) for a in range(0, padded, rows)]

    def join(chunks):
        y = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        return y[:n].reshape(*lead, -1)

    if isinstance(outs[0], tuple):
        return tuple(join(c) for c in zip(*outs))
    return join(outs)


@register_layer
@dataclasses.dataclass
class TransformerBlock(Layer):
    """Pre-LN decoder block as one layer [B,T,D] → [B,T,D]."""

    d_model: int = 0
    n_heads: int = 8
    d_ff: int = 0              # 0 → 4*d_model
    causal: bool = True
    kernel: str = "flash"      # "flash" | "xla" (the plain mha path)

    wants = "rnn"

    def infer_nin(self, in_type: InputType) -> None:
        if not self.d_model:
            self.d_model = in_type.size
        if not self.d_ff:
            self.d_ff = 4 * self.d_model

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(self.d_model, in_type.timesteps)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return block_params(generator, self.d_model, self.n_heads,
                            self.d_ff or 4 * self.d_model, dtype, self._winit())

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        x = self._maybe_dropout(x, train, generator)
        # a layer mask, or kernel="xla", takes the plain mha path (as in
        # the reference); otherwise attention runs through flash_mha
        # (K1 forward, K2/K3 backward on the card)
        if mask is not None or self.kernel == "xla":
            att_mask = mask[:, None, None, :] if mask is not None else None
            attention_fn = lambda q, k, v: mha(q, k, v, causal=self.causal,
                                               mask=att_mask)
        else:
            attention_fn = None
        y = block_apply(params, x, self.n_heads, causal=self.causal,
                        attention_fn=attention_fn)
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return ForwardOut(y, state, mask)


@register_layer
@dataclasses.dataclass
class PositionalEmbedding(Layer):
    """Learned absolute positions added to the sequence embedding."""

    max_len: int = 512
    d_model: int = 0

    wants = "rnn"

    def infer_nin(self, in_type: InputType) -> None:
        if not self.d_model:
            self.d_model = in_type.size

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        return {"P": (0.02 * torch.randn((self.max_len, self.d_model),
                                         generator=generator)).to(dtype)}

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        t = x.shape[1]
        return ForwardOut(x + params["P"][:t].to(x.dtype), state, mask)


def TransformerLM(vocab_size: int = 256, n_layers: int = 4, d_model: int = 256,
                  n_heads: int = 8, d_ff: int = 0, max_len: int = 512,
                  seed: int = 42, updater: Union[Updater, dict, None] = None,
                  kernel: str = "flash", dtype=None,
                  device: DeviceLike = None) -> MultiLayerNetwork:
    """Decoder-only LM: EmbeddingSequence + positions + N blocks + head,
    initialized from ``seed`` on ``device`` (default ``cuda``).
    ``updater`` is an updater object or its configuration dict (default
    ``Adam(lr=3e-4)``); gradients are clipped per layer to L2 norm 1.
    ``dtype`` is one dtype name or a (param, compute) pair, as in the
    reference; under ``("float32", "bfloat16")`` the blocks still compute
    in float32 (the embedding gathers float32 rows from integer ids)."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater or Adam(lr=3e-4))
         .gradient_normalization(GradientNormalization.CLIP_L2_PER_LAYER, 1.0)
         .layer(EmbeddingSequence(n_in=vocab_size, n_out=d_model))
         .layer(PositionalEmbedding(max_len=max_len, d_model=d_model)))
    for _ in range(n_layers):
        b.layer(TransformerBlock(d_model=d_model, n_heads=n_heads, d_ff=d_ff,
                                 kernel=kernel))
    b.layer(RnnOutputLayer(n_out=vocab_size, activation="softmax", loss="mcxent"))
    b.set_input_type(InputType.recurrent(vocab_size, max_len))
    if dtype is not None:
        b.dtype(*dtype) if isinstance(dtype, tuple) else b.dtype(dtype)
    net = MultiLayerNetwork(b.build(), device=device)
    net.init()
    return net


class TransformerDecodeAdapter:
    """Serve a ``TransformerLM`` network through ``serving.DecodeEngine``:
    ``params`` plus ``decode_program()``, whose prefill / step /
    re-encode share the embedding lookup, position add, ``kv_rows`` /
    ``finish_rows`` and the pre-softmax head (each through ``per_row``)
    and ``det_attention`` (kernel D1 on the card).  The wrapped network
    is untouched."""

    def __init__(self, net: MultiLayerNetwork):
        layers = net.conf.layers
        ok = (len(layers) >= 4
              and isinstance(layers[0], EmbeddingSequence)
              and isinstance(layers[1], PositionalEmbedding)
              and all(isinstance(l, TransformerBlock) for l in layers[2:-1])
              and isinstance(layers[-1], RnnOutputLayer))
        if not ok:
            raise ValueError(
                "TransformerDecodeAdapter needs the TransformerLM stack "
                "(EmbeddingSequence, PositionalEmbedding, TransformerBlock "
                "x N, RnnOutputLayer); got "
                + ", ".join(type(l).__name__ for l in layers))
        if net.conf.compute_dtype != "float32" or net.conf.param_dtype != "float32":
            raise NotImplementedError(
                "decode serves the float32 params path; dtypes "
                f"{net.conf.param_dtype}/{net.conf.compute_dtype} are not served")
        self.net = net
        self.device = net.device
        self._embed_lay = layers[0]
        self._out_lay = layers[-1]
        self._n_blocks = len(layers) - 3
        self.n_heads = int(layers[2].n_heads)
        self.vocab_size = int(self._out_lay.n_out)
        self.params = {
            "embed": net.params[0], "pos": net.params[1],
            "blocks": [net.params[2 + i] for i in range(self._n_blocks)],
            "head": net.params[len(layers) - 1],
        }

    def decode_program(self, page_size: int = 16, max_len: Optional[int] = None):
        pos_rows = int(self.params["pos"]["P"].shape[0])
        embed_lay, out_lay = self._embed_lay, self._out_lay
        d_model = int(self.params["embed"]["W"].shape[1])
        return build_decode_program(
            tok_embed=lambda params, idx: embed_lay._lookup(params["embed"], idx),
            pos_embed=lambda params, pos: params["pos"]["P"][pos.clamp(0, pos_rows - 1)],
            head=lambda params, h: per_row(functools.partial(out_lay._pre, params["head"]), h),
            run_blocks=one_way_blocks(lambda params: params["blocks"], self.n_heads),
            n_layers=self._n_blocks, n_heads=self.n_heads,
            d_head=d_model // self.n_heads, vocab_size=self.vocab_size,
            pos_rows=pos_rows, page_size=page_size, max_len=max_len)


def paged(k_pages, v_pages, i: int, k: Tensor, v: Tensor, pt, write):
    """Layer ``i``'s new K/V rows [S, H, T, d] written into the pools
    (``write``), then the slots' whole K/V [S, H, L, d] gathered through
    the page table ``pt``; with no pools (the re-encode) ``k``/``v``
    themselves."""
    from ..ops.kv_cache import gather_layer

    if k_pages is None:
        return k, v
    write(k_pages, i, k)
    write(v_pages, i, v)
    return (gather_layer(k_pages, i, pt).transpose(1, 2),
            gather_layer(v_pages, i, pt).transpose(1, 2))


def one_way_blocks(layers: Callable, n_heads: int) -> Callable:
    """The decode program's block stack on one device: for each layer of
    ``layers(params)``, project (``kv_rows`` through ``per_row``), write
    the new K/V rows, attend over the slots' pages with ``det_attention``
    (D1 on the card) and finish (``finish_rows`` through ``per_row``)."""
    from ..ops.kv_cache import det_attention

    def run(params, k_pages, v_pages, h, bias, pt, write):
        for i, bp in enumerate(layers(params)):
            q, k, v = (split_heads(a, n_heads)
                       for a in per_row(functools.partial(kv_rows, bp), h))
            k_all, v_all = paged(k_pages, v_pages, i, k, v, pt, write)
            h = per_row(functools.partial(finish_rows, bp), h,
                        merge_heads(det_attention(q, k_all, v_all, bias)))
        return h

    return run


_SHARD_COLS = ("Wq", "Wk", "Wv")


def tensor_parallel_blocks(layers: Callable, n_heads: int, devices, cache: dict) -> Callable:
    """The block stack of a tensor-parallel decode program held by one
    process: shard s (on ``devices[s]``) projects its head group with its
    columns of ``Wq/Wk/Wv`` against its pool shard (``k_pages[s]``),
    attends with D1 and multiplies by its rows of ``Wo``; the partial
    products are summed in shard order on ``devices[0]``, where the bias,
    residual and FFN run once (``ffn_rows``).  Every per-position op runs
    through ``per_row``.  Each layer's shard weights are sliced once per
    parameter tree (``cache``, keyed by the tree and its first ``Wq``'s
    storage)."""
    from ..ops.kv_cache import det_attention

    tp = len(devices)
    hl = n_heads // tp

    def shards(params):
        blocks = layers(params)
        key = (id(params), blocks[0]["Wq"].data_ptr()) if blocks else None
        if cache.get("key") != key:
            w = blocks[0]["Wq"].shape[1] // tp if blocks else 0
            cache["key"] = key
            cache["shards"] = [[{
                **{k: bp[k].to(dev) for k in ("ln1_g", "ln1_b")},
                **{k: bp[k][:, s * w:(s + 1) * w].contiguous().to(dev) for k in _SHARD_COLS},
                "Wo": bp["Wo"][s * w:(s + 1) * w].contiguous().to(dev),
            } for s, dev in enumerate(devices)] for bp in blocks]
        return blocks, cache["shards"]

    def run(params, k_pages, v_pages, h, bias, pt, write):
        blocks, per_layer = shards(params)
        for i, (bp, sh) in enumerate(zip(blocks, per_layer)):
            proj = None
            for s, (sp, dev) in enumerate(zip(sh, devices)):
                q, k, v = (split_heads(a, hl)
                           for a in per_row(functools.partial(kv_rows, sp), h.to(dev)))
                k_all, v_all = (k, v) if k_pages is None else paged(
                    k_pages[s], v_pages[s], i, k, v, pt.to(dev), write)
                att = merge_heads(det_attention(q, k_all, v_all, bias.to(dev)))
                part = per_row(lambda a, wo=sp["Wo"]: matmul(a, wo), att).to(devices[0])
                proj = part if proj is None else proj + part
            h = per_row(functools.partial(ffn_rows, bp), h, proj)
        return h

    return run


def build_decode_program(*, tok_embed: Callable, pos_embed: Callable, head: Callable,
                   run_blocks: Callable, n_layers: int, n_heads: int, d_head: int,
                   vocab_size: int, pos_rows: int, page_size: int,
                   max_len: Optional[int] = None, tp: int = 1, shard_devices=None):
    """A ``DecodeProgram`` from a decoder's pieces: ``tok_embed(params,
    ids)``, ``pos_embed(params, positions)`` (positions past the table read
    its last row, as the reference clips them), ``head(params, h)`` (the
    logits, row by row) and ``run_blocks(params, k_pages, v_pages, h,
    bias, page_table, write)`` (``one_way_blocks`` or
    ``tensor_parallel_blocks``).  Prefill, step, prefill_at, spec_step,
    step_multi and re-encode share every per-position op."""
    from ..ops.kv_cache import (NEG_INF, DecodeProgram, write_prefill, write_step,
                                write_tokens)
    from ..ops.sampling import sample_tokens_device

    if max_len is None:
        max_len = (pos_rows // page_size) * page_size
    if max_len % page_size or not (0 < max_len <= pos_rows):
        raise ValueError(
            f"max_len {max_len} must be a positive multiple of "
            f"page_size {page_size} and <= the position table "
            f"({pos_rows})")
    L = int(max_len)

    def visible(q_pos, n_keys):
        """[..., n_keys] additive bias: key j visible iff j <= q_pos."""
        keys = torch.arange(n_keys, device=q_pos.device)
        return torch.where(keys <= q_pos[..., None], 0.0, NEG_INF).float()

    def on(t, pages):
        """``t`` on the device of a pool (a head shard's, in a
        tensor-parallel program)."""
        first = pages[0] if isinstance(pages, tuple) else pages
        return t.to(first.device)

    def prefill_at(params, k_pages, v_pages, page_table_row, tokens, n_real, offset=0):
        tb = tokens.shape[0]
        pos = offset + torch.arange(tb, device=tokens.device)
        h = (tok_embed(params, tokens) + pos_embed(params, pos))[None]
        bias = visible(pos, L)[None, None]
        write = lambda pages, i, kv: write_prefill(
            pages, i, on(page_table_row, pages), kv.transpose(1, 2)[0], offset)
        h = run_blocks(params, k_pages, v_pages, h, bias, page_table_row[None], write)
        return k_pages, v_pages, head(params, h[0, n_real - 1])

    def prefill(params, k_pages, v_pages, page_table_row, tokens, n_real):
        return prefill_at(params, k_pages, v_pages, page_table_row, tokens, n_real, 0)

    def step(params, k_pages, v_pages, page_table, tokens, positions, active):
        h = (tok_embed(params, tokens) + pos_embed(params, positions))[:, None]
        bias = visible(positions, L)[:, None, None, :]
        pt = torch.where(active[:, None], page_table, torch.zeros_like(page_table))
        write = lambda pages, i, kv: write_step(pages, i, on(pt, pages),
                                                on(positions, pages), kv[:, :, 0])
        h = run_blocks(params, k_pages, v_pages, h, bias, pt, write)
        return k_pages, v_pages, head(params, h)[:, 0]

    def spec_step(params, k_pages, v_pages, page_table, tokens, positions, active):
        # T tokens per slot at positions[s]..positions[s]+T-1 in one
        # call; rows past a slot's capacity write the scratch page
        t_n = tokens.shape[1]
        pos = positions[:, None] + torch.arange(t_n, device=tokens.device)
        h = tok_embed(params, tokens) + pos_embed(params, pos)
        bias = visible(pos, L)[:, None]
        pt = torch.where(active[:, None], page_table, torch.zeros_like(page_table))
        write = lambda pages, i, kv: write_tokens(pages, i, on(pt, pages),
                                                  on(positions, pages), kv.transpose(1, 2))
        h = run_blocks(params, k_pages, v_pages, h, bias, pt, write)
        return k_pages, v_pages, head(params, h)

    def step_multi(params, k_pages, v_pages, page_table, tokens, positions, active,
                   temps, top_ks, top_ps, seeds, steps, budgets, eos_id, horizon: int):
        # ``horizon`` steps of ``step``'s body, sampling on the device; a
        # slot that stops drops out of ``alive`` and its table row zeroes,
        # so its later writes go to the scratch page
        toks, fins, lgs_all = [], [], []
        tok, alive = tokens, active
        for j in range(int(horizon)):
            pos_j = positions + j
            pt = torch.where(alive[:, None], page_table, torch.zeros_like(page_table))
            h = (tok_embed(params, tok) + pos_embed(params, pos_j))[:, None]
            bias = visible(pos_j, L)[:, None, None, :]
            write = lambda pages, i, kv, pt=pt, pos_j=pos_j: write_step(
                pages, i, on(pt, pages), on(pos_j, pages), kv[:, :, 0])
            lgs = head(params, run_blocks(params, k_pages, v_pages, h, bias, pt,
                                          write))[:, 0]
            nxt, fin = sample_tokens_device(lgs, temps, top_ks, top_ps, seeds,
                                            steps + j, vocab_size)
            alive = alive & fin & (nxt != eos_id) & (j + 1 < budgets)
            tok = nxt
            toks.append(nxt)
            fins.append(fin)
            lgs_all.append(lgs)
        return (k_pages, v_pages, torch.stack(toks), torch.stack(fins),
                torch.stack(lgs_all))

    def reencode(params, tokens):
        b, t = tokens.shape
        pos = torch.arange(t, device=tokens.device)
        h = tok_embed(params, tokens) + pos_embed(params, pos)
        bias = visible(pos, t)[None, None]
        # no pools: each layer attends over the sequence's own K/V
        return head(params, run_blocks(params, None, None, h, bias, None, None))

    return DecodeProgram(
        prefill=prefill, step=step, reencode=reencode,
        n_layers=n_layers, n_heads=n_heads, d_head=d_head, vocab_size=vocab_size,
        max_len=L, page_size=page_size, pages_per_slot=L // page_size,
        prefill_at=prefill_at, spec_step=spec_step, step_multi=step_multi,
        tp=tp, shard_devices=shard_devices)
