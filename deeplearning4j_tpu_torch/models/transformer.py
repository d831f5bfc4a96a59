"""TransformerLM — the flagship decoder-only LM (mirrors
``deeplearning4j_tpu/models/transformer.py``; scoring, training and
decode).

``block_params``/``block_apply`` hold the block math; the
``TransformerBlock`` layer (full-sequence scoring and training through
``MultiLayerNetwork``, attention through the flash kernels K1-K3) and
the decode adapter's prefill/step/re-encode (``kv_rows`` +
``ops.kv_cache.det_attention`` + ``finish_rows``) share every
per-position op.

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


def kv_rows(p: Dict[str, Tensor], x: Tensor) -> tuple:
    """First half of the block: (q, k, v) projections of LN(x), each
    [..., d_model] (heads not yet split)."""
    u = layer_norm(x, p["ln1_g"], p["ln1_b"])
    return matmul(u, p["Wq"]), matmul(u, p["Wk"]), matmul(u, p["Wv"])


def finish_rows(p: Dict[str, Tensor], x: Tensor, att: Tensor) -> Tensor:
    """Second half of the block: output projection of the merged heads
    ``att``, residual and FFN."""
    h = x + (matmul(att, p["Wo"]) + p["bo"])
    u = layer_norm(h, p["ln2_g"], p["ln2_b"])
    f = gelu(matmul(u, p["W1"]) + p["b1"])
    return h + matmul(f, p["W2"]) + p["b2"]


def block_apply(p: Dict[str, Tensor], h: Tensor, n_heads: int, *,
                causal: bool = True,
                attention_fn: Optional[Callable] = None) -> Tensor:
    """Pre-LN block: h + attn(LN(h)); h + FFN(LN(h)).  Attention
    defaults to ``flash_mha`` (kernels K1-K3 on the card)."""
    q, k, v = (split_heads(a, n_heads) for a in kv_rows(p, h))
    if attention_fn is None:
        attention_fn = lambda q, k, v: flash_mha(q, k, v, causal)
    return finish_rows(p, h, merge_heads(attention_fn(q, k, v)))


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
        from ..ops.kv_cache import (NEG_INF, DecodeProgram, det_attention,
                                    gather_layer, write_prefill, write_step,
                                    write_tokens)
        from ..ops.sampling import sample_tokens_device

        pos_rows = int(self.params["pos"]["P"].shape[0])
        if max_len is None:
            max_len = (pos_rows // page_size) * page_size
        if max_len % page_size or not (0 < max_len <= pos_rows):
            raise ValueError(
                f"max_len {max_len} must be a positive multiple of "
                f"page_size {page_size} and <= the position table "
                f"({pos_rows})")
        L = int(max_len)
        n_heads = self.n_heads
        vocab = self.vocab_size
        embed_lay, out_lay = self._embed_lay, self._out_lay
        d_model = int(self.params["embed"]["W"].shape[1])

        def tok_embed(params, idx):
            return embed_lay._lookup(params["embed"], idx)

        def pos_embed(params, pos):
            # positions past the table read its last row, as the
            # reference clips them
            return params["pos"]["P"][pos.clamp(0, pos_rows - 1)]

        def head(params, h):
            # pre-softmax logits, row by row
            return per_row(functools.partial(out_lay._pre, params["head"]), h)

        def kv_project(bp, h):
            return tuple(split_heads(a, n_heads)
                         for a in per_row(functools.partial(kv_rows, bp), h))

        def finish(bp, h, att_heads):
            return per_row(functools.partial(finish_rows, bp), h,
                           merge_heads(att_heads))

        def visible(q_pos, n_keys):
            """[..., n_keys] additive bias: key j visible iff j <= q_pos."""
            keys = torch.arange(n_keys, device=q_pos.device)
            return torch.where(keys <= q_pos[..., None], 0.0, NEG_INF).float()

        def blocks(params, k_pages, v_pages, h, bias, pt, write):
            """Every block over ``h`` [S, T, D]: project, ``write(pages,
            layer, kv [S, H, T, d])`` the new rows, attend over the
            slots' pages ``pt`` with D1."""
            for i, bp in enumerate(params["blocks"]):
                q, k, v = kv_project(bp, h)
                write(k_pages, i, k)
                write(v_pages, i, v)
                k_all = gather_layer(k_pages, i, pt).transpose(1, 2)
                v_all = gather_layer(v_pages, i, pt).transpose(1, 2)
                h = finish(bp, h, det_attention(q, k_all, v_all, bias))
            return h

        def prefill_at(params, k_pages, v_pages, page_table_row, tokens, n_real,
                       offset=0):
            tb = tokens.shape[0]
            pos = offset + torch.arange(tb, device=tokens.device)
            h = (tok_embed(params, tokens) + pos_embed(params, pos))[None]
            bias = visible(pos, L)[None, None]
            write = lambda pages, i, kv: write_prefill(
                pages, i, page_table_row, kv.transpose(1, 2)[0], offset)
            h = blocks(params, k_pages, v_pages, h, bias, page_table_row[None], write)
            return k_pages, v_pages, head(params, h[0, n_real - 1])

        def prefill(params, k_pages, v_pages, page_table_row, tokens, n_real):
            return prefill_at(params, k_pages, v_pages, page_table_row, tokens,
                              n_real, 0)

        def step(params, k_pages, v_pages, page_table, tokens, positions, active):
            h = (tok_embed(params, tokens) + pos_embed(params, positions))[:, None]
            bias = visible(positions, L)[:, None, None, :]
            pt = torch.where(active[:, None], page_table,
                             torch.zeros_like(page_table))
            write = lambda pages, i, kv: write_step(pages, i, pt, positions, kv[:, :, 0])
            h = blocks(params, k_pages, v_pages, h, bias, pt, write)
            return k_pages, v_pages, head(params, h)[:, 0]

        def spec_step(params, k_pages, v_pages, page_table, tokens, positions,
                      active):
            # T tokens per slot at positions[s]..positions[s]+T-1 in one
            # call; rows past a slot's capacity write the scratch page
            t_n = tokens.shape[1]
            pos = positions[:, None] + torch.arange(t_n, device=tokens.device)
            h = tok_embed(params, tokens) + pos_embed(params, pos)
            bias = visible(pos, L)[:, None]
            pt = torch.where(active[:, None], page_table,
                             torch.zeros_like(page_table))
            write = lambda pages, i, kv: write_tokens(pages, i, pt, positions,
                                                      kv.transpose(1, 2))
            h = blocks(params, k_pages, v_pages, h, bias, pt, write)
            return k_pages, v_pages, head(params, h)

        def step_multi(params, k_pages, v_pages, page_table, tokens, positions,
                       active, temps, top_ks, top_ps, seeds, steps, budgets,
                       eos_id, horizon):
            # ``horizon`` steps of ``step``'s body, sampling on the device;
            # a slot that stops drops out of ``alive`` and its table row
            # zeroes, so its later writes go to the scratch page
            toks, fins, lgs_all = [], [], []
            tok, alive = tokens, active
            for j in range(int(horizon)):
                pos_j = positions + j
                pt = torch.where(alive[:, None], page_table,
                                 torch.zeros_like(page_table))
                h = (tok_embed(params, tok) + pos_embed(params, pos_j))[:, None]
                bias = visible(pos_j, L)[:, None, None, :]
                write = lambda pages, i, kv, pt=pt, pos_j=pos_j: write_step(
                    pages, i, pt, pos_j, kv[:, :, 0])
                lgs = head(params, blocks(params, k_pages, v_pages, h, bias, pt,
                                          write))[:, 0]
                nxt, fin = sample_tokens_device(lgs, temps, top_ks, top_ps, seeds,
                                                steps + j, vocab)
                alive = alive & fin & (nxt != eos_id) & (j + 1 < budgets)
                tok = nxt
                toks.append(nxt)
                fins.append(fin)
                lgs_all.append(lgs)
            return (k_pages, v_pages, torch.stack(toks), torch.stack(fins),
                    torch.stack(lgs_all))

        def reencode(params, tokens):
            b, t = tokens.shape
            h = tok_embed(params, tokens) + params["pos"]["P"][:t]
            bias = visible(torch.arange(t, device=h.device), t)[None, None]
            for bp in params["blocks"]:
                q, k, v = kv_project(bp, h)
                h = finish(bp, h, det_attention(q, k, v, bias))
            return head(params, h)

        return DecodeProgram(
            prefill=prefill, step=step, reencode=reencode,
            n_layers=self._n_blocks, n_heads=n_heads,
            d_head=d_model // n_heads, vocab_size=vocab,
            max_len=L, page_size=page_size, pages_per_slot=L // page_size,
            prefill_at=prefill_at, spec_step=spec_step, step_multi=step_multi)
