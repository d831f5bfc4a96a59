"""Attention layers (mirrors ``deeplearning4j_tpu/nn/layers/attention.py``:
``SelfAttention`` and ``LearnedSelfAttention``).

Layer I/O is [batch, time, features]; heads are split to [B, H, T, D]
inside.  ``kernel="flash"`` runs ``ops.attention.flash_mha`` (K1 forward,
K2/K3 backward on the card), with a [B, T] sequence mask as the kernels'
key mask; ``kernel="xla"`` runs the plain ``mha``.  The reference takes
its Pallas kernel only when T and S tile by 8 and ``mha`` otherwise; the
CUDA kernels mask ragged edges themselves, so here every shape takes
them.  A query row whose every key is masked gets zero output and zero
gradients from the kernels; the layer's output mask zeroes that row
anyway.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ...ops.attention import flash_mha, merge_heads, mha, split_heads
from ...ops.dtypes import matmul
from ...ops.initializers import init_weight
from ..conf.inputs import InputType
from .base import ForwardOut, Layer, register_layer

Tensor = torch.Tensor


@register_layer
@dataclasses.dataclass
class SelfAttention(Layer):
    """Multi-head self-attention over a sequence: input [B, T, n_in] to
    per-head q/k/v, attention (optionally causal), and back to n_out.
    With ``project_out=False`` and n_out == n_heads * head_dim the output
    projection is skipped."""

    n_in: int = 0
    n_out: int = 0
    n_heads: int = 4
    head_dim: int = 0          # 0 → n_out // n_heads
    causal: bool = False
    kernel: str = "flash"      # "flash" | "xla"
    project_out: bool = True

    wants = "rnn"

    def _head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_out % self.n_heads:
            raise ValueError(
                f"n_out {self.n_out} not divisible by n_heads {self.n_heads}; "
                "set head_dim explicitly")
        return self.n_out // self.n_heads

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, in_type.timesteps)

    def infer_nin(self, in_type: InputType) -> None:
        if not self.n_in:
            self.n_in = in_type.size
        if not self.n_out:
            self.n_out = in_type.size

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        proj = self.n_heads * self._head_dim()

        def w(n_in, n_out):
            return init_weight((n_in, n_out), self._winit(), n_in, n_out, dtype, generator)
        params = {"Wq": w(self.n_in, proj), "Wk": w(self.n_in, proj),
                  "Wv": w(self.n_in, proj)}
        if self.project_out:
            params["Wo"] = w(proj, self.n_out)
            params["b"] = torch.full((self.n_out,), float(self.bias_init), dtype=dtype)
        elif proj != self.n_out:
            raise ValueError(
                f"project_out=False requires n_heads*head_dim == n_out "
                f"({proj} != {self.n_out})")
        return params

    def _split_heads(self, x: Tensor) -> Tensor:
        return split_heads(x, self.n_heads)

    def _out(self, params, out: Tensor) -> Tensor:
        merged = merge_heads(out)
        if self.project_out:
            merged = matmul(merged, params["Wo"]) + params["b"]
        return self._act(merged)

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        x = self._maybe_dropout(x, train, generator)
        q = self._split_heads(matmul(x, params["Wq"]))     # [B,H,T,D]
        k = self._split_heads(matmul(x, params["Wk"]))
        v = self._split_heads(matmul(x, params["Wv"]))
        if self.kernel == "flash":
            out = flash_mha(q, k, v, self.causal, kmask=mask)
        elif mask is not None:
            out = mha(q, k, v, causal=self.causal, mask=mask[:, None, None, :])
        else:
            out = mha(q, k, v, causal=self.causal)
        y = self._out(params, out)
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return ForwardOut(y, state, mask)


@register_layer
@dataclasses.dataclass
class LearnedSelfAttention(SelfAttention):
    """Self-attention with ``n_queries`` learned query vectors: a fixed
    [B, n_queries, n_out] summary of a variable-length sequence."""

    n_queries: int = 1

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, self.n_queries)

    def init_params(self, generator, in_type, dtype=torch.float32) -> Dict[str, Tensor]:
        if self.causal:
            raise ValueError("LearnedSelfAttention does not support causal=True")
        params = super().init_params(generator, in_type, dtype)
        del params["Wq"]  # queries are free parameters, not a projection
        proj = self.n_heads * self._head_dim()
        params["Q"] = init_weight((self.n_queries, proj), self._winit(), self.n_in,
                                  proj, dtype, generator)
        return params

    def forward(self, params, state, x, *, train=False, generator=None,
                mask=None) -> ForwardOut:
        x = self._maybe_dropout(x, train, generator)
        b = x.shape[0]
        q = self._split_heads(params["Q"].to(x.dtype).expand((b,) + tuple(params["Q"].shape)))
        k = self._split_heads(matmul(x, params["Wk"]))
        v = self._split_heads(matmul(x, params["Wv"]))
        if mask is not None:
            out = mha(q, k, v, mask=mask[:, None, None, :])
        elif self.kernel == "flash":
            out = flash_mha(q.contiguous(), k, v, False)
        else:
            out = mha(q, k, v)
        return ForwardOut(self._out(params, out), state, None)
