"""GloVe — global vectors from a weighted co-occurrence factorization (the
port of ``deeplearning4j_tpu/nlp/glove.py``).

Parity targets: reference models/glove/Glove.java (Builder: xMax, alpha,
learningRate, epochs, symmetric) + models/glove/AbstractCoOccurrences.java
(windowed 1/distance-weighted counting) + the AdaGrad element math in
GloveWeightLookupTable.

The nonzero co-occurrence entries are shuffled into fixed-size batches and
each batch is one step on the card — batched gathers and products for the
loss, ordered row scatter-adds (``ops.scatter.add_rows``) for the
sparse AdaGrad update, whose history is added before it is read back at
the batch's rows, as the reference's ``.at[idx].add`` then ``hist[idx]``.
The entries live on the device for the whole fit; each epoch uploads only
its permutation (numpy's, from the seed, as the reference's).
Loss (Pennington et al. 2014):
    J = Σ f(X_ij) (wᵢ·w̃ⱼ + bᵢ + b̃ⱼ − log X_ij)²,   f(x) = min(1, (x/xmax)^α)

``CoOccurrences`` counts with numpy in one vectorized pass that yields the
reference's dictionary exactly: the same keys in the same insertion order,
each weight summed in the reference's order (``np.bincount`` adds in
stream order from 0.0, as ``dict.get(key, 0.0) + w`` does), through one
sort of the pair keys.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from ..ops.scatter import add_rows
from .sequencevectors import WordVectorsBase
from .tokenization import DefaultTokenizerFactory
from .vocab import VocabCache, build_vocab

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _glove_step(W, Wc, b, bc, hW, hWc, hb, hbc, rows, cols, logx, fx, lr):
    """One AdaGrad batch over co-occurrence entries, in place; returns the
    batch loss (a 0-d tensor on the tables' device).

    W/Wc [V,D] center/context tables, b/bc [V] biases, h* AdaGrad
    accumulators.  rows/cols [B] word indices, logx [B] = log X_ij,
    fx [B] = f(X_ij) weights (0 for padding rows).
    """
    wi = W[rows]                      # [B,D]
    wj = Wc[cols]
    diff = torch.einsum("bd,bd->b", wi, wj) + b[rows] + bc[cols] - logx  # [B]
    fdiff = fx * diff                 # [B]
    loss = 0.5 * torch.sum(fdiff * diff)

    gwi = fdiff[:, None] * wj         # [B,D]
    gwj = fdiff[:, None] * wi

    # AdaGrad: accumulate squared grads, scale update by 1/sqrt(hist)
    def upd(table, hist, idx, g):
        add_rows(hist, idx, g * g)
        step = lr * g / torch.sqrt(torch.clamp(hist[idx], min=1e-12))
        add_rows(table, idx, -step)

    upd(W, hW, rows, gwi)
    upd(Wc, hWc, cols, gwj)
    upd(b, hb, rows, fdiff)
    upd(bc, hbc, cols, fdiff)
    return loss


class CoOccurrences:
    """Windowed co-occurrence counting with 1/distance weighting
    (reference AbstractCoOccurrences.java, symmetric window)."""

    def __init__(self, window: int = 15, symmetric: bool = True):
        self.window = window
        self.symmetric = symmetric

    def count_arrays(self, idx_corpus: Iterable[np.ndarray]
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows int64, cols int64, weights float64) of every counted pair,
        in the order the reference's dictionary first meets each pair."""
        sents = [np.asarray(s, np.int64) for s in idx_corpus]
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
        if not sents or not any(len(s) for s in sents):
            return empty
        toks = np.concatenate(sents)
        sids = np.repeat(np.arange(len(sents)), [len(s) for s in sents])
        n, vocab = len(toks), int(toks.max()) + 1
        dist = np.arange(1, self.window + 1)
        j = np.arange(n)[:, None] + dist[None, :]                 # [n, W]
        jc = np.minimum(j, n - 1)
        ok = (j < n) & (sids[jc] == sids[:, None])
        w = np.broadcast_to(toks[:, None], j.shape)
        c = toks[jc]
        wt = np.broadcast_to(1.0 / dist[None, :], j.shape)
        if self.symmetric:
            # the (w, c) event, then its mirror (c, w), for each pair
            keys = np.stack([w * vocab + c, c * vocab + w], axis=-1)[ok]
            wts = np.stack([wt, wt], axis=-1)[ok]
        else:
            keys, wts = (w * vocab + c)[ok], wt[ok]
        keys, wts = keys.reshape(-1), wts.reshape(-1)
        if not len(keys):
            return empty
        uniq, inv = np.unique(keys, return_inverse=True)
        inv = inv.reshape(-1)
        first = np.full(len(uniq), len(keys), np.int64)
        np.minimum.at(first, inv, np.arange(len(keys), dtype=np.int64))
        sums = np.bincount(inv, weights=wts, minlength=len(uniq))
        order = np.argsort(first)
        return uniq[order] // vocab, uniq[order] % vocab, sums[order]

    def count(self, idx_corpus: Iterable[np.ndarray]) -> Dict[Tuple[int, int], float]:
        rows, cols, xs = self.count_arrays(idx_corpus)
        return dict(zip(zip(rows.tolist(), cols.tolist()), xs.tolist()))


class Glove(WordVectorsBase):
    """GloVe trainer (reference Glove.Builder surface); the tables live on
    ``device`` (default the card)."""

    def __init__(self,
                 layer_size: int = 100,
                 window: int = 15,
                 min_word_frequency: int = 1,
                 xmax: float = 100.0,
                 alpha: float = 0.75,
                 learning_rate: float = 0.05,
                 epochs: int = 25,
                 batch_size: int = 4096,
                 symmetric: bool = True,
                 seed: int = 12345,
                 tokenizer_factory=None,
                 device: DeviceLike = None):
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.xmax = xmax
        self.alpha = alpha
        self.lr = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.symmetric = symmetric
        self.seed = seed
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.syn0: Optional[np.ndarray] = None
        self._norms = None

    def fit(self, sentences: Iterable) -> "Glove":
        corpus = [self.tokenizer.tokenize(s) if isinstance(s, str) else list(s)
                  for s in sentences]
        self.vocab = build_vocab(corpus, self.min_word_frequency)
        if len(self.vocab) == 0:
            raise ValueError("empty vocabulary — lower min_word_frequency?")
        V, D = len(self.vocab), self.layer_size
        dev = self.device
        idx_corpus = [np.asarray([self.vocab.index_of(t) for t in s
                                  if t in self.vocab], np.int32)
                      for s in corpus]

        rows_all, cols_all, xs = CoOccurrences(self.window, self.symmetric
                                               ).count_arrays(idx_corpus)
        if not len(xs):
            raise ValueError("no co-occurrences — corpus too small?")
        logx_all = np.log(xs).astype(np.float32)
        fx_all = np.minimum(1.0, (xs / self.xmax) ** self.alpha).astype(np.float32)
        N = len(rows_all)

        rng = np.random.default_rng(self.seed)
        scale = 0.5 / D
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        W = to_dev(((rng.random((V, D)) - 0.5) * 2 * scale).astype(np.float32))
        Wc = to_dev(((rng.random((V, D)) - 0.5) * 2 * scale).astype(np.float32))
        b = torch.zeros(V, dtype=torch.float32, device=dev)
        bc = torch.zeros(V, dtype=torch.float32, device=dev)
        hW = torch.ones((V, D), dtype=torch.float32, device=dev)  # GloVe: hist init 1
        hWc = torch.ones((V, D), dtype=torch.float32, device=dev)
        hb = torch.ones(V, dtype=torch.float32, device=dev)
        hbc = torch.ones(V, dtype=torch.float32, device=dev)
        # entry N is the padding row the reference appends: (0, 0, 0, 0)
        rows_d = to_dev(np.append(rows_all, 0).astype(np.int64))
        cols_d = to_dev(np.append(cols_all, 0).astype(np.int64))
        logx_d = to_dev(np.append(logx_all, np.float32(0)))
        fx_d = to_dev(np.append(fx_all, np.float32(0)))

        B = min(self.batch_size, max(64, N))
        lr = float(np.float32(self.lr))
        n_batches = -(-N // B)
        self.losses: List[float] = []
        for ep in range(self.epochs):
            perm = np.full(n_batches * B, N, np.int64)
            perm[:N] = rng.permutation(N)
            perm_d = to_dev(perm)
            batch_losses = []
            for s in range(0, n_batches * B, B):
                sel = perm_d[s:s + B]
                batch_losses.append(_glove_step(
                    W, Wc, b, bc, hW, hWc, hb, hbc, rows_d[sel], cols_d[sel],
                    logx_d[sel], fx_d[sel], lr))
            # one read back an epoch; summed in float64 in batch order, as
            # the reference's running ``ep_loss += float(loss)``
            ep_loss = 0.0
            for x in torch.stack(batch_losses).cpu().tolist():
                ep_loss += x
            self.losses.append(ep_loss / max(n_batches, 1))
        # standard GloVe: final embedding = W + context table
        self.syn0 = W.cpu().numpy() + Wc.cpu().numpy()
        self._norms = None
        return self
