"""SequenceVectors — the generic embedding trainer the word2vec family
shares (the port of ``deeplearning4j_tpu/nlp/sequencevectors.py``).

Parity target: reference models/sequencevectors/SequenceVectors.java:49,192
(the abstract trainer over SequenceElements that Word2Vec, ParagraphVectors
and DeepWalk all extend) + elements-learning/sequence-learning algorithm
split (embeddings/learning/impl/elements/*, sequence/*).

The reference's Hogwild thread pool over sentences becomes host-side
window/negative sampling feeding batched scatter-add updates on the card.
The *sequence label* concept (DL4J's `trainSequencesRepresentation` — doc
vectors, node vectors) extends the input table with one row per label:
  rows [0, V)      — element (word) vectors
  rows [V, V+L)    — sequence-label vectors (paragraph/doc ids)
Labels participate as *inputs* only (syn0 side); prediction targets are
always elements, so the output tables/negative sampling never see them.

Training modes map to the reference's learning algorithms:
  - elements + skip-gram  = SkipGram.java
  - elements + cbow       = CBOW.java
  - labels   + dbow       = DBOW.java  (label predicts each window word)
  - labels   + dm         = DM.java    (label joins the averaged context)

The reference's update steps are jitted XLA programs, not kernels; here
they are plain PyTorch (gathers, ``einsum`` and row scatter-adds) that
update the tables in place.  The host side (alias tables, the window and
pair stream, the per-batch LR schedule, ``flush_multi``/``drain``) is the
reference's.  Three rules carry its semantics over:

  - The negatives are jax's: batch ``i`` draws ``split(fold_in(PRNGKey(s),
    i))``, ``randint(0, V)`` and ``uniform`` through ``ops.sampling``'s
    threefry, bitwise ``jax.random`` and computed on the tables' device,
    so a draw is a pure function of (seed, i) however batches are stacked
    or split over ranks.
  - Repeated rows SUM (``.at[idx].add``), in index order
    (``ops.scatter.add_rows``), never ``t[idx] += v`` (which keeps one)
    nor CUDA's atomic ``index_add_`` (whose f32 sums change order from
    run to run).  So a fit is deterministic on either device.
  - ``lax.scan`` over micro-chunks becomes a loop of chunk steps, each
    re-reading the tables the last one updated; a stacked dispatch of n
    batches is the same n chunk steps as n separate dispatches, bit for
    bit.

On the card a dispatch (the negatives and its chunk loop, ~50 small
kernels a chunk) is a CUDA graph, replayed for every later dispatch of
its shape (``_Replays``), as are ``infer_vector``'s steps: the kernels
are the eager ones, so the result is too, and the host launches one
graph where it launched every kernel.
"""

from __future__ import annotations

import logging
from typing import Dict, Hashable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..ops import sampling
from ..ops.scatter import add_rows
from ..utils.device import DeviceLike, resolve_device
from .vocab import Huffman, VocabCache, build_vocab

logger = logging.getLogger("deeplearning4j_tpu_torch")

Tensor = torch.Tensor


def _build_alias_table(p: np.ndarray):
    """Walker alias-method tables for an arbitrary discrete distribution:
    returns (prob [n], alias [n]); sample with  i ~ U{0..n-1}, u ~ U[0,1),
    result = i if u < prob[i] else alias[i].  O(n) build, O(1) draws."""
    n = len(p)
    prob = np.asarray(p, np.float64) * n
    alias = np.zeros(n, np.int64)
    small = list(np.where(prob < 1.0)[0])
    large = list(np.where(prob >= 1.0)[0])
    while small and large:
        s, l = small.pop(), large.pop()
        alias[s] = l
        prob[l] -= 1.0 - prob[s]
        (small if prob[l] < 1.0 else large).append(l)
    # leftovers are 1.0 up to float error
    for i in small + large:
        prob[i] = 1.0
    return prob, alias


def _device_negs(base_key, counters: Tensor, tables, n_neg: int, rows: int) -> Tensor:
    """Negatives drawn on the tables' device through the alias tables:
    one (rows, n_neg) draw per batch counter, keyed by
    ``fold_in(base_key, counter)`` — bitwise the reference's jitted
    ``_device_negs`` (``split``, ``randint(0, V)``, ``uniform``, then
    ``u < prob[i] ? i : alias[i]``).  Returns int64 [len(counters)·rows,
    n_neg]."""
    nprob, nalias = tables
    k1, k2 = sampling.split(sampling.fold_in(base_key, counters))
    idx = sampling.randint(k1, rows * n_neg, 0, nprob.shape[0])
    u = sampling.uniform(k2, rows * n_neg)
    return torch.where(u < nprob[idx], idx, nalias[idx]).reshape(-1, n_neg)


def _valid_mask(n: int, n_valid: int, device) -> Tensor:
    """[n] float mask with the first n_valid entries 1, made on the device."""
    return (torch.arange(n, device=device) < n_valid).to(torch.float32)


def _occurrence_scale(indices: Tensor, vocab_size: int, weights: Tensor) -> Tensor:
    """weights/count(row) per entry: rows hit k times in one batch receive
    the AVERAGE of their k updates, not the sum.  A batch applies updates
    against stale table values, so summing k near-identical updates
    multiplies the effective lr by k and diverges on small vocabs; averaging
    recovers sequential-SGD magnitude (the Hogwild path's implicit behavior).

    `weights` is 1.0 for genuine entries and 0.0 for padding, so pad slots
    (which alias index 0 — the most frequent word) neither receive updates
    nor dilute the occurrence counts of real entries.  The counts are whole
    numbers, exact in any order, so they take ``index_add_`` on any
    device."""
    counts = torch.zeros(vocab_size, dtype=torch.float32,
                         device=indices.device).index_add_(0, indices, weights)
    return weights / torch.clamp(counts[indices], min=1.0)


def _with_first_label(targets: Tensor, dtype) -> Tensor:
    labels = torch.zeros(targets.shape, dtype=dtype, device=targets.device)
    labels[:, 0] = 1.0
    return labels


def _sg_pair_grads(syn0, syn1, centers, contexts, negatives, valid, lr):
    """Shared skip-gram pair gradients (Mikolov 2013):
        for target t with label l:  g = (l − σ(v·u_t)) · lr
    → (dv [B,D], du_flat [B·(1+K),D], flat_t, flat_tw).  Single source of
    truth for the local step (_sg_chunk) and the data-parallel step
    (nlp/distributed.py)."""
    v = syn0[centers]                                            # [B,D]
    targets = torch.cat([contexts[:, None], negatives], dim=1)   # [B,1+K]
    labels = _with_first_label(targets, syn0.dtype)
    u = syn1[targets]                                            # [B,1+K,D]
    score = torch.sigmoid(torch.einsum("bd,bkd->bk", v, u))
    g = (labels - score) * lr * valid[:, None]                   # [B,1+K]
    dv = torch.einsum("bk,bkd->bd", g, u)
    du = g[..., None] * v[:, None, :]                            # [B,1+K,D]
    flat_t = targets.reshape(-1)
    flat_tw = valid[:, None].expand(targets.shape).reshape(-1)
    return dv, du.reshape(-1, du.shape[-1]), flat_t, flat_tw


def _sg_chunk(syn0, syn1, centers, contexts, negatives, valid, lr):
    """Skip-gram negative-sampling sparse update (one micro-chunk).
    centers [B], contexts [B], negatives [B,K], valid [B] (0 = pad row)."""
    dv, du_flat, flat_t, flat_tw = _sg_pair_grads(
        syn0, syn1, centers, contexts, negatives, valid, lr)
    add_rows(syn0, centers,
             dv * _occurrence_scale(centers, syn0.shape[0], valid)[:, None])
    add_rows(syn1, flat_t,
             du_flat * _occurrence_scale(flat_t, syn1.shape[0], flat_tw)[:, None])
    return syn0, syn1


def _lr_vector(lr, chunks: int, like: Tensor) -> Tensor:
    # graftcheck: disable=GC101 (the captured dispatches pass a per-chunk lr vector already on the device, which passes through uncopied)
    return torch.as_tensor(lr, dtype=like.dtype, device=like.device).reshape(-1).expand(chunks)


def _chunked(chunk_fn, syn0, syn1, per_row, lr, chunks):
    """The reference's ``lax.scan`` over ``chunks`` micro-chunks: a loop of
    chunk steps over consecutive row slices, each reading the tables the
    previous one updated; ``lr`` is a scalar or one entry a chunk."""
    if chunks <= 1:
        return chunk_fn(syn0, syn1, *per_row, lr)
    lr_vec = _lr_vector(lr, chunks, syn0)
    n = per_row[0].shape[0] // chunks
    for i in range(chunks):
        s = slice(i * n, (i + 1) * n)
        chunk_fn(syn0, syn1, *(a[s] for a in per_row), lr_vec[i])
    return syn0, syn1


def _sg_neg_step(syn0, syn1, centers, contexts, negatives, valid, lr, chunks=1):
    """Skip-gram step; ``chunks`` > 1 loops micro-chunks that each re-read
    the freshly updated tables.  Two users of the chunked path:
      - DBOW label training: a label's pairs are CONSECUTIVE — one batch
        would average them into a single effective update
        (see _occurrence_scale), so micro-chunks restore sequentiality.
      - dispatch amortization: the host stacks several LR-annotated batches
        into one call (``lr`` may be a [chunks] vector, one entry per
        micro-chunk), with per-batch semantics bit-identical to separate
        calls.
    """
    return _chunked(_sg_chunk, syn0, syn1, (centers, contexts, negatives, valid),
                    lr, chunks)


def _cbow_chunk(syn0, syn1, context_windows, window_mask, targets_pos,
                negatives, lr):
    """One CBOW negative-sampling micro-chunk: input = mean of context
    vectors; the full output-side gradient is added to EVERY context word,
    matching reference CBOW.java:104-209 (neu1e accumulated once, applied
    undivided per word).  Pad rows have an all-zero window_mask and
    contribute nothing."""
    ctx = syn0[context_windows]                                  # [B,W,D]
    m = window_mask[..., None]
    valid = (torch.sum(window_mask, dim=1) > 0).to(syn0.dtype)  # [B]
    denom = torch.clamp(torch.sum(window_mask, dim=1, keepdim=True), min=1.0)
    h = torch.sum(ctx * m, dim=1) / denom                        # [B,D]
    targets = torch.cat([targets_pos[:, None], negatives], dim=1)
    labels = _with_first_label(targets, syn0.dtype)
    u = syn1[targets]
    score = torch.sigmoid(torch.einsum("bd,bkd->bk", h, u))
    g = (labels - score) * lr * valid[:, None]
    dh = torch.einsum("bk,bkd->bd", g, u)                        # full neu1e per context word
    du = g[..., None] * h[:, None, :]
    flat_t = targets.reshape(-1)
    flat_tw = valid[:, None].expand(targets.shape).reshape(-1)
    add_rows(syn1, flat_t, du.reshape(-1, du.shape[-1])
             * _occurrence_scale(flat_t, syn1.shape[0], flat_tw)[:, None])
    dctx = dh[:, None, :].expand(ctx.shape) * m
    flat_c = context_windows.reshape(-1)
    flat_cw = window_mask.reshape(-1)
    add_rows(syn0, flat_c, dctx.reshape(-1, dctx.shape[-1])
             * _occurrence_scale(flat_c, syn0.shape[0], flat_cw)[:, None])
    return syn0, syn1


def _cbow_neg_step(syn0, syn1, context_windows, window_mask, targets_pos,
                   negatives, lr, chunks=1):
    """CBOW step: a loop over `chunks` micro-chunks, each re-reading the
    freshly updated tables.  CBOW emits one row per center word (~2·window
    fewer rows than skip-gram), so whole-batch averaging starves it of
    effective sequential steps on small vocabs; chunked application restores
    the reference's sequential-SGD semantics while keeping batched products."""
    return _chunked(_cbow_chunk, syn0, syn1,
                    (context_windows, window_mask, targets_pos, negatives), lr, chunks)


def _sg_hs_chunk(syn0, syn1hs, centers, points, codes, code_mask, lr):
    """Skip-gram hierarchical softmax (one micro-chunk): walk the Huffman
    path (reference SkipGram iterateSample hierarchic-softmax branch).
    points/codes [B,L] padded, code_mask [B,L] (all-zero row = pad)."""
    v = syn0[centers]                                            # [B,D]
    u = syn1hs[points]                                           # [B,L,D]
    valid = (torch.sum(code_mask, dim=1) > 0).to(syn0.dtype)    # [B]
    score = torch.sigmoid(torch.einsum("bd,bld->bl", v, u))
    # label = 1 - code (word2vec convention)
    g = ((1.0 - codes) - score) * lr * code_mask
    dv = torch.einsum("bl,bld->bd", g, u)
    du = g[..., None] * v[:, None, :]
    flat_p = points.reshape(-1)
    flat_pw = code_mask.reshape(-1)
    add_rows(syn0, centers,
             dv * _occurrence_scale(centers, syn0.shape[0], valid)[:, None])
    add_rows(syn1hs, flat_p, du.reshape(-1, du.shape[-1])
             * _occurrence_scale(flat_p, syn1hs.shape[0], flat_pw)[:, None])
    return syn0, syn1hs


def _sg_hs_step(syn0, syn1hs, centers, points, codes, code_mask, lr, chunks=1):
    """HS step with the same micro-chunk loop as _sg_neg_step — required for
    DBOW labels, whose consecutive pairs would otherwise average into one
    effective update per batch."""
    return _chunked(_sg_hs_chunk, syn0, syn1hs, (centers, points, codes, code_mask),
                    lr, chunks)


class _Replays:
    """Repeated work on the card as CUDA graphs, one for each shape of
    inputs: a fit's dispatches, a model's inferences.  A shape's first
    call runs eagerly, which warms cuBLAS and the caching allocator; its
    second is captured, and it and every later one copy their inputs into
    the captured buffers and replay.  ``fn`` takes every value that changes
    between calls as one of ``inputs``; it may update tensors that outlive
    the calls in place, and a tensor it returns comes back as a copy."""

    def __init__(self):
        self.graphs: Dict[tuple, tuple] = {}
        self.seen = set()

    def __call__(self, kind: str, fn, *inputs: Tensor):
        key = (kind,) + tuple((t.shape, t.dtype) for t in inputs)
        hit = self.graphs.get(key)
        if hit is None:
            if key not in self.seen:
                self.seen.add(key)
                return fn(*inputs)
            graph, static = torch.cuda.CUDAGraph(), tuple(t.clone() for t in inputs)
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = fn(*static)
            hit = self.graphs[key] = (graph, static, out)
        else:
            for buf, t in zip(hit[1], inputs):
                buf.copy_(t)
        hit[0].replay()
        return hit[2].clone() if isinstance(hit[2], Tensor) else hit[2]


class _LazyTable:
    """Descriptor: a device-resident table exported to a MUTABLE host
    np.ndarray on first access (pending/host attribute pair).  One
    implementation for syn0/syn1 (and any future table)."""

    def __init__(self, pending_attr: str, host_attr: str,
                 clears_norms: bool = False):
        self._pending = pending_attr
        self._host = host_attr
        self._clears_norms = clears_norms

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        host = getattr(obj, self._host, None)
        pending = getattr(obj, self._pending, None)
        if host is None and pending is not None:
            # the pending tensor is dropped below, so its host copy (a view
            # of it on the CPU) is the only reference left: mutable, owned
            host = pending.detach().cpu().numpy()
            setattr(obj, self._host, host)
            setattr(obj, self._pending, None)
        return host

    def __set__(self, obj, value) -> None:
        setattr(obj, self._pending, None)
        if value is None:
            host = None
        elif isinstance(value, torch.Tensor):
            # a tensor (on the card, or a CPU one the caller keeps) becomes
            # a host copy of its own, so writes never reach the caller's
            host = np.array(value.detach().cpu().numpy())
        else:
            # read-only views are copied; writable arrays pass through
            host = np.asarray(value)
            if not host.flags.writeable:
                host = np.array(host)
        setattr(obj, self._host, host)
        if self._clears_norms:
            obj._norms = None


class WordVectorsBase:
    """Lookup API shared by every embedding model (reference
    models/embeddings/wordvectors/WordVectors.java interface); host numpy
    over the exported table, as in the reference."""

    vocab: Optional[VocabCache]
    syn0: Optional[np.ndarray]

    def has_word(self, word) -> bool:
        return self.vocab is not None and word in self.vocab

    def word_vector(self, word) -> np.ndarray:
        return self.syn0[self.vocab.index_of(word)]

    def _normed(self) -> np.ndarray:
        # restrict to element rows [0, V): label-trained models carry extra
        # label rows in syn0 that must not leak into word-space searches
        if getattr(self, "_norms", None) is None:
            table = self.syn0[:len(self.vocab)]
            n = np.linalg.norm(table, axis=1, keepdims=True)
            self._norms = table / np.maximum(n, 1e-9)
        return self._norms

    def similarity(self, a, b) -> float:
        na = self._normed()[self.vocab.index_of(a)]
        nb = self._normed()[self.vocab.index_of(b)]
        return float(na @ nb)

    def words_nearest(self, word, top_n: int = 10) -> List:
        normed = self._normed()
        sims = normed @ normed[self.vocab.index_of(word)]
        sims[self.vocab.index_of(word)] = -np.inf
        idx = np.argpartition(-sims, min(top_n, len(sims) - 1))[:top_n]
        idx = idx[np.argsort(-sims[idx])]
        return [self.vocab.word_for(int(i)) for i in idx]

    def words_nearest_vector(self, vec: np.ndarray, top_n: int = 10) -> List:
        normed = self._normed()
        v = np.asarray(vec, np.float32)
        v = v / max(np.linalg.norm(v), 1e-9)
        sims = normed @ v
        idx = np.argpartition(-sims, min(top_n, len(sims) - 1))[:top_n]
        idx = idx[np.argsort(-sims[idx])]
        return [self.vocab.word_for(int(i)) for i in idx]


def _infer_sg_step(vec, syn1, targets, negatives, valid, lr):
    """One inference pass for a single frozen-table vector (reference
    ParagraphVectors.inferVector:391 — same update, tables locked).
    vec [D], targets [B], negatives [B,K], valid [B]."""
    t = torch.cat([targets[:, None], negatives], dim=1)          # [B,1+K]
    labels = _with_first_label(t, vec.dtype)
    u = syn1[t]                                                  # [B,1+K,D]
    score = torch.sigmoid(torch.einsum("d,bkd->bk", vec, u))
    g = (labels - score) * lr * valid[:, None]
    return vec + torch.einsum("bk,bkd->d", g, u) / torch.clamp(torch.sum(valid), min=1.0)


def _infer_dm_step(vec, syn0, syn1, ctx, ctx_mask, targets, negatives, valid, lr):
    """DM inference: h = mean(frozen context vectors ++ vec); only ``vec``
    moves.  ctx [B,W] indices into syn0, ctx_mask [B,W]."""
    c = syn0[ctx] * ctx_mask[..., None]                          # [B,W,D]
    denom = torch.sum(ctx_mask, dim=1, keepdim=True) + 1.0       # + the doc vector
    h = (torch.sum(c, dim=1) + vec[None, :]) / denom             # [B,D]
    t = torch.cat([targets[:, None], negatives], dim=1)
    labels = _with_first_label(t, vec.dtype)
    u = syn1[t]
    score = torch.sigmoid(torch.einsum("bd,bkd->bk", h, u))
    g = (labels - score) * lr * valid[:, None]
    dh = torch.einsum("bk,bkd->bd", g, u) / denom                # ∂h/∂vec = 1/denom
    return vec + torch.sum(dh, dim=0) / torch.clamp(torch.sum(valid), min=1.0)


class SequenceVectors(WordVectorsBase):
    """Generic embedding trainer over element sequences (reference
    SequenceVectors.Builder surface: layerSize, windowSize, negative,
    useHierarchicSoftmax, learningRate, epochs, trainElementsRepresentation,
    trainSequencesRepresentation).  The tables live on ``device`` (default
    the card; ``device="cpu"`` to train on the CPU)."""

    def __init__(self,
                 layer_size: int = 100,
                 window: int = 5,
                 min_word_frequency: int = 1,
                 negative: int = 5,
                 hierarchic_softmax: bool = False,
                 cbow: bool = False,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 subsampling: float = 0.0,
                 epochs: int = 1,
                 batch_size: int = 2048,
                 seed: int = 12345,
                 train_elements: bool = True,
                 train_sequences: bool = False,
                 dm: bool = True,
                 device: DeviceLike = None):
        self.layer_size = layer_size
        if window < 1:
            # validated up front: the numpy path would raise from
            # rng.integers(1, 1) and the C++ generator would SIGFPE on a
            # modulo-by-zero — neither is an acceptable failure mode
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.negative = negative
        self.hs = hierarchic_softmax
        self.cbow = cbow
        self.lr = learning_rate
        self.min_lr = min_learning_rate
        self.subsampling = subsampling
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        if cbow and hierarchic_softmax:
            raise NotImplementedError(
                "CBOW + hierarchical softmax is not implemented — use CBOW "
                "with negative sampling, or skip-gram with HS")
        if train_sequences and dm and hierarchic_softmax:
            raise NotImplementedError(
                "DM + hierarchical softmax is not implemented — use DM with "
                "negative sampling, or DBOW with HS")
        self.train_elements = train_elements
        self.train_sequences = train_sequences
        self.dm = dm
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self._syn0_pending: Optional[Tensor] = None   # device tables awaiting lazy readback
        self._syn0_host: Optional[np.ndarray] = None
        self._syn1_pending: Optional[Tensor] = None
        self._syn1_host: Optional[np.ndarray] = None
        self.label_index: Dict[Hashable, int] = {}
        self._norms = None
        # batches stacked per dispatch (per-batch LR/semantics preserved via
        # the per-chunk lr vector in _sg_neg_step).  Subclasses whose step
        # can't loop multiple batches (DistributedWord2Vec) set this to 1.
        self._device_batches = 16
        # dispatches and inferences on the card replay CUDA graphs
        # (_Replays); a step that leaves the card (DistributedWord2Vec's
        # gathers) sets this False
        self._graphs = True
        self._infer_replays = _Replays()

    # ------------------------------------------------------------------

    # Tables stay device-resident after fit and materialize as genuine
    # MUTABLE host arrays on first access.
    syn0 = _LazyTable("_syn0_pending", "_syn0_host", clears_norms=True)
    syn1 = _LazyTable("_syn1_pending", "_syn1_host")

    def _sg_step(self, syn0, syn1, centers, contexts, negatives, valid, lr,
                 chunks=1):
        """Skip-gram update seam — DistributedWord2Vec overrides this with
        the data-parallel step (nlp/distributed.py)."""
        return _sg_neg_step(syn0, syn1, centers, contexts, negatives, valid,
                            lr, chunks)

    def fit_sequences(self,
                      sequences: Sequence[Sequence[Hashable]],
                      labels: Optional[Sequence[Hashable]] = None) -> "SequenceVectors":
        """Train on pre-tokenized element sequences.  ``labels``, when given,
        attaches one trainable label row per sequence (DM/DBOW per ``dm``)."""
        if labels is not None and len(labels) != len(sequences):
            raise ValueError(f"{len(labels)} labels for {len(sequences)} sequences")
        if labels is None and self.train_sequences:
            raise ValueError("train_sequences=True requires labels")
        if labels is not None and not self.train_sequences:
            raise ValueError("labels were given but train_sequences=False — "
                             "label vectors would never be trained")

        dev = self.device
        self.vocab = build_vocab(sequences, self.min_word_frequency)
        if len(self.vocab) == 0:
            raise ValueError("empty vocabulary — lower min_word_frequency?")
        V, D = len(self.vocab), self.layer_size
        self.label_index = {}
        if labels is not None:
            for lb in labels:
                if lb not in self.label_index:
                    self.label_index[lb] = V + len(self.label_index)
        L = len(self.label_index)

        rng = np.random.default_rng(self.seed)
        # word2vec init: inputs ~ U(-0.5/D, 0.5/D), output tables zero
        syn0 = torch.from_numpy(
            ((rng.random((V + L, D)) - 0.5) / D).astype(np.float32)).to(dev)
        syn1 = torch.zeros((V + L, D), dtype=torch.float32, device=dev)

        idx_corpus: List[np.ndarray] = []
        seq_label_idx: List[Optional[int]] = []
        index_get = self.vocab.get  # one hash probe per token
        for si, s in enumerate(sequences):
            ids = np.asarray([vw.index for vw in map(index_get, s)
                              if vw is not None], np.int32)
            if len(ids) < 1:
                continue
            idx_corpus.append(ids)
            seq_label_idx.append(self.label_index[labels[si]] if labels is not None
                                 else None)
        if labels is not None:
            trained = {l for l in seq_label_idx if l is not None}
            untrained = [lb for lb, li in self.label_index.items()
                         if li not in trained]
            if untrained:
                logger.warning(
                    "%d label(s) have no in-vocabulary tokens and keep their "
                    "random init (e.g. %s) — their vectors are meaningless",
                    len(untrained), untrained[:3])

        unigram = self.vocab.unigram_table()
        counts = np.asarray([w.count for w in self.vocab.words], np.float64)
        total = counts.sum()
        keep_prob = np.ones(V)
        if self.subsampling > 0:
            f = counts / total
            keep_prob = np.minimum(1.0, np.sqrt(self.subsampling / f)
                                   + self.subsampling / f)

        huffman = None
        max_code = 0
        if self.hs:
            huffman = Huffman(self.vocab)
            max_code = max(huffman.max_code_length(), 1)

        total_words = sum(len(s) for s in idx_corpus) * self.epochs
        words_done = 0

        def lr_at(done) -> float:
            """Linear LR decay at a words-done watermark (word2vec.c)."""
            frac = float(done) / max(total_words, 1)
            return max(self.min_lr, self.lr * (1.0 - frac))

        def current_lr():
            return lr_at(words_done)

        def chunk_divisor(target_chunk: int) -> int:
            """Largest divisor of batch_size giving chunks of ≥ target size."""
            chunks = max(1, self.batch_size // target_chunk)
            while self.batch_size % chunks:
                chunks -= 1
            return chunks

        # DBOW emits a label's pairs CONSECUTIVELY — loop micro-chunks so
        # they apply (near-)sequentially instead of being averaged away by
        # _occurrence_scale (see _sg_neg_step docstring)
        dbow = self.train_sequences and not self.dm

        # Vectorized window generation: every center's candidate contexts
        # live at fixed offsets [-W..-1, 1..W]; masking |off| ≤ b (the
        # per-center dynamic window draw) and the sentence bounds yields
        # the exact sequential pair stream — position-major, offsets in
        # increasing j — in one numpy pass per block.
        offs = np.concatenate([np.arange(-self.window, 0),
                               np.arange(1, self.window + 1)])

        if self.hs:
            # vocab-indexed Huffman tables so flush() can gather per-target
            # paths instead of looping: row i = word i's (points, codes, len)
            hs_pts = np.zeros((V, max_code), np.int32)
            hs_cds = np.zeros((V, max_code), np.float32)
            hs_msk = np.zeros((V, max_code), np.float32)
            for i, w in enumerate(self.vocab.words):
                l = min(len(w.points), max_code)
                hs_pts[i, :l] = w.points[:l]
                hs_cds[i, :l] = w.codes[:l]
                hs_msk[i, :l] = 1.0

        # negative sampling: Walker alias table over unigram^0.75; the
        # tables and the draws live on the device (_device_negs), keyed by
        # global batch index so results are invariant to _device_batches and
        # to the number of ranks (DistributedWord2Vec's parity relies on it)
        a_prob, a_alias = _build_alias_table(unigram)
        neg_tables = (torch.from_numpy(a_prob.astype(np.float32)).to(dev),
                      torch.from_numpy(a_alias).to(dev))
        neg_key = tuple(w.to(dev) for w in sampling.prng_key(torch.tensor(int(
            np.random.SeedSequence([self.seed, 977]).generate_state(1)[0]))))
        batch_counter = 0  # global batch index across the whole fit

        def upload(a: np.ndarray) -> Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            return t.long() if t.dtype == torch.int32 else t

        replay = _Replays() if (self._graphs and syn0.is_cuda) else None

        def dispatch(kind: str, fn, *inputs: Tensor) -> None:
            if replay is None:
                fn(*inputs)
            else:
                replay(kind, fn, *inputs)

        def negs_of(counters: Tensor) -> Tensor:
            return _device_negs(neg_key, counters, neg_tables, self.negative,
                                self.batch_size)

        def flush_multi(centers, targets, n_valid, lrs,
                        ctx=None, cmask=None) -> None:
            """One dispatch covering ``len(lrs)`` stacked batches (arrays
            are [n_b·batch_size] row-major; the first ``n_valid`` rows are
            genuine, the rest masked padding).  Per-batch LR rides the
            per-chunk lr vector, so semantics match n_b separate flushes
            exactly.  The steps update ``syn0``/``syn1`` in place."""
            nonlocal batch_counter
            n_b = len(lrs)
            inner = chunk_divisor(32) if (ctx is not None and not self.hs) \
                else (chunk_divisor(16) if dbow else 1)
            chunks = n_b * inner
            lr_vec = upload(np.repeat(np.asarray(lrs, np.float32), inner))
            if self.hs:
                valid = np.zeros(len(centers), np.float32)
                valid[:n_valid] = 1.0
                msk = hs_msk[targets] * valid[:, None]
                dispatch("hs", lambda c, p, cd, m, lr: _sg_hs_step(
                    syn0, syn1, c, p, cd, m, lr, chunks),
                    upload(centers), upload(hs_pts[targets]), upload(hs_cds[targets]),
                    upload(msk), lr_vec)
                return
            counters = torch.arange(batch_counter, batch_counter + n_b, device=dev)
            batch_counter += n_b
            if ctx is not None:
                dispatch("cbow", lambda n, x, m, t, lr: _cbow_neg_step(
                    syn0, syn1, x, m, t, negs_of(n), lr, chunks),
                    counters, upload(ctx), upload(cmask), upload(targets), lr_vec)
            else:
                # one stacked upload of centers and targets
                dispatch("sg", lambda n, ct, v, lr: self._sg_step(
                    syn0, syn1, ct[0], ct[1], negs_of(n), v, lr, chunks),
                    counters, upload(np.stack([centers, targets])),
                    _valid_mask(len(centers), n_valid, dev), lr_vec)

        # pending pair chunks, drained ``k_super`` exact batches per device
        # call; batch boundaries and per-batch LR match the sequential
        # stream (pend_lr snapshots current_lr at each boundary crossing)
        pend_c: List[np.ndarray] = []
        pend_t: List[np.ndarray] = []
        pend_x: List[np.ndarray] = []
        pend_m: List[np.ndarray] = []
        pend_lr: List[float] = []
        pend_n = 0
        k_super = max(1, int(self._device_batches))

        def drain(final: bool = False) -> None:
            nonlocal pend_c, pend_t, pend_x, pend_m, pend_lr, pend_n
            bs = self.batch_size
            if pend_n == 0 or (pend_n < bs * k_super and not final):
                return
            c = np.concatenate(pend_c)
            t = np.concatenate(pend_t)
            x = np.concatenate(pend_x) if pend_x else None
            m = np.concatenate(pend_m) if pend_m else None
            lrs = list(pend_lr)
            orig_len = len(c)  # genuine pairs, before tail padding
            tail = orig_len - (orig_len // bs) * bs
            if final and tail:
                # pad the tail to a full masked batch and take it too
                pad = bs - tail
                c = np.concatenate([c, np.zeros(pad, np.int32)])
                t = np.concatenate([t, np.zeros(pad, np.int32)])
                if x is not None:
                    x = np.concatenate([x, np.zeros((pad, x.shape[1]), np.int32)])
                    m = np.concatenate([m, np.zeros((pad, m.shape[1]), np.float32)])
                lrs.append(current_lr())
            n_batches = len(c) // bs if final else (len(c) // bs) // k_super * k_super
            for g in range(0, n_batches, k_super):
                gb = min(k_super, n_batches - g)
                s = slice(g * bs, (g + gb) * bs)
                n_valid = max(0, min(orig_len - g * bs, gb * bs))
                flush_multi(c[s], t[s], n_valid, lrs[g:g + gb],
                            None if x is None else x[s],
                            None if m is None else m[s])
            rem = slice(n_batches * bs, len(c) if not final else n_batches * bs)
            kept = c[rem]
            pend_c = [kept] if len(kept) else []
            pend_t = [t[rem]] if len(kept) else []
            pend_x = [x[rem]] if (x is not None and len(kept)) else []
            pend_m = [m[rem]] if (m is not None and len(kept)) else []
            pend_lr = lrs[n_batches:]
            pend_n = len(kept)

        def push(c, t, x=None, m=None, wdone=None) -> None:
            """Queue a pair chunk.  ``wdone`` (per-pair words-done counts)
            drives per-batch LR at word granularity; without it the batch
            takes the LR of the current words_done watermark."""
            nonlocal pend_n
            if len(c) == 0:
                return
            start = pend_n
            pend_c.append(np.ascontiguousarray(c, np.int32))
            pend_t.append(np.ascontiguousarray(t, np.int32))
            if x is not None:
                pend_x.append(np.ascontiguousarray(x, np.int32))
                pend_m.append(np.ascontiguousarray(m, np.float32))
            pend_n += len(c)
            while len(pend_lr) < pend_n // self.batch_size:
                bidx = (len(pend_lr) + 1) * self.batch_size - 1 - start
                pend_lr.append(lr_at(wdone[bidx]) if wdone is not None
                               else current_lr())
            drain()

        use_cbow_path = self.cbow or (labels is not None and self.dm
                                      and self.train_sequences)

        # Flatten the corpus once; window masks use sentence-id equality,
        # so one pass handles every sentence of a block at once; blocks are
        # cut at sentence boundaries to bound peak memory.
        flat_lens = np.asarray([len(s) for s in idx_corpus], np.int64)
        flat_tokens = (np.concatenate(idx_corpus) if idx_corpus
                       else np.zeros(0, np.int32))
        flat_sids = np.repeat(np.arange(len(idx_corpus)), flat_lens)
        has_labels = labels is not None
        flat_labs = (np.repeat(np.asarray(
            [(-1 if l is None else l) for l in seq_label_idx], np.int32),
            flat_lens) if has_labels else None)
        BLOCK = 1 << 18  # ~256K tokens → ≤ ~1.5M pairs in flight

        for epoch_i in range(self.epochs):
            if self.subsampling > 0:
                # dedicated per-epoch stream (NOT the shared `rng`), so the
                # native and numpy window paths subsample alike
                sub_rng = np.random.default_rng(np.random.SeedSequence(
                    [self.seed, 77003, epoch_i]))
                keepm = sub_rng.random(len(flat_tokens)) < keep_prob[flat_tokens]
                toks = flat_tokens[keepm]
                sids = flat_sids[keepm]
                labs = flat_labs[keepm] if has_labels else None
            else:
                toks, sids, labs = flat_tokens, flat_sids, flat_labs
            N = len(toks)
            startpos = 0
            while startpos < N:
                cap = min(startpos + BLOCK, N)
                if cap < N:
                    # cut before the sentence containing position cap
                    cut = int(np.searchsorted(sids, sids[cap - 1], side="left"))
                    if cut <= startpos:  # single sentence > BLOCK: take it whole
                        cut = int(np.searchsorted(sids, sids[cap - 1], side="right"))
                else:
                    cut = N
                bt = toks[startpos:cut]
                bsid = sids[startpos:cut]
                blab = None if labs is None else labs[startpos:cut]
                Lb = len(bt)
                if (not use_cbow_path and not has_labels
                        and self.train_elements):
                    # plain skip-gram: the C++ pair generator replaces the
                    # whole [Lb,2W] numpy mask pipeline
                    from ._native_windows import sg_windows
                    # epoch in the seed: every pass re-draws its dynamic
                    # windows (the numpy path's persistent-rng behavior)
                    native = sg_windows(
                        bt, bsid, self.window,
                        np.random.SeedSequence(
                            [self.seed, 31337, epoch_i,
                             startpos]).generate_state(1)[0])
                    if native is not None:
                        ncen, ntgt, npos = native
                        push(ncen, ntgt,
                             wdone=words_done + startpos + 1 + npos)
                        startpos = cut
                        continue
                b = rng.integers(1, self.window + 1, size=Lb)  # dynamic window
                j = np.arange(Lb)[:, None] + offs[None, :]     # [Lb, 2W]
                jc = np.clip(j, 0, Lb - 1)
                inwin = ((j >= 0) & (j < Lb)
                         & (np.abs(offs)[None, :] <= b[:, None])
                         & (bsid[jc] == bsid[:, None]))
                ctx_ids = bt[jc]                               # [Lb, 2W]
                # words-done after each center (for word-granular LR decay)
                wd = words_done + startpos + 1 + np.arange(Lb, dtype=np.int64)
                if use_cbow_path:
                    if has_labels and self.dm:
                        # DM: the label joins every averaged window
                        ctx_full = np.concatenate([ctx_ids, blab[:, None]], 1)
                        mask_full = np.concatenate(
                            [inwin, (blab >= 0)[:, None]], 1)
                    else:
                        ctx_full, mask_full = ctx_ids, inwin
                    rows = mask_full.any(axis=1)  # skip empty-context centers
                    push(bt[rows], bt[rows], ctx_full[rows],
                         mask_full[rows].astype(np.float32), wd[rows])
                else:
                    cen = np.broadcast_to(bt[:, None], inwin.shape)
                    tgt = ctx_ids
                    vmat = inwin if self.train_elements else np.zeros_like(inwin)
                    if has_labels and not self.dm:
                        # DBOW: after each center's window pairs, the label
                        # predicts the center (DBOW.java pair order)
                        cen = np.concatenate([cen, blab[:, None]], axis=1)
                        tgt = np.concatenate([tgt, bt[:, None]], axis=1)
                        vmat = np.concatenate(
                            [vmat, (blab >= 0)[:, None]], axis=1)
                    keep_m = vmat.ravel()
                    wexp = np.broadcast_to(wd[:, None], vmat.shape).ravel()[keep_m]
                    push(cen.ravel()[keep_m], tgt.ravel()[keep_m], wdone=wexp)
                startpos = cut
            words_done += N
        drain(final=True)
        # both tables defer their device→host readback to first access
        # (the syn0/syn1 properties); training is complete device-side
        self._syn0_pending = syn0
        self._syn0_host = None
        self._syn1_pending = syn1
        self._syn1_host = None
        self._norms = None
        return self

    # ------------------------------------------------------------------
    # label (sequence) vectors
    # ------------------------------------------------------------------

    def sequence_vector(self, label: Hashable) -> np.ndarray:
        """Trained vector of a sequence label (doc vector)."""
        return self.syn0[self.label_index[label]]

    def infer_vector(self, tokens: Sequence[Hashable], steps: int = 200,
                     learning_rate: Optional[float] = None,
                     seed: int = 0) -> np.ndarray:
        """Train a fresh vector for an unseen sequence with all tables
        frozen (reference ParagraphVectors.inferVector:391); the draws are
        the reference's (numpy from ``seed``), the steps run on the
        model's device (on the card as a CUDA graph, replayed by later
        inferences of the same shape)."""
        if self.syn0 is None:
            raise ValueError("fit before infer")
        if self.hs:
            raise NotImplementedError(
                "infer_vector for hierarchical-softmax models is not "
                "implemented (syn1 holds Huffman inner-node vectors, not word "
                "outputs) — train with negative sampling to use inference")
        ids = np.asarray([self.vocab.index_of(t) for t in tokens
                          if t in self.vocab], np.int32)
        if len(ids) == 0:
            raise ValueError("no known tokens in sequence")
        dev = self.device
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        rng = np.random.default_rng(seed)
        D = self.layer_size
        lr = np.float32(learning_rate if learning_rate is not None else self.lr)
        vec = to_dev(((rng.random(D) - 0.5) / D).astype(np.float32))
        syn0 = to_dev(self.syn0)
        syn1 = to_dev(self.syn1)
        unigram = self.vocab.unigram_table()
        # pad to a power-of-two bucket, as the reference does
        B = 1 << max(4, int(np.ceil(np.log2(len(ids)))))
        pad = B - len(ids)
        targets = to_dev(np.concatenate([ids, np.zeros(pad, np.int32)]).astype(np.int64))
        valid = to_dev(np.concatenate([np.ones(len(ids), np.float32),
                                       np.zeros(pad, np.float32)]))
        if self.dm:
            W = 2 * self.window
            ctx = np.zeros((B, W), np.int64)
            msk = np.zeros((B, W), np.float32)
            for pos in range(len(ids)):
                lo, hi = max(0, pos - self.window), min(len(ids), pos + self.window + 1)
                c = [int(ids[j]) for j in range(lo, hi) if j != pos]
                l = min(len(c), W)
                ctx[pos, :l] = c[:l]
                msk[pos, :l] = 1.0
            ctx_t, msk_t = to_dev(ctx), to_dev(msk)
        # every step's negatives in one draw and one copy: the same stream
        # as the reference's draw of (B, negative) a step
        negs_all = to_dev(rng.choice(len(unigram), size=(steps, B, self.negative),
                                     p=unigram).astype(np.int64))
        lrs = to_dev(np.asarray([max(float(lr) * (1.0 - it / steps), self.min_lr)
                                 for it in range(steps)], np.float32))
        if self.dm:
            def run(v, negs_all, lrs, syn0, syn1, targets, valid, ctx_t, msk_t):
                for it in range(steps):
                    v = _infer_dm_step(v, syn0, syn1, ctx_t, msk_t, targets,
                                       negs_all[it], valid, lrs[it])
                return v
            args = (vec, negs_all, lrs, syn0, syn1, targets, valid, ctx_t, msk_t)
        else:
            def run(v, negs_all, lrs, syn1, targets, valid):
                for it in range(steps):
                    v = _infer_sg_step(v, syn1, targets, negs_all[it], valid, lrs[it])
                return v
            args = (vec, negs_all, lrs, syn1, targets, valid)
        if vec.is_cuda and self._graphs:
            vec = self._infer_replays("dm" if self.dm else "sg", run, *args)
        else:
            vec = run(*args)
        return vec.cpu().numpy()


class ParagraphVectors(SequenceVectors):
    """Doc2vec (reference models/paragraphvectors/ParagraphVectors.java):
    PV-DM (``dm=True``, default — DL4J's default DM learner) or PV-DBOW
    (``dm=False``).  Labels are document ids; ``infer_vector`` embeds unseen
    documents against the frozen tables."""

    def __init__(self, dm: bool = True, train_elements: bool = True,
                 **kwargs):
        # word vectors co-train by default (reference trainElementsVectors
        # defaults true); pure doc→word DBOW collapses doc vectors to a
        # near-rank-1 subspace because syn1 gets no word-word structure
        kwargs.setdefault("min_word_frequency", 1)
        super().__init__(train_elements=train_elements, train_sequences=True,
                         dm=dm, **kwargs)
        self.tokenizer = None

    def fit(self, documents: Iterable, labels: Optional[Sequence[Hashable]] = None
            ) -> "ParagraphVectors":
        """Train on documents: strings (tokenized on whitespace via the
        default tokenizer) or pre-tokenized lists."""
        from .tokenization import DefaultTokenizerFactory
        docs = list(documents)
        if docs and isinstance(docs[0], str):
            tk = DefaultTokenizerFactory()
            seqs = [tk.tokenize(d) for d in docs]
        else:
            seqs = [list(d) for d in docs]
        if labels is None:
            labels = [f"DOC_{i}" for i in range(len(seqs))]
        return self.fit_sequences(seqs, labels=labels)

    # doc-flavored aliases (reference API names)
    def doc_vector(self, label: Hashable) -> np.ndarray:
        return self.sequence_vector(label)

    def infer(self, text) -> np.ndarray:
        if isinstance(text, str):
            from .tokenization import DefaultTokenizerFactory
            text = DefaultTokenizerFactory().tokenize(text)
        return self.infer_vector(text)

    def nearest_labels(self, vec_or_text, top_n: int = 5) -> List:
        """Labels whose doc vectors are closest to a vector / inferred text
        (reference predictSeveral / nearestLabels)."""
        if isinstance(vec_or_text, (str, list)):
            v = self.infer(vec_or_text)
        else:
            v = np.asarray(vec_or_text, np.float32)
        v = v / max(np.linalg.norm(v), 1e-9)
        out = []
        for lb, idx in self.label_index.items():
            dv = self.syn0[idx]
            dv = dv / max(np.linalg.norm(dv), 1e-9)
            out.append((float(dv @ v), lb))
        out.sort(reverse=True)
        return [lb for _, lb in out[:top_n]]
