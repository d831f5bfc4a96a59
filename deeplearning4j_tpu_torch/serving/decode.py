"""Autoregressive decode engine: paged KV-cache + continuous batching
(mirrors ``deeplearning4j_tpu/serving/decode.py``).

  prefill/decode split
      A request's prompt runs once through the bucketed prefill, which
      writes K/V for every prompt position into the request's pages and
      yields the logits of its first token (TTFT is one prefill).  Every
      later token costs one decode step over all ``max_slots`` slots
      with an active mask; masked slots write the scratch page.

  iteration-level continuous batching
      New requests join the running batch at the next step boundary
      (``ContinuousBatcher.admit``), not when the batch drains.

  per-request stop conditions
      EOS / max-tokens / deadline are checked after every sampled
      token; a stopped request resolves at once and its pages go back
      to the free list in the same step.

  resilience
      A crash in the loop resets the pool and the slots and requeues
      every request in flight at the front while it has retries
      (``max_retries``) and time left; sampling is seeded and
      counter-based, so a retry regenerates the same tokens.  Past that
      the request fails with ``ReplicaCrashError``.  A supervisor thread
      respawns the loop if it dies outright.  Non-finite logits fail
      only their own request (its private pages are scrubbed).

  hot-swap without version mixing
      ``swap_model`` flips the tag new admissions decode under; a slot
      keeps the version that prefilled it (the step runs once per
      distinct live tag, each with its own parameters), so no request
      mixes versions and a swap never drains the batch.  A version no
      slot, default or named model holds any more is dropped.  Named
      models (``add_model``) share the program and the pool: placing one
      costs its parameters, nothing is prepared anew.

  prefill/decode roles (``role=``)
      A ``"prefill"`` host prefills, samples the first token (it pays
      TTFT), exports the prompt's pages as a ``PrefillHandoff``
      (``ops.kv_cache.pack_transfer``) and frees them; a ``"decode"``
      host takes ``continue_async(handoff)``, writes the pages into its
      own pool (page ids remapped, prefix-cached pages deduped onto the
      scratch page) and continues the exact sequence a ``"unified"``
      engine would have produced, bitwise.

Sampling is greedy / temperature / top-k / top-p, seeded and
counter-based (``ops.sampling``): the draw for token n of a request is
keyed ``fold_in(PRNGKey(seed), n)``, bit-exact with the reference's.

Decode features, each off by default:

  fused multi-step decode (``decode_horizon=H``)
      H decode steps with on-device sampling in one dispatch
      (``DecodeProgram.step_multi``); on the card it is one replay of a
      CUDA graph captured at ``load()`` (``serving.cuda_graphs``), on
      the CPU the eager ``step_multi``.  The graph reads its own copy of
      the parameters; before it replays for another version's slots
      that version's values are copied in.  Host slot state changes
      only after the dispatch returns; the H (token, finite) pairs
      replay through the per-token bookkeeping and the overrun after a
      stop is dropped, so tokens and logits are bitwise H plain steps'.
  chunked prefill (``prefill_chunk=N``)
      A prompt prefills in chunks of at most N tokens through
      ``prefill_at``, one chunk a loop turn, round-robin over the slots
      that are prefilling; the batcher admits one chunk budget of prompt
      tokens a round.  The last chunk's logits are bitwise an unchunked
      prefill's.
  radix prefix cache (``prefix_cache=True``)
      A host trie of page-sized token chunks maps full prompt pages to
      refcounted pool pages; a request attaches its longest page-aligned
      match read-only and prefills only the suffix (``prefill_at``).
      Finishing decrefs; refcount-zero leaves are evicted LRU under pool
      pressure; a scrub never touches a page the trie holds.
  speculative decoding (``draft_model=..., speculate_k=k``)
      A draft program with its own pool (same page table) proposes k
      tokens; the target scores k+1 rows in one ``spec_step`` and exact
      rejection sampling commits 1..k+1.  At temperature 0 the tokens
      are the plain engine's.
  int8 KV pages (``kv_dtype="int8"``)
      ``ops.kv_cache.QuantPages``: about 4x less pool memory; tokens
      agree with f32 within an envelope, not bitwise.
  tensor-parallel decode (a program with ``tp > 1``, e.g.
      ``parallel.ShardedTransformerLM`` over a ``data`` mesh)
      The pool is split into head shards (``ops.kv_cache.ShardedPages``)
      on the program's ``shard_devices``; int8 pages are refused; the
      snapshot reports ``tp``.  A transfer always carries all heads, so
      a one-way prefill host feeds a sharded decode host.

``load()`` captures the fused horizon's CUDA graph on a card (a
decoding role with ``decode_horizon > 1``); every other entry point runs
eagerly and has nothing to prepare.  ``compile_cache_size()`` counts the
captured graphs (1 or 0), as the predict engine's counts its own, and
does not grow while serving, across swaps and named models.  A warm
bundle (``save_warmup_bundle`` / ``load(warm_bundle=)``) names them: the
graph is captured either way, and counts ``bundle_hits`` when the bundle
names it, ``bundle_misses`` otherwise.
``enable_autoscale(on_scale)`` drives a callback (decode capacity is
fixed by ``max_slots``; the fleet scales hosts).  Spans and instants are
the reference's (``serve/warmup``, ``serve/prefill``,
``serve/decode_step``, ``serve/swap``, ...).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..obs import trace as obs_trace
from ..ops.kv_cache import (PageTransfer, QuantPages, alloc_cache, gather_pages,
                            pack_transfer, pages_for, pool_layout, reset_pool,
                            scrub_pool, set_pages, unpack_transfer)
from ..ops.sampling import (filtered_logits, fold_in, gumbel_from_key, prng_key,
                            sample_tokens, uniform)
from ..utils.device import DeviceLike, resolve_device
from .batcher import ContinuousBatcher, pow2_buckets
from .engine import (ModelNotLoadedError, PoisonInputError, ReplicaCrashError,
                     _fail_safe, _set_safe)
from .metrics import DecodeMetrics

@dataclass
class GenerationResult:
    """One finished generation.  ``tokens`` are the generated ids only
    (a terminating EOS included); ``logits`` is [n_tokens, vocab]
    float32 when the request asked ``echo_logits``, else None."""

    tokens: List[int]
    n_prompt: int
    finish_reason: str
    model_tag: str
    ttft_ms: float
    tpot_ms: Optional[float]
    logits: Optional[np.ndarray] = None


@dataclass(frozen=True)
class _GenSpec:
    prompt: np.ndarray
    max_new: int
    temperature: float
    top_k: int
    top_p: float
    seed: int
    echo_logits: bool


@dataclass
class PrefillHandoff:
    """What a ``role="prefill"`` host hands a ``role="decode"`` host: the
    request's spec, the first sampled token (TTFT is paid on the prefill
    side), and the prompt's KV pages packed by
    ``ops.kv_cache.pack_transfer`` (f32 bytes, or the int8 values and
    their scales, as stored), so the decode host continues the exact
    sequence a unified engine would have produced.  ``logits0`` is the
    prefill's logits row when the request asked ``echo_logits``."""

    prompt: np.ndarray
    max_new: int
    temperature: float
    top_k: int
    top_p: float
    seed: int
    echo_logits: bool
    first_token: int
    finite: bool
    n_pages: int
    pages: bytes
    logits0: Optional[np.ndarray]
    model_tag: str


@dataclass(frozen=True)
class _HandoffSpec(_GenSpec):
    """``_GenSpec`` plus the inbound handoff: what a decode-role host's
    batcher queues for ``continue_async``."""

    handoff: Any = None


class _Slot:
    """Host-side state of one occupied decode slot.  ``tag`` is the
    version it decodes under; ``page_ids`` are the slot's private pages
    (freed at finish); ``shared_nodes`` the prefix-trie nodes it holds a
    reference on: the first ``n_matched`` attached at admission, the rest
    pages its own prefill inserted."""

    __slots__ = ("req", "spec", "tag", "page_ids", "n_prompt", "pos",
                 "last_token", "tokens", "n_out", "max_new", "deadline",
                 "t_first", "t_last", "logits", "shared_nodes", "n_matched",
                 "n_prefilled")

    def __init__(self, req, tag: str, page_ids: List[int], max_new: int):
        self.req = req
        self.spec = req.payload
        self.tag = tag
        self.page_ids = page_ids
        self.n_prompt = int(self.spec.prompt.shape[0])
        self.pos = self.n_prompt      # where the NEXT input token lands
        self.last_token = 0
        self.tokens: List[int] = []
        self.n_out = 0
        self.max_new = max_new
        self.deadline = req.deadline
        self.t_first = 0.0
        self.t_last = 0.0
        self.logits: Optional[List[np.ndarray]] = [] if self.spec.echo_logits else None
        self.shared_nodes: List["_PrefixNode"] = []
        self.n_matched = 0
        # chunked prefill: prompt tokens already in the cache; a slot with
        # n_prefilled set is not stepped yet (None once prefill is done)
        self.n_prefilled: Optional[int] = None


class _PrefixNode:
    """One full, immutable KV page in the radix prefix trie: ``key`` is
    its page_size tokens, ``refs`` the slots holding it (a holder holds
    every ancestor, so refs never grow from root to leaf), ``last_used``
    drives LRU eviction, ``detached`` marks a node already evicted."""

    __slots__ = ("key", "page_id", "refs", "children", "parent",
                 "last_used", "detached")

    def __init__(self, key: tuple, page_id: Optional[int], parent):
        self.key = key
        self.page_id = page_id
        self.refs = 0
        self.children: Dict[tuple, "_PrefixNode"] = {}
        self.parent = parent
        self.last_used = 0.0
        self.detached = False


# speculative decoding draws from its own RNG streams, so the draft
# proposal, the accept test and the residual resample never share a key
_DRAFT_STREAM, _ACCEPT_STREAM, _RESID_STREAM = 1, 2, 3


def _make_spec_fns(vocab_size: int, n_spec: int):
    """(propose, accept) for speculative decoding with ``n_spec`` draft
    tokens a round, over every slot at once (the reference's vmapped
    ``_make_spec_fns``).

    ``propose(lgs [S, V], temps, top_ks, top_ps, seeds, steps)`` samples
    one draft token per slot from the warped draft distribution (the
    sampler's temperature / top-k / top-p filter; one-hot of the argmax
    at temperature <= 0) and returns (tokens [S], distributions [S, V]).

    ``accept(tlgs [S, k+1, V], dtoks [S, k], dprobs [S, k, V], ...)``
    is exact rejection sampling: draft token j is accepted iff u_j <
    p_target(d_j) / p_draft(d_j); the first rejected position resamples
    from the normalized residual max(p_target - p_draft, 0), and full
    acceptance draws the bonus token from the target's last row.  At
    temperature <= 0 both distributions are one-hot, so the commit is the
    target's argmax: the plain engine's greedy tokens.  Returns
    (n_commit [S], commit [S, k+1], finite [S])."""

    def key(seeds, stream, steps):
        return fold_in(fold_in(prng_key(seeds), stream), steps)

    def warped(lg, t, k, p):
        # the sampler's filter as a distribution; one-hot at temperature 0
        masked = filtered_logits(lg, t, k, p, vocab_size)
        onehot = torch.nn.functional.one_hot(lg.argmax(-1), vocab_size).float()
        return torch.where(t.reshape(-1, 1) <= 0.0, onehot, torch.softmax(masked, dim=-1))

    def propose(lgs, temps, top_ks, top_ps, seeds, steps):
        lgs = lgs.float()
        dist = warped(lgs, temps, top_ks, top_ps)
        g = gumbel_from_key(key(seeds, _DRAFT_STREAM, steps), vocab_size)
        sampled = torch.argmax(torch.log(torch.clamp(dist, min=1e-30)) + g, dim=-1)
        return torch.where(temps <= 0.0, lgs.argmax(-1), sampled), dist

    def accept(tlgs, dtoks, dprobs, temps, top_ks, top_ps, seeds, steps):
        s_n, t_n, v_n = tlgs.shape                  # t_n = n_spec + 1
        tlgs = tlgs.float()
        finite = torch.isfinite(tlgs).flatten(1).all(dim=-1)
        rep = lambda x: x.repeat_interleave(t_n)
        targ = warped(tlgs.reshape(s_n * t_n, v_n), rep(temps), rep(top_ks),
                      rep(top_ps)).reshape(s_n, t_n, v_n)
        dev = tlgs.device
        j = torch.arange(n_spec, device=dev)
        p_t_d = targ[:, :n_spec].gather(-1, dtoks[..., None])[..., 0]
        p_d_d = dprobs.gather(-1, dtoks[..., None])[..., 0]
        u = uniform(key(seeds[:, None], _ACCEPT_STREAM, steps[:, None] + j))
        acc = u < p_t_d / torch.clamp(p_d_d, min=1e-30)
        a = torch.cumprod(acc.long(), dim=-1).sum(-1)[:, None]  # leading accepts
        dp_full = torch.cat([dprobs, dprobs.new_zeros(s_n, 1, v_n)], 1)
        resid = torch.clamp(targ - dp_full, min=0.0)
        rs = resid.sum(-1, keepdim=True)
        resid = torch.where(rs > 0, resid / torch.clamp(rs, min=1e-30), targ)
        jr = torch.arange(t_n, device=dev)
        g = gumbel_from_key(key(seeds[:, None], _RESID_STREAM, steps[:, None] + jr),
                            v_n).reshape(s_n, t_n, v_n)
        draws = torch.argmax(torch.log(torch.clamp(resid, min=1e-30)) + g, dim=-1)
        dt_full = torch.cat([dtoks, dtoks.new_zeros(s_n, 1)], 1)
        zero = torch.zeros_like(dt_full)
        sampled = torch.where(jr < a, dt_full, torch.where(jr == a, draws, zero))
        greedy = torch.where(jr < a, dt_full,
                             torch.where(jr == a, tlgs.argmax(-1), zero))
        commit = torch.where(temps[:, None] <= 0.0, greedy, sampled)
        return a[:, 0] + 1, commit, finite

    return propose, accept


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)


def _leaves_of(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_of(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_of(v)]
    return [tree]


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.clone()


def _signature(tree):
    """The structure, shapes and dtypes of a parameter tree."""
    if isinstance(tree, dict):
        return {k: _signature(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_signature(v) for v in tree]
    return tuple(tree.shape), tree.dtype


def _params_of(model):
    """The parameter tree ``model`` decodes with: a decode adapter's or a
    sharded LM's ``params``, a ``TransformerLM`` network's through the
    decode adapter (a registry hands out networks), or a bare tree."""
    if hasattr(model, "decode_program"):
        return model.params
    if hasattr(getattr(model, "conf", None), "layers") and hasattr(model, "params"):
        from ..models.transformer import TransformerDecodeAdapter
        return TransformerDecodeAdapter(model).params
    return getattr(model, "params", model)


def _to_host(payload):
    """A gathered page payload as numpy (int8 values and f32 scales as
    stored: no dtype conversion)."""
    if isinstance(payload, QuantPages):
        return QuantPages(payload.q.cpu().numpy(), payload.scale.cpu().numpy())
    return payload.cpu().numpy()


def _pages_slice(side, a: int, b: int, device):
    """Pages a..b-1 of a host payload as tensors on ``device``."""
    if isinstance(side, QuantPages):
        return QuantPages(*(torch.from_numpy(x[:, a:b].copy()).to(device) for x in side))
    return torch.from_numpy(side[:, a:b].copy()).to(device)


class DecodeEngine:
    """``DecodeEngine(adapter).load()`` then ``generate(prompt_ids, ...)``.

    ``model`` provides ``decode_program()`` and ``params``
    (``models.TransformerDecodeAdapter``, ``parallel.ShardedTransformerLM``).
    ``device`` defaults to ``cuda``; ``clock`` (monotonic seconds) and
    ``metrics`` are injectable.  ``role`` is ``"unified"``,
    ``"prefill"`` or ``"decode"``; ``tenants`` a ``tenancy.TenantTable``
    (per-tenant lanes and quotas in the batcher).  The feature arguments
    and their checks are the reference's: ``max_retries``,
    ``decode_horizon``, ``prefill_chunk``, ``kv_dtype``,
    ``prefix_cache``, ``draft_model`` and ``speculate_k`` (see the module
    docstring)."""

    def __init__(self, model, *, max_slots: int = 4, page_size: int = 16,
                 max_len: Optional[int] = None,
                 total_pages: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, slo_ms: float = 30_000.0,
                 max_queue: int = 256, admission: str = "block",
                 max_retries: int = 1, default_max_new: int = 32,
                 clock=time.monotonic, tag: str = "v0",
                 metrics: Optional[DecodeMetrics] = None,
                 prefix_cache: bool = False, draft_model=None,
                 speculate_k: int = 4, kv_dtype: Optional[str] = None,
                 role: str = "unified", tenants=None,
                 decode_horizon: int = 1, prefill_chunk: Optional[int] = None,
                 device: DeviceLike = None):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        if decode_horizon > 1 and draft_model is not None:
            raise ValueError(
                "fused multi-step decode and speculative decoding are "
                "mutually exclusive — speculation keeps its own round "
                "structure (propose/verify/commit), so a fused horizon "
                "has nothing to amortize there")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if prefill_chunk is not None and role != "unified":
            raise ValueError(
                "chunked prefill is unified-role only: a decode-role "
                "host never prefills, and a prefill-role host has no "
                "step loop to interleave with")
        if prefill_chunk is not None and draft_model is not None:
            raise ValueError(
                "chunked prefill + speculative decoding is unsupported "
                "(the draft pool's mirror prefill is not chunked)")
        if kv_dtype not in (None, "f32", "float32", "int8", "i8"):
            raise ValueError(f"kv_dtype {kv_dtype!r} not supported "
                             "(float32 or int8)")
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"role {role!r} not supported "
                             "(unified, prefill, or decode)")
        if role != "unified" and draft_model is not None:
            raise ValueError(
                "speculative decoding is unified-role only — the draft "
                "pool's state never crosses a page handoff")
        self.role = role
        self._mesh = getattr(model, "mesh", None)
        self.device = resolve_device(device)
        self.program = model.decode_program(page_size=page_size, max_len=max_len)
        prog = self.program
        if prog.tp > 1 and kv_dtype in ("int8", "i8"):
            raise ValueError(
                "int8 KV + tensor-parallel decode is unsupported: the "
                "per-row quantization scale is an amax over ALL heads "
                "and cannot be computed inside one head shard")
        self._prefix_on = bool(prefix_cache)
        if self._prefix_on and prog.prefill_at is None:
            raise ValueError(
                "prefix_cache=True needs a decode program with a "
                "prefill_at entry point (suffix prefill)")
        self.decode_horizon = int(decode_horizon)
        if self.decode_horizon > 1 and prog.step_multi is None:
            raise ValueError(
                "decode_horizon > 1 needs a decode program with a "
                "step_multi entry point (fused multi-step decode)")
        self.prefill_chunk = None if prefill_chunk is None else int(prefill_chunk)
        if self.prefill_chunk is not None and prog.prefill_at is None:
            raise ValueError(
                "prefill_chunk needs a decode program with a prefill_at "
                "entry point (offset prefill drives each chunk)")
        self._kv_dtype = kv_dtype
        self.speculate_k = int(speculate_k)
        self._draft_program = None
        self._draft_params = None
        self._draft_cache = None
        if draft_model is not None:
            if self.speculate_k < 1:
                raise ValueError("speculate_k must be >= 1")
            if prog.spec_step is None:
                raise ValueError(
                    "speculative decoding needs a decode program with a "
                    "spec_step entry point (multi-token verify)")
            dprog = draft_model.decode_program(page_size=page_size,
                                               max_len=prog.max_len)
            if (dprog.vocab_size != prog.vocab_size
                    or dprog.max_len != prog.max_len
                    or dprog.page_size != prog.page_size):
                raise ValueError(
                    "draft/target program mismatch: vocab "
                    f"{dprog.vocab_size}/{prog.vocab_size}, max_len "
                    f"{dprog.max_len}/{prog.max_len}, page_size "
                    f"{dprog.page_size}/{prog.page_size} must all agree")
            self._draft_program = dprog
            self._draft_params = _to_device(getattr(draft_model, "params", draft_model),
                                            self.device)
            self._spec_fns = _make_spec_fns(prog.vocab_size, self.speculate_k)
        self._prefix_root = _PrefixNode((), None, None)
        self._trie_pages = 0
        self.max_slots = int(max_slots)
        self.eos_id = eos_id
        self.max_retries = int(max_retries)
        self.default_max_new = int(default_max_new)
        self.clock = clock
        self.total_pages = int(total_pages if total_pages is not None
                               else 1 + self.max_slots * prog.pages_per_slot)
        if self.total_pages < 1 + prog.pages_per_slot:
            raise ValueError(
                f"total_pages {self.total_pages} cannot hold even one "
                f"full-length request ({prog.pages_per_slot} pages) plus "
                "the scratch page")
        self.metrics = metrics or DecodeMetrics()
        self.tenants = tenants
        self.batcher = ContinuousBatcher(
            max_batch=self.max_slots, slo_ms=slo_ms, max_queue=max_queue,
            admission=admission, metrics=self.metrics, clock=clock,
            tenants=tenants)
        buckets = sorted(set(int(b) for b in (prompt_buckets
                                              or pow2_buckets(prog.max_len))))
        self.prompt_buckets = [b for b in buckets if 0 < b <= prog.max_len]
        if not self.prompt_buckets:
            raise ValueError(f"no prompt bucket <= max_len {prog.max_len}: {buckets}")
        self.max_prompt = min(self.prompt_buckets[-1], prog.max_len - 1)
        # version tag -> parameters on the device; named models map to
        # their tag here.  Every version shares the program and the pool.
        self._versions: Dict[str, Any] = {tag: _to_device(_params_of(model), self.device)}
        self._serve_tag = tag
        self._model_tags: Dict[str, str] = {}
        self._model_last_used: Dict[str, float] = {}
        self._slots: List[Optional[_Slot]] = [None] * self.max_slots
        self._page_table = np.zeros((self.max_slots, prog.pages_per_slot), np.int64)
        self._free_pages = deque(range(1, self.total_pages))
        self._cache = None
        self._prepared: Dict[str, None] = {}     # load()'s captured graphs, by bundle key
        self.step_multi_graph = None     # serving.cuda_graphs.StepMultiGraph on cuda
        self._graph_params = None        # the graph's own copy of one parameter tree:
        self._graph_src = None           # the tree whose values it holds
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._loaded = False
        self._shutdown = False
        self._generation = 0
        self._chunk_cursor = 0     # round-robin over chunked prefills
        self._crash_next = False   # test hook: raise inside the next step
        self._thread: Optional[threading.Thread] = None
        self._supervisor: Optional[threading.Thread] = None
        self._autoscaler = None             # see enable_autoscale()
        self._autoscale_cb = None
        self._autoscale_interval_s = 0.25
        self._last_autoscale_t: Optional[float] = None
        self._shed_seen = 0.0
        self._logical_replicas = 1

    @property
    def params(self):
        """The default model's current parameters."""
        with self._lock:
            return self._versions[self._serve_tag]

    @params.setter
    def params(self, value) -> None:
        """Replace the default version's parameters in place of its tag
        (no swap: slots of that tag read the new values from their next
        step, a captured graph too: it copies a tree in whenever the one
        it is given is not the one it holds)."""
        with self._lock:
            self._versions[self._serve_tag] = value

    # -- load ----------------------------------------------------------------

    def load(self, warm_bundle: Optional[str] = None) -> "DecodeEngine":
        """Allocate the page pool (and the draft's) on the device, capture
        the fused horizon's CUDA graph on a card, and start the decode
        loop and its supervisor.  ``warm_bundle`` is a bundle
        ``save_warmup_bundle`` wrote: a captured graph it names counts
        ``bundle_hits``, one it does not ``bundle_misses``."""
        from .warmcache import load_bundle

        prog = self.program
        self._cache = alloc_cache(prog.n_layers, self.total_pages, prog.page_size,
                                  prog.n_heads, prog.d_head, device=self.device,
                                  kv_dtype=self._kv_dtype,
                                  shard_devices=prog.shard_devices if prog.tp > 1 else None)
        if self._draft_program is not None:
            dprog = self._draft_program
            self._draft_cache = alloc_cache(dprog.n_layers, self.total_pages,
                                            dprog.page_size, dprog.n_heads,
                                            dprog.d_head, device=self.device,
                                            kv_dtype=self._kv_dtype)
        bundle = (load_bundle(warm_bundle, device=self.device, mesh=self._bundle_mesh())
                  if warm_bundle else {})
        t0 = self.clock()
        with obs_trace.span("serve/warmup", cat="serve", kind="decode",
                            tag=self._serve_tag, role=self.role):
            if (self.decode_horizon > 1 and self.device.type == "cuda"
                    and self.role != "prefill"):
                from .cuda_graphs import StepMultiGraph
                with torch.inference_mode():
                    self._graph_src = self.params
                    self._graph_params = _clone_tree(self._graph_src)
                    self.step_multi_graph = StepMultiGraph(
                        prog, self._graph_params, self._cache, self.max_slots,
                        self.decode_horizon, self.device)
                self._prepared[f"step_multi:{self.decode_horizon}"] = None
        hits = sum(1 for k in self._prepared if k in bundle)
        self.metrics.inc("bundle_hits", hits)
        self.metrics.inc("bundle_misses", len(self._prepared) - hits)
        self.metrics.inc("warmup_seconds_total", self.clock() - t0)
        with self._lock:
            self._refresh_gauges_locked()
        self._loaded = True
        self._start_loop()
        self._supervisor = threading.Thread(target=self._supervise,
                                            name="decode-supervisor", daemon=True)
        self._supervisor.start()
        return self

    def _bundle_mesh(self):
        return self._mesh if self.program.tp > 1 else None

    def save_warmup_bundle(self, path: str) -> str:
        """Write a warm bundle naming every captured graph
        (``serving/warmcache.py``); a sharded program's bundle carries the
        mesh in its fingerprint, so a process of another mesh refuses it."""
        from .warmcache import save_bundle
        if not self._loaded:
            raise RuntimeError("load() the engine before bundling")
        entries = {key: {"key": key} for key in self._prepared}
        return save_bundle(path, self._serve_tag, entries, device=self.device,
                           mesh=self._bundle_mesh())

    def compile_cache_size(self) -> int:
        """Graphs captured at ``load()``: the fused horizon's on a card,
        else none.  Flat while serving, across swaps and named models."""
        return len(self._prepared)

    @property
    def current_tag(self) -> str:
        with self._lock:
            return self._serve_tag

    # -- request path ----------------------------------------------------------

    def generate_async(self, prompt_ids, *, max_new_tokens: Optional[int] = None,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0, seed: int = 0,
                       slo_ms: Optional[float] = None,
                       deadline: Optional[float] = None,
                       echo_logits: bool = False,
                       model: Optional[str] = None,
                       tenant: Optional[str] = None) -> Future:
        """Enqueue one generation; the Future resolves to a
        ``GenerationResult`` (on a prefill-role host, a
        ``PrefillHandoff``) or a typed serving error.  ``model`` routes to
        a placed named model (``ModelNotLoadedError`` if it is not);
        ``tenant`` tags the request for its lane and quota."""
        if not self._loaded:
            raise RuntimeError("DecodeEngine.load() must run before generate")
        if model is not None:
            with self._lock:
                if model not in self._model_tags:
                    f: Future = Future()
                    f.set_exception(ModelNotLoadedError(
                        f"model {model!r} is not placed on this decode host"))
                    return f
        if self.role == "decode":
            raise RuntimeError(
                "decode-role host accepts page handoffs (continue_async), "
                "not raw prompts — route prompts at a prefill or unified "
                "host")
        prog = self.program
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if prompt.shape[0] < 1 or prompt.shape[0] > self.max_prompt:
            raise ValueError(
                f"prompt length {prompt.shape[0]} outside [1, "
                f"{self.max_prompt}] (largest bucket, < max_len {prog.max_len})")
        if prompt.min() < 0 or prompt.max() >= prog.vocab_size:
            raise ValueError(f"prompt ids outside [0, {prog.vocab_size})")
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.default_max_new)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        max_new = min(max_new, prog.max_len - int(prompt.shape[0]))
        if temperature < 0:
            raise ValueError("temperature must be >= 0 (0 = greedy)")
        if not (0 <= top_k <= prog.vocab_size):
            raise ValueError(f"top_k outside [0, {prog.vocab_size}]")
        if not (0 < top_p <= 1.0):
            raise ValueError("top_p must be in (0, 1]")
        if not (0 <= int(seed) < 2 ** 32):
            raise ValueError("seed must be in [0, 2**32)")
        spec = _GenSpec(prompt=prompt, max_new=max_new,
                        temperature=float(temperature), top_k=int(top_k),
                        top_p=float(top_p), seed=int(seed),
                        echo_logits=bool(echo_logits))
        return self.batcher.submit_request(spec, slo_ms=slo_ms, deadline=deadline,
                                           tenant=tenant, model=model)

    def generate(self, prompt_ids, **kw):
        """Blocking ``generate_async``."""
        return self.generate_async(prompt_ids, **kw).result()

    def continue_async(self, handoff: PrefillHandoff, *,
                       slo_ms: Optional[float] = None,
                       deadline: Optional[float] = None,
                       tenant: Optional[str] = None) -> Future:
        """Enqueue the decode stage of a disaggregated generation (a
        ``role="decode"`` engine only): attach the prefill host's pages,
        then decode on from its first token.  Resolves to the
        ``GenerationResult`` a unified engine gives: sampling continues at
        step 1 of the same counter-keyed stream.  A corrupt or mismatched
        payload fails this future with ``ValueError`` before any page is
        allocated."""
        if not self._loaded:
            raise RuntimeError("DecodeEngine.load() must run before continue_async")
        if self.role != "decode":
            raise RuntimeError("continue_async needs a role='decode' engine "
                               f"(this one is {self.role!r})")
        prog = self.program
        prompt = np.asarray(handoff.prompt, np.int64).reshape(-1)
        n = int(prompt.shape[0])
        if n < 1 or n >= prog.max_len:
            raise ValueError(f"handoff prompt length {n} outside [1, {prog.max_len})")
        if prompt.min() < 0 or prompt.max() >= prog.vocab_size:
            raise ValueError(f"prompt ids outside [0, {prog.vocab_size})")
        if not 0 <= int(handoff.first_token) < prog.vocab_size:
            raise ValueError(f"handoff first_token {handoff.first_token} outside "
                             f"[0, {prog.vocab_size})")
        max_new = max(1, min(int(handoff.max_new), prog.max_len - n))
        spec = _HandoffSpec(
            prompt=prompt, max_new=max_new, temperature=float(handoff.temperature),
            top_k=int(handoff.top_k), top_p=float(handoff.top_p),
            seed=int(handoff.seed), echo_logits=bool(handoff.echo_logits),
            handoff=handoff)
        return self.batcher.submit_request(spec, slo_ms=slo_ms, deadline=deadline,
                                           tenant=tenant)

    # -- hot swap and named models ---------------------------------------------------

    def _check_params_compat(self, params, tag: str) -> None:
        """Incoming parameters must have the loaded tree, shapes and
        dtypes: every version and named model shares the program and
        the prepared programs."""
        want, got = _signature(self.params), _signature(params)
        if type(want) is not type(got) or (
                isinstance(want, dict) and set(want) != set(got)):
            raise ValueError(f"incoming model {tag!r} has a different "
                             "parameter tree")
        if want != got:
            raise ValueError(
                f"incoming model {tag!r} has mismatched parameter "
                "shapes/dtypes — decode versions must share the compiled "
                "executables")

    def swap_model(self, model, tag: str, name: Optional[str] = None) -> None:
        """Flip the version new admissions decode under; slots in flight
        finish under the version that prefilled them (the step runs once
        per live tag), so no request mixes versions and nothing drains.
        The old version is dropped when the next slot is released and
        nothing holds it.  ``name`` scopes the flip to one placed named
        model."""
        params = _params_of(model)
        self._check_params_compat(params, tag)
        params = _to_device(params, self.device)
        with self._lock:
            if name is not None:
                if name not in self._model_tags:
                    raise ModelNotLoadedError(
                        f"model {name!r} is not placed on this decode host")
                self._versions[tag] = params
                self._model_tags[name] = tag
            else:
                self._versions[tag] = params
                self._serve_tag = tag
        self.metrics.inc("swaps")
        obs_trace.instant("serve/swap", cat="serve", incoming=tag,
                          kind="decode", model=name)

    def add_model(self, name: str, model, tag: Optional[str] = None) -> "DecodeEngine":
        """Place a named model beside the default one: its parameters must
        fit the loaded program (same tree, shapes and dtypes), so placing
        it costs their residency and nothing is prepared anew.
        ``generate_async(model=name)`` routes to it."""
        if not name:
            raise ValueError("model name must be non-empty")
        params = _params_of(model)
        tag = tag or f"{name}:v0"
        self._check_params_compat(params, tag)
        params = _to_device(params, self.device)
        with self._lock:
            if name in self._model_tags:
                raise ValueError(f"model {name!r} is already placed")
            self._versions[tag] = params
            self._model_tags[name] = tag
            self._model_last_used[name] = self.clock()
        self.metrics.inc("model_loads")
        obs_trace.instant("serve/model_load", cat="serve", model=name,
                          tag=tag, kind="decode")
        return self

    def add_model_from_registry(self, registry, name: str, ref: str = "prod", *,
                                subscribe: bool = False) -> "DecodeEngine":
        """``add_model`` of ``name@ref`` from a registry (tag ``name:vN``);
        ``subscribe=True`` follows the alias's moves with swaps of this
        named model."""
        version, model = registry.resolve(name, ref)
        self.add_model(name, model, tag=f"{name}:v{version}")
        if subscribe:
            registry.subscribe(
                name, ref,
                lambda ver, m: self.swap_model(m, f"{name}:v{ver}", name=name))
        return self

    def remove_model(self, name: str) -> bool:
        """Evict a named model: unroute it (its queued requests fail with
        ``ModelNotLoadedError`` at admission, so a fleet reroutes them);
        slots in flight finish under their tag, whose parameters stay
        until the last of them completes.  False if it was not placed."""
        with self._lock:
            tag = self._model_tags.pop(name, None)
            self._model_last_used.pop(name, None)
            if tag is None:
                return False
            self._gc_versions_locked()
        self.metrics.inc("model_evictions")
        obs_trace.instant("serve/model_evict", cat="serve", model=name,
                          tag=tag, kind="decode")
        return True

    def has_model(self, name: Optional[str]) -> bool:
        """True when this engine decodes ``name`` (None, the default
        model, always)."""
        if name is None:
            return True
        with self._lock:
            return name in self._model_tags

    def placed_models(self) -> Dict[str, str]:
        """name → serve tag of every model this engine decodes (the
        default under "")."""
        with self._lock:
            out = {"": self._serve_tag}
            out.update(self._model_tags)
            return out

    def model_last_used(self, name: str) -> Optional[float]:
        """Engine-clock time of the last admission of a named model (None:
        never, or not placed)."""
        with self._lock:
            return self._model_last_used.get(name)

    def attach_registry(self, registry, name: str, alias: str = "prod") -> "DecodeEngine":
        """Serve (name, alias) from a ``ModelRegistry`` and follow every
        ``set_alias`` move with a ``swap_model``."""
        version, model = registry.resolve(name, alias)
        self.swap_model(model, f"{name}:v{version}")
        registry.subscribe(name, alias,
                           lambda ver, mod: self.swap_model(mod, f"{name}:v{ver}"))
        return self

    def _gc_versions_locked(self) -> None:
        """Drop every version no slot, default or named model holds."""
        live = {s.tag for s in self._slots if s is not None}
        live.add(self._serve_tag)
        live.update(self._model_tags.values())
        for t in [t for t in self._versions if t not in live]:
            del self._versions[t]

    # -- autoscale -------------------------------------------------------------------

    def enable_autoscale(self, on_scale, autoscaler=None, *, min_replicas: int = 1,
                         max_replicas: int = 4, interval_s: float = 0.25,
                         **knobs) -> "DecodeEngine":
        """Arm the load controller over the decode queue.  Decode capacity
        is fixed by ``max_slots``, so the actuator is a callback:
        ``on_scale(delta, replicas)`` with +1/-1 and the new logical
        replica count (the fleet owns physical decode hosts, a new one
        warming from this engine's bundle).  The supervisor ticks the
        controller every ``interval_s``; spans and scale counters are
        emitted here."""
        from .autoscale import ReplicaAutoscaler
        if autoscaler is None:
            autoscaler = ReplicaAutoscaler(min_replicas=int(min_replicas),
                                           max_replicas=int(max_replicas),
                                           clock=self.clock, **knobs)
        self._autoscale_interval_s = float(interval_s)
        self._shed_seen = self.metrics.counter_value("shed")
        self._autoscale_cb = on_scale
        self._autoscaler = autoscaler
        return self

    def _autoscale_tick(self) -> None:
        a = self._autoscaler
        if a is None or not self._loaded or self._shutdown:
            return
        now = self.clock()
        if (self._last_autoscale_t is not None
                and now - self._last_autoscale_t < self._autoscale_interval_s):
            return
        self._last_autoscale_t = now
        shed = self.metrics.counter_value("shed")
        shed_delta = shed - self._shed_seen
        self._shed_seen = shed
        with self._lock:
            active = sum(1 for s in self._slots if s is not None)
        decision = a.observe(self.batcher.qsize(), active, self._logical_replicas,
                             shed_delta=int(shed_delta))
        if decision == 0:
            return
        self._logical_replicas += decision
        name = "serve/scale_up" if decision > 0 else "serve/scale_down"
        with obs_trace.span(name, cat="serve", kind="decode",
                            replicas=self._logical_replicas):
            self._autoscale_cb(1 if decision > 0 else -1, self._logical_replicas)
        self.metrics.inc("scale_ups" if decision > 0 else "scale_downs")

    # -- the loop and its supervisor ---------------------------------------------

    def _start_loop(self) -> None:
        with self._lock:
            self._generation += 1
            gen = self._generation
            self._thread = threading.Thread(target=self._loop, args=(gen,),
                                            name=f"decode-loop-{gen}", daemon=True)
            self._thread.start()

    def _supervise(self) -> None:
        """Tick the autoscaler, and respawn the decode loop if it dies
        outright (a crash its own handler could not absorb); its requests
        are retried or failed, never stranded."""
        while not self._stop.wait(0.05):
            with self._lock:
                if self._shutdown:
                    return
                t = self._thread
            self._autoscale_tick()
            if t is not None and not t.is_alive():
                obs_trace.instant("serve/replica_crash", cat="serve",
                                  kind="decode_loop_dead")
                self.metrics.inc("replica_crashes")
                self._drain_crashed(ReplicaCrashError("decode loop thread died"))
                with self._lock:
                    if self._shutdown:
                        return
                self.metrics.inc("replica_respawns")
                self._start_loop()

    def _loop(self, gen: int) -> None:
        if self.role == "prefill":
            # a prefill host trades its queued prompts' TTFT for the
            # inter-token latency of a decode host sharing the machine:
            # its loop thread runs at the lowest priority
            try:
                os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
            except (AttributeError, OSError):
                pass
        with torch.inference_mode():
            while True:
                with self._lock:
                    if self._shutdown or gen != self._generation:
                        return
                try:
                    worked = self._admit_some()
                    if self.prefill_chunk is not None:
                        # at most one chunk of prefill a turn, so the
                        # decode dispatch never waits behind more than
                        # prefill_chunk prompt tokens
                        worked = self._prefill_chunk_step() or worked
                    if self._draft_program is not None:
                        stepped = self._spec_step_once()
                    elif self.decode_horizon > 1:
                        stepped = self._step_fused_once()
                    else:
                        stepped = self._step_once()
                    worked = stepped or worked
                except Exception as e:   # the loop must keep serving
                    obs_trace.instant("serve/replica_crash", cat="serve",
                                      kind="decode_step", error=type(e).__name__)
                    self.metrics.inc("replica_crashes")
                    self._drain_crashed(e)
                    continue
                if not worked:
                    self.batcher.wait_for_work(0.05)

    # -- radix prefix cache (host trie; loop thread + _lock) ---------------------

    def _iter_trie(self):
        stack = list(self._prefix_root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            yield nd

    def _prefix_lookup(self, prompt: np.ndarray) -> List[_PrefixNode]:
        """Longest page-aligned prefix match, capped at (n-1)//page_size
        pages so the suffix prefill has at least one real token (the last
        prompt token's logits give the first sample)."""
        ps = self.program.page_size
        node, nodes = self._prefix_root, []
        for j in range((int(prompt.shape[0]) - 1) // ps):
            child = node.children.get(tuple(int(x) for x in prompt[j * ps:(j + 1) * ps]))
            if child is None:
                break
            nodes.append(child)
            node = child
        return nodes

    def _prefix_insert(self, s: _Slot, now: float) -> None:
        """Move the pages fully covered by ``s``'s prompt (past the
        matched prefix) from its private list into the trie, refcount 1
        (held by ``s`` until it finishes).  Runs right after a finite
        first token, so the trie never holds rows of a poisoned prefill;
        pages fully covered by the prompt are never written again."""
        ps = self.program.page_size
        prompt = s.spec.prompt
        node = s.shared_nodes[-1] if s.shared_nodes else self._prefix_root
        inserted = 0
        for j in range(s.n_matched, int(prompt.shape[0]) // ps):
            key = tuple(int(x) for x in prompt[j * ps:(j + 1) * ps])
            if key in node.children:
                # the match was capped below an existing node: our copy of
                # the page stays private, stop extending
                break
            child = _PrefixNode(key, s.page_ids.pop(0), node)
            child.refs = 1
            child.last_used = now
            node.children[key] = child
            s.shared_nodes.append(child)
            node = child
            inserted += 1
        if inserted:
            self._trie_pages += inserted
            self.metrics.inc("prefix_inserts", inserted)
            self.metrics.set_gauge("shared_pages", self._trie_pages)

    def _prefix_evict(self, need: int) -> int:
        """LRU eviction of refcount-zero leaves (a refs-0 node's children
        are refs-0 too, so leaves go first and parents follow as their
        subtree drains).  Evicted pages return to the free list unscrubbed:
        trie rows were finite at insert."""
        import heapq
        heap = [(nd.last_used, nd.page_id, nd) for nd in self._iter_trie()
                if nd.refs <= 0 and not nd.children]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < need:
            _, _, nd = heapq.heappop(heap)
            if nd.children or nd.refs > 0 or nd.detached:
                continue
            nd.parent.children.pop(nd.key, None)
            nd.detached = True
            self._trie_pages -= 1
            self._free_pages.append(nd.page_id)
            freed += 1
            p = nd.parent
            if p is not self._prefix_root and p.refs <= 0 and not p.children:
                heapq.heappush(heap, (p.last_used, p.page_id, p))
        if freed:
            self.metrics.inc("prefix_evictions", freed)
            self.metrics.set_gauge("shared_pages", self._trie_pages)
        return freed

    def _debug_page_state(self) -> dict:
        """Page ids 1..total_pages-1 split into free / slot-private /
        trie-resident: each page is exactly one of them."""
        with self._lock:
            return {
                "free": sorted(self._free_pages),
                "private": sorted(p for s in self._slots if s is not None
                                  for p in s.page_ids),
                "trie": sorted(nd.page_id for nd in self._iter_trie()),
            }

    # -- admission and prefill -----------------------------------------------------

    def _admit_some(self) -> bool:
        """Join queued requests to the running batch: a slot and pages
        (the longest matching prefix attached read-only when the prefix
        cache is on), then the prefill and the first token, the page
        export of a prefill host, the page attach of a decode host, or
        (chunked prefill) the chunk loop later.  Stops at the first
        request the pool cannot hold yet (FIFO order kept)."""
        with self._lock:
            free = [i for i, s in enumerate(self._slots) if s is None]
        if not free:
            return False
        # chunked prefill's admission rule: one round takes in at most one
        # chunk budget of prompt tokens (the head request always)
        reqs = self.batcher.admit(len(free), token_budget=self.prefill_chunk)
        prog = self.program
        leftovers: List[Any] = []
        worked = False
        for r in reqs:
            if leftovers:
                leftovers.append(r)
                continue
            spec = r.payload
            handoff = getattr(spec, "handoff", None)
            transfer = None
            with self._lock:
                if r.model is None:
                    slot_tag = self._serve_tag
                else:
                    slot_tag = self._model_tags.get(r.model)
                    if slot_tag is not None:
                        self._model_last_used[r.model] = self.clock()
            if slot_tag is None:
                # evicted between submission and admission: a typed
                # failure the fleet retries elsewhere (demand reload)
                self.metrics.inc("errors")
                _fail_safe(r.future, ModelNotLoadedError(
                    f"model {r.model!r} was evicted from this decode host"))
                continue
            if handoff is not None:
                try:
                    # before any allocation: a corrupt transfer fails its
                    # request with the free list untouched
                    transfer = self._check_handoff(spec, handoff)
                except ValueError as e:
                    self.metrics.inc("errors")
                    _fail_safe(r.future, e)
                    continue
            n_prompt = int(spec.prompt.shape[0])
            if self.role == "prefill":
                # a prefill host never decodes: the prompt's pages only
                need_total = pages_for(n_prompt, prog.page_size)
            else:
                need_total = pages_for(min(n_prompt + spec.max_new, prog.max_len),
                                       prog.page_size)
            t_attach = self.clock()
            with self._lock:
                if self._shutdown or not free:
                    leftovers.append(r)
                    continue
                matched = self._prefix_lookup(spec.prompt) if self._prefix_on else []
                m = len(matched)
                need = need_total - m
                if len(self._free_pages) < need:
                    self._prefix_evict(need - len(self._free_pages))
                if len(self._free_pages) < need:
                    # nothing was incref'd yet, so a requeued request holds
                    # nothing and matches afresh next time
                    leftovers.append(r)
                    continue
                i = free.pop(0)
                now = self.clock()
                for nd in matched:
                    nd.refs += 1
                    nd.last_used = now
                ids = [self._free_pages.popleft() for _ in range(need)]
                self._page_table[i] = 0
                self._page_table[i, :m] = [nd.page_id for nd in matched]
                self._page_table[i, m:m + need] = ids
                slot = _Slot(r, slot_tag, ids, spec.max_new)
                slot.shared_nodes = matched
                slot.n_matched = m
                self._slots[i] = slot
                self._refresh_gauges_locked()
            if self._prefix_on:
                if m:
                    self.metrics.inc("prefix_hits")
                    self.metrics.inc("prefix_hit_tokens", m * prog.page_size)
                else:
                    self.metrics.inc("prefix_misses")
                obs_trace.complete_at("serve/prefix_attach", t_attach, self.clock(),
                                      cat="serve", slot=i, matched_pages=m,
                                      matched_tokens=m * prog.page_size)
            self.metrics.inc("requests")
            if transfer is not None:
                self._attach_handoff(i, transfer)
            elif self.role == "prefill":
                self._prefill_export(i)
            elif self.prefill_chunk is not None:
                # the chunk loop prefills it; not stepped until its last
                # chunk samples token 0
                slot.n_prefilled = m * prog.page_size
            else:
                self._prefill_slot(i)
            worked = True
        for r in reversed(leftovers):
            self.batcher.requeue_front(r)
        return worked

    def _check_handoff(self, spec, handoff) -> PageTransfer:
        """Unpack an inbound transfer and check it against this pool's
        layout (layers, page size, all heads, head width, kv dtype) and
        the prompt's page count; ``ValueError`` on any mismatch or
        corruption."""
        transfer = unpack_transfer(handoff.pages)
        want = pages_for(int(spec.prompt.shape[0]), self.program.page_size)
        if transfer.n_pages != want:
            raise ValueError(
                f"handoff carries {transfer.n_pages} pages; a prompt of "
                f"{int(spec.prompt.shape[0])} tokens needs {want}")
        n_layers, page, heads, d, kind = pool_layout(self._cache[0])
        rows = (n_layers, transfer.n_pages, page)
        for side in (transfer.k, transfer.v):
            if kind == "int8":
                ok = (isinstance(side, QuantPages) and side.q.dtype == np.int8
                      and side.q.shape == rows + (heads, d)
                      and side.scale.dtype == np.float32 and side.scale.shape == rows)
            else:
                ok = (not isinstance(side, QuantPages) and side.dtype == np.float32
                      and side.shape == rows + (heads, d))
            if not ok:
                raise ValueError(
                    "handoff page payload does not match this engine's pool "
                    "layout (n_layers / page dims / kv_dtype)")
        return transfer

    def _bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        return self.prompt_buckets[-1]

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _params_for(self, tag: str):
        with self._lock:
            return self._versions[tag]

    def _prefill_rows(self, i: int, offset: int, take: int):
        """Prefill prompt tokens offset..offset+take-1 of slot ``i`` (the
        whole prompt through ``prefill``, else ``prefill_at``) into the
        target pool and, when speculating, the draft pool, under the
        slot's version; returns (the last row's logits [V], the bucket)."""
        s = self._slots[i]
        bucket = self._bucket_for(take)
        padded = np.zeros((bucket,), np.int64)
        padded[:take] = s.spec.prompt[offset:offset + take]
        row, toks = self._dev(self._page_table[i]), self._dev(padded)

        def run(prog, params, cache):
            kp, vp = cache
            if offset:
                return prog.prefill_at(params, kp, vp, row, toks, take, offset)[2]
            return prog.prefill(params, kp, vp, row, toks, take)[2]

        lg = run(self.program, self._params_for(s.tag), self._cache)
        if self._draft_program is not None:
            # mirror the prompt into the draft pool (same page ids)
            run(self._draft_program, self._draft_params, self._draft_cache)
        return lg, bucket

    def _sample_first(self, s: _Slot, lg: torch.Tensor):
        """Token 0 of a request from its prefill logits → (token, finite,
        the logits row on the host when echoed)."""
        spec = s.spec
        tok, fin = sample_tokens(lg[None], [spec.temperature], [spec.top_k],
                                 [spec.top_p], [spec.seed], [0],
                                 self.program.vocab_size)
        lg_h = lg.float().cpu().numpy() if spec.echo_logits else None
        return int(tok[0]), bool(fin[0]), lg_h

    def _first_token(self, i: int, lg: torch.Tensor, t0: float, bucket: int,
                     prompt_tokens: int, offset: Optional[int] = None) -> None:
        """The end of a prefill: sample token 0, record TTFT, insert the
        prompt's pages into the trie, record the token."""
        s = self._slots[i]
        tok_h, fin_h, lg_h = self._sample_first(s, lg)
        t1 = self.clock()
        extra = {} if offset is None else {"offset": offset}
        obs_trace.complete_at("serve/prefill", t0, t1, cat="serve", slot=i,
                              bucket=bucket, prompt_tokens=prompt_tokens,
                              **extra, model=s.tag)
        self.metrics.inc("prefills")
        self.metrics.ttft.record((t1 - s.req.t_submit) * 1e3)
        s.t_first = t1
        if self._prefix_on and fin_h:
            # before the token is recorded, so a same-prompt request
            # admitted next hits; only after a finite first sample, so a
            # poisoned prefill's rows never enter the trie
            with self._lock:
                self._prefix_insert(s, t1)
        self._record_token(i, tok_h, fin_h, lg_h, t1)

    def _prefill_slot(self, i: int) -> None:
        """Prefill slot ``i``'s prompt; on a prefix hit only the suffix
        past the matched pages, through ``prefill_at``, whose rows attend
        over the shared pages with the same per-row math (bitwise the
        logits of a full prefill)."""
        s = self._slots[i]
        m = s.n_matched * self.program.page_size
        t0 = self.clock()
        lg, bucket = self._prefill_rows(i, m, s.n_prompt - m)
        self._first_token(i, lg, t0, bucket, s.n_prompt)

    def _prefill_chunk_step(self) -> bool:
        """Advance one chunked prefill by one chunk (at most
        ``prefill_chunk`` prompt tokens through ``prefill_at``),
        round-robin over the slots that are prefilling.  The last chunk
        samples token 0 and the slot joins the decode steps."""
        with self._lock:
            pending = [i for i, s in enumerate(self._slots)
                       if s is not None and s.n_prefilled is not None]
            if not pending:
                return False
            start = self._chunk_cursor
            i = min(pending, key=lambda x: (x - start) % self.max_slots)
            self._chunk_cursor = (i + 1) % self.max_slots
            s = self._slots[i]
        n, p = s.n_prompt, s.n_prefilled
        take = min(self.prefill_chunk, n - p)
        t0 = self.clock()
        lg, bucket = self._prefill_rows(i, p, take)
        self.metrics.inc("prefill_chunks")
        if p + take < n:
            obs_trace.complete_at("serve/prefill", t0, self.clock(), cat="serve",
                                  slot=i, bucket=bucket, prompt_tokens=take,
                                  offset=p, model=s.tag)
            s.n_prefilled = p + take
            return True
        if p > s.n_matched * self.program.page_size:
            self.metrics.inc("chunked_prefills")   # took two chunks or more
        s.n_prefilled = None
        self._first_token(i, lg, t0, bucket, take, offset=p)
        return True

    def _attach_handoff(self, i: int, transfer: PageTransfer) -> None:
        """The decode stage's admission: write the prefill host's pages
        into this slot's own pages (those below a local prefix match are
        deduped: the shared pages already hold those rows), then record
        the first token the prefill host sampled.  Position and sampling
        step land where a local prefill leaves them, so the continuation
        is bitwise a unified engine's."""
        s = self._slots[i]
        h = s.spec.handoff
        m = s.n_matched
        p_pro = transfer.n_pages
        t0 = self.clock()
        if p_pro > m:
            ids = self._dev(self._page_table[i][m:p_pro])
            for pool, side in zip(self._cache, (transfer.k, transfer.v)):
                set_pages(pool, ids, _pages_slice(side, m, p_pro, self.device))
        t1 = self.clock()
        obs_trace.complete_at("serve/prefill", t0, t1, cat="serve", slot=i,
                              bucket=0, prompt_tokens=s.n_prompt,
                              model=s.tag, attached_pages=p_pro - m)
        self.metrics.inc("prefills")
        self.metrics.inc("handoffs_in")
        self.metrics.inc("pages_attached", p_pro - m)
        if m:
            self.metrics.inc("pages_deduped", m)
        self.metrics.ttft.record((t1 - s.req.t_submit) * 1e3)
        s.t_first = t1
        fin_h = bool(h.finite)
        if self._prefix_on and fin_h:
            with self._lock:
                self._prefix_insert(s, t1)
        lg_h = (np.asarray(h.logits0, np.float32)
                if s.spec.echo_logits and h.logits0 is not None else None)
        self._record_token(i, int(h.first_token), fin_h, lg_h, t1)

    def _prefill_export(self, i: int) -> None:
        """A prefill host's admission: prefill and sample token 0 as a
        unified engine does, then export the slot (gather the prompt's
        pages, pack them, resolve the future with a ``PrefillHandoff``)
        and free it.  A poisoned prefill fails here and never crosses
        the wire."""
        s = self._slots[i]
        spec = s.spec
        n = s.n_prompt
        m = s.n_matched * self.program.page_size
        t0 = self.clock()
        lg, bucket = self._prefill_rows(i, m, n - m)
        tok_h, fin_h, lg_h = self._sample_first(s, lg)
        t1 = self.clock()
        obs_trace.complete_at("serve/prefill", t0, t1, cat="serve", slot=i,
                              bucket=bucket, prompt_tokens=n, model=s.tag)
        self.metrics.inc("prefills")
        self.metrics.ttft.record((t1 - s.req.t_submit) * 1e3)
        s.t_first = t1
        if not fin_h:
            self.metrics.inc("poison_isolated")
            self._scrub_pages(s.page_ids)
            self._finish(i, t1, error=PoisonInputError(
                f"prefill produced non-finite logits (slot {i}) — handoff "
                "suppressed, request isolated"))
            return
        if self._prefix_on:
            with self._lock:
                self._prefix_insert(s, t1)
        p_pro = pages_for(n, self.program.page_size)
        ids = self._dev(self._page_table[i][:p_pro])
        kp, vp = self._cache
        payload = pack_transfer(PageTransfer(n_pages=p_pro,
                                             k=_to_host(gather_pages(kp, ids)),
                                             v=_to_host(gather_pages(vp, ids))))
        handoff = PrefillHandoff(
            prompt=spec.prompt, max_new=s.max_new, temperature=spec.temperature,
            top_k=spec.top_k, top_p=spec.top_p, seed=spec.seed,
            echo_logits=spec.echo_logits, first_token=tok_h, finite=True,
            n_pages=p_pro, pages=payload, logits0=lg_h, model_tag=s.tag)
        self.metrics.inc("handoffs_out")
        self.metrics.inc("pages_exported", p_pro)
        now = self.clock()
        with self._lock:
            self._release_slot_locked(i, s, now)
        _set_safe(s.req.future, handoff)
        obs_trace.complete_at("serve/request", s.req.t_submit, now, cat="serve",
                              kind="prefill_handoff", tokens=1, finish="handoff")

    # -- decode steps --------------------------------------------------------------

    def _ready_tags(self) -> List[str]:
        """The versions of the slots a step serves, in slot order."""
        tags: List[str] = []
        with self._lock:
            for s in self._slots:
                if s is not None and s.n_prefilled is None and s.tag not in tags:
                    tags.append(s.tag)
        return tags

    def _gather_group(self, tag: str, budgets: bool = False):
        """The slots of version ``tag`` a step serves (occupied and done
        prefilling), their inputs as host arrays over every slot, and the
        version's parameters; None when there are none."""
        s_n = self.max_slots
        a = {"tokens": np.zeros((s_n,), np.int64),
             "positions": np.zeros((s_n,), np.int64),
             "active": np.zeros((s_n,), bool),
             "temps": np.zeros((s_n,), np.float32),
             "top_ks": np.zeros((s_n,), np.int64),
             "top_ps": np.ones((s_n,), np.float32),
             "seeds": np.zeros((s_n,), np.int64),
             "steps": np.zeros((s_n,), np.int64)}
        if budgets:
            a["budgets"] = np.ones((s_n,), np.int64)
        group: List[int] = []
        echo = False
        with self._lock:
            params = self._versions.get(tag)
            for i, s in enumerate(self._slots):
                if s is None or s.n_prefilled is not None or s.tag != tag:
                    continue
                group.append(i)
                a["tokens"][i] = s.last_token
                a["positions"][i] = s.pos
                a["active"][i] = True
                a["temps"][i] = s.spec.temperature
                a["top_ks"][i] = s.spec.top_k
                a["top_ps"][i] = s.spec.top_p
                a["seeds"][i] = s.spec.seed
                a["steps"][i] = s.n_out
                if budgets:
                    a["budgets"][i] = max(1, s.max_new - s.n_out)
                echo = echo or s.logits is not None
            a["page_table"] = self._page_table.copy()
        if not group or params is None:
            return None
        return group, a, echo, params

    def _take_crash(self) -> bool:
        """The test hook, taken by a step that serves a slot (an empty
        step leaves it set, so it always lands on requests in flight)."""
        with self._lock:
            crash, self._crash_next = self._crash_next, False
        return crash

    def _trace_step(self, t0: float, t1: float, n_active: int, tag: str,
                    tokens: int, step_ms: float, sample_ms: float) -> None:
        obs_trace.complete_at("serve/decode_step", t0, t1, cat="serve",
                              n_active=n_active, model=tag, tokens=tokens,
                              step_ms=round(step_ms, 3), sample_ms=round(sample_ms, 3))
        if self.program.tp > 1:
            obs_trace.complete_at("serve/shard_step", t0, t1, cat="serve",
                                  n_active=n_active, shards=int(self.program.tp),
                                  model=tag)

    def _step_once(self) -> bool:
        """One decode step per live version over its slots (the step's
        inputs mask every other slot): no slot ever reads another
        version's parameters."""
        tags = self._ready_tags()
        if not tags:
            return False
        if self._take_crash():
            raise ReplicaCrashError("injected decode-batch crash (test hook)")
        for tag in tags:
            got = self._gather_group(tag)
            if got is None:
                continue
            group, a, echo, params = got
            specs = [self._slots[i].spec for i in group]
            t0 = self.clock()
            kp, vp = self._cache
            _, _, lgs = self.program.step(
                params, kp, vp, self._dev(a["page_table"]), self._dev(a["tokens"]),
                self._dev(a["positions"]), self._dev(a["active"]))
            lgs = lgs[torch.as_tensor(group, device=self.device)]
            t_step = self.clock()
            toks, fin = sample_tokens(
                lgs, [sp.temperature for sp in specs], [sp.top_k for sp in specs],
                [sp.top_p for sp in specs], [sp.seed for sp in specs],
                [int(a["steps"][i]) for i in group], self.program.vocab_size)
            toks_h = toks.cpu().numpy()
            fin_h = fin.cpu().numpy()
            lgs_h = lgs.float().cpu().numpy() if echo else None
            t1 = self.clock()
            self._trace_step(t0, t1, len(group), tag, 1, (t_step - t0) * 1e3,
                             (t1 - t_step) * 1e3)
            self.metrics.inc("decode_steps")
            self.metrics.step_time.record((t1 - t0) * 1e3)
            for j, i in enumerate(group):
                with self._lock:
                    s = self._slots[i]
                if s is not None:
                    s.pos += 1
                    self._record_token(
                        i, int(toks_h[j]), bool(fin_h[j]),
                        lgs_h[j].copy() if (lgs_h is not None and s.logits is not None)
                        else None, t1)
        return True

    def _step_multi(self, a: dict, params):
        """One fused dispatch of ``decode_horizon`` steps: a replay of the
        captured graph on the card (its parameter buffers hold ``params``'
        values, copied in first when they hold another tree's: another
        version's, or the tree that the ``params`` setter or a swap under
        the same tag replaced), the eager ``step_multi`` on the CPU.
        Returns device (toks [H, S], fins [H, S], lgs [H, S, V])."""
        if self.step_multi_graph is not None:
            if self._graph_src is not params:
                for dst, src in zip(_leaves_of(self._graph_params), _leaves_of(params)):
                    dst.copy_(src)
                self._graph_src = params
            return self.step_multi_graph(**a)
        kp, vp = self._cache
        d = {k: self._dev(v) for k, v in a.items()}
        _, _, toks, fins, lgs = self.program.step_multi(
            params, kp, vp, d["page_table"], d["tokens"], d["positions"],
            d["active"], d["temps"], d["top_ks"], d["top_ps"], d["seeds"],
            d["steps"], d["budgets"], d["eos"], self.decode_horizon)
        return toks, fins, lgs

    def _step_fused_once(self) -> bool:
        """One fused dispatch of H = ``decode_horizon`` steps per live
        version; the host syncs once per H tokens.  The H (token, finite)
        pairs replay through ``_record_token`` as H plain steps would: a
        slot that stops mid-horizon frees at the same token and the
        device's overrun after it (routed to the scratch page) is
        dropped.  Host slot state changes only after the dispatch
        returns, so a crash inside the horizon retries from the last
        recorded token."""
        tags = self._ready_tags()
        if not tags:
            return False
        crash = self._take_crash()
        H = self.decode_horizon
        for tag in tags:
            got = self._gather_group(tag, budgets=True)
            if got is None:
                continue
            group, a, echo, params = got
            a["eos"] = np.asarray(self.eos_id if self.eos_id is not None else -1, np.int64)
            t0 = self.clock()
            toks, fins, lgs = self._step_multi(a, params)
            toks_h = toks.cpu().numpy()             # [H, S]
            fins_h = fins.cpu().numpy()
            lgs_h = lgs.float().cpu().numpy() if echo else None
            t1 = self.clock()
            if crash:
                # the device has run H steps, none of them recorded: recovery
                # retries from the last recorded token
                raise ReplicaCrashError("injected decode-batch crash (test hook)")
            self._trace_step(t0, t1, len(group), tag, H, (t1 - t0) * 1e3, 0.0)
            self.metrics.inc("decode_steps")
            self.metrics.inc("fused_dispatches")
            self.metrics.step_time.record((t1 - t0) * 1e3)
            committed = 0
            for i in group:
                for j in range(H):
                    with self._lock:
                        s = self._slots[i]
                    if s is None:
                        break       # stopped mid-horizon; drop the overrun
                    s.pos += 1
                    fin_j = bool(fins_h[j, i])
                    self._record_token(
                        i, int(toks_h[j, i]), fin_j,
                        lgs_h[j, i].copy() if (lgs_h is not None and s.logits is not None)
                        else None, t1)
                    committed += int(fin_j)
            self.metrics.inc("tokens_per_dispatch", committed)
        return True

    def _spec_step_once(self) -> bool:
        """One speculative round per live version: k draft steps propose,
        the target verifies all k+1 rows in one ``spec_step``, and
        rejection sampling commits 1..k+1 tokens a slot.  Rejected rows'
        K/V are overwritten before they can be seen (the next round writes
        from the new position).  After a full acceptance the draft pool is
        one row behind, so a catch-up draft step writes the last
        proposal's row.

        A slot holds pages up to its last token, as the reference's does,
        so a verify row past its budget reads the scratch page, which
        other slots write in the same call.  Such rows commit nothing and
        ``spec_proposed`` / ``spec_accepted`` count only the proposals
        inside the budget, whose rows read the slot's own pages."""
        tags = self._ready_tags()
        if not tags:
            return False
        if self._take_crash():
            raise ReplicaCrashError("injected decode-batch crash (test hook)")
        k = self.speculate_k
        propose, accept = self._spec_fns
        for tag in tags:
            got = self._gather_group(tag, budgets=True)
            if got is None:
                continue
            group, a, echo, params = got
            d = {name: self._dev(v) for name, v in a.items() if name != "budgets"}
            sampling = (d["temps"], d["top_ks"], d["top_ps"], d["seeds"])
            t0 = self.clock()
            dkp, dvp = self._draft_cache
            cur = d["tokens"]
            d_toks, d_probs = [], []
            for j in range(k):
                _, _, dlgs = self._draft_program.step(
                    self._draft_params, dkp, dvp, d["page_table"], cur,
                    d["positions"] + j, d["active"])
                tok, prob = propose(dlgs, *sampling, d["steps"] + j)
                d_toks.append(tok)
                d_probs.append(prob)
                cur = tok
            d_toks_t = torch.stack(d_toks, 1)                      # [S, k]
            spec_tokens = torch.cat([d["tokens"][:, None], d_toks_t], 1)
            kp, vp = self._cache
            tv0 = self.clock()
            _, _, lgs = self.program.spec_step(params, kp, vp, d["page_table"],
                                               spec_tokens, d["positions"], d["active"])
            n_commit, commit, fin = accept(lgs, d_toks_t, torch.stack(d_probs, 1),
                                           *sampling, d["steps"])
            nc_h = n_commit.cpu().numpy()
            cm_h = commit.cpu().numpy()
            fin_h = fin.cpu().numpy()
            d_toks_h = d_toks_t.cpu().numpy()
            lgs_h = lgs.float().cpu().numpy() if echo else None
            t1 = self.clock()
            obs_trace.complete_at("serve/spec_verify", tv0, t1, cat="serve",
                                  n_active=len(group), k=k, model=tag)
            self.metrics.inc("decode_steps")
            self.metrics.step_time.record((t1 - t0) * 1e3)
            self.metrics.inc("spec_steps")
            committed = 0
            catchup = np.zeros((self.max_slots,), bool)
            cu_tok = np.zeros((self.max_slots,), np.int64)
            for i in group:
                c = int(nc_h[i])
                inside = min(k, int(a["budgets"][i]))
                self.metrics.inc("spec_proposed", inside)
                self.metrics.inc("spec_accepted", min(c - 1, inside))
                for j in range(c):
                    with self._lock:
                        s = self._slots[i]
                    if s is None:      # stopped mid-commit (eos / max / ...)
                        break
                    s.pos += 1
                    committed += 1
                    self._record_token(
                        i, int(cm_h[i, j]), bool(fin_h[i]),
                        lgs_h[i, j].copy() if (lgs_h is not None and s.logits is not None)
                        else None, t1)
                with self._lock:
                    alive = self._slots[i] is not None
                if alive and c == k + 1:
                    catchup[i] = True
                    cu_tok[i] = d_toks_h[i, k - 1]
            self.metrics.inc("spec_committed", committed)
            if catchup.any():
                self._draft_program.step(self._draft_params, dkp, dvp, d["page_table"],
                                         self._dev(cu_tok), d["positions"] + k,
                                         self._dev(catchup))
        return True

    # -- per-token bookkeeping ------------------------------------------------------

    def _record_token(self, i: int, token: int, finite: bool,
                      logits_row: Optional[np.ndarray], now: float) -> None:
        s = self._slots[i]
        if s is None:
            return
        if not finite:
            self.metrics.inc("poison_isolated")
            self._scrub_pages(s.page_ids)
            self._finish(i, now, error=PoisonInputError(
                f"decode produced non-finite logits at token {s.n_out} "
                f"(slot {i}) — request isolated, co-batched slots unaffected"))
            return
        s.tokens.append(token)
        s.n_out += 1
        s.last_token = token
        s.t_last = now
        if s.logits is not None and logits_row is not None:
            s.logits.append(logits_row)
        self.metrics.inc("tokens_out")
        if self.eos_id is not None and token == self.eos_id:
            self._finish(i, now, reason="eos")
        elif s.n_out >= s.max_new:
            self._finish(i, now, reason="max_tokens")
        elif now > s.deadline:
            # a mid-decode deadline is a stop condition, not an error
            self._finish(i, now, reason="deadline")

    def _scrub_pages(self, page_ids: List[int]) -> None:
        """Zero pages that may hold non-finite rows before they are
        reused (0 * NaN = NaN would poison the next tenant).  Only a
        slot's private pages: shared prefix pages are read-only to their
        holders and were finite at insert, so a scrub never touches a page
        another request still references."""
        if not page_ids:
            return
        ids = torch.as_tensor(page_ids, device=self.device)
        caches = [self._cache] + ([self._draft_cache] if self._draft_cache else [])
        for cache in caches:
            for pool in cache:
                scrub_pool(pool, ids)

    def _release_slot_locked(self, i: int, s: _Slot, now: float) -> None:
        """Free slot ``i``: its private pages to the free list, its trie
        references decref'd (trie pages stay for the next shared-prefix
        request until LRU eviction), versions nothing holds dropped."""
        self._slots[i] = None
        self._free_pages.extend(s.page_ids)
        for nd in reversed(s.shared_nodes):
            nd.refs -= 1
            nd.last_used = now
        s.shared_nodes = []
        self._page_table[i] = 0
        self._gc_versions_locked()
        self._refresh_gauges_locked()

    def _finish(self, i: int, now: float, reason: Optional[str] = None,
                error: Optional[BaseException] = None) -> None:
        with self._lock:
            s = self._slots[i]
            if s is None:
                return
            self._release_slot_locked(i, s, now)
        if error is not None:
            self.metrics.inc("errors")
            _fail_safe(s.req.future, error)
        else:
            self.metrics.inc({"eos": "eos_stops", "max_tokens": "max_token_stops",
                              "deadline": "deadline_stops"}[reason])
            tpot = ((s.t_last - s.t_first) * 1e3 / (s.n_out - 1)
                    if s.n_out > 1 else None)
            if tpot is not None:
                self.metrics.tpot.record(tpot)
            _set_safe(s.req.future, GenerationResult(
                tokens=list(s.tokens), n_prompt=s.n_prompt, finish_reason=reason,
                model_tag=s.tag, ttft_ms=(s.t_first - s.req.t_submit) * 1e3,
                tpot_ms=tpot,
                logits=np.stack(s.logits) if s.logits else None))
        obs_trace.complete_at("serve/request", s.req.t_submit, now, cat="serve",
                              kind="generate", tokens=s.n_out,
                              finish=reason or "error")

    def _drain_crashed(self, exc: BaseException) -> None:
        """After a crash: reset the pool and the slots, and retry or fail
        every request in flight.  The trie dies with the pool: slots are
        wiped without decref and the trie starts empty, so a retried
        prefix hit matches afresh and nothing is decref'd twice."""
        with self._lock:
            in_flight = [s for s in self._slots if s is not None]
            self._slots = [None] * self.max_slots
            self._free_pages = deque(range(1, self.total_pages))
            self._page_table[:] = 0
            self._prefix_root = _PrefixNode((), None, None)
            self._trie_pages = 0
            self.metrics.set_gauge("shared_pages", 0)
            self._refresh_gauges_locked()
        # a crash (in the middle of a fused horizon too) may have left
        # rows, non-finite ones included, anywhere in the pools
        caches = [self._cache] + ([self._draft_cache] if self._draft_cache else [])
        for cache in caches:
            for pool in cache:
                reset_pool(pool)
        now = self.clock()
        for s in in_flight:
            r = s.req
            r.retries += 1
            if r.retries <= self.max_retries and r.deadline > now \
                    and not r.future.done():
                self.metrics.inc("retries")
                obs_trace.instant("serve/retry", cat="serve", kind="decode",
                                  retries=r.retries)
                self.batcher.requeue_front(r)
            else:
                self.metrics.inc("errors")
                err = ReplicaCrashError(
                    f"decode batch crashed ({type(exc).__name__}: {exc}) after "
                    f"{s.n_out} tokens; retry budget exhausted")
                err.__cause__ = exc
                _fail_safe(r.future, err)

    # -- observability / shutdown ------------------------------------------------

    def _refresh_gauges_locked(self) -> None:
        """The pool gauges (the fleet scores decode sinks by the free
        ones)."""
        active = sum(1 for s in self._slots if s is not None)
        self.metrics.set_gauge("active_slots", active)
        self.metrics.set_gauge("free_slots", self.max_slots - active)
        self.metrics.set_gauge("free_pages", len(self._free_pages))
        self.metrics.set_gauge("pages_in_use",
                               self.total_pages - 1 - len(self._free_pages))

    def metrics_snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        with self._lock:
            snap["model"] = self._serve_tag
            snap["versions"] = sorted(self._versions)
            snap["models"] = {"": self._serve_tag, **self._model_tags}
            snap["free_pages"] = len(self._free_pages)
            snap["free_slots"] = sum(1 for s in self._slots if s is None)
        if self.tenants is not None:
            snap["tenants"] = self.tenants.snapshot()
        snap["queue_depth"] = self.batcher.qsize()
        snap["compile_cache_size"] = self.compile_cache_size()
        snap["prompt_buckets"] = list(self.prompt_buckets)
        snap["max_slots"] = self.max_slots
        snap["total_pages"] = self.total_pages
        snap["pages_per_slot"] = self.program.pages_per_slot
        snap["prefix_cache"] = self._prefix_on
        snap["speculate_k"] = self.speculate_k if self._draft_program is not None else 0
        snap["kv_dtype"] = self._kv_dtype or "float32"
        snap["role"] = self.role
        snap["decode_horizon"] = self.decode_horizon
        snap["prefill_chunk"] = self.prefill_chunk
        snap["device"] = str(self.device)
        snap["tp"] = int(self.program.tp)
        return snap

    def health_snapshot(self) -> dict:
        """Readiness: loaded, not shut down, and the decode loop alive."""
        with self._lock:
            t = self._thread
            ready = (self._loaded and not self._shutdown
                     and t is not None and t.is_alive())
        return {"status": "ready" if ready else "unready", "ready": ready,
                "kind": "decode", "model": self.current_tag}

    def begin_drain(self) -> None:
        """Stop admission (new submissions shed: ``OverloadedError``, HTTP
        429) while queued and in-flight generations complete."""
        self.batcher.begin_drain()
        self.metrics.inc("drains")
        obs_trace.instant("serve/drain", cat="serve")

    def shutdown(self) -> None:
        """Idempotent; every queued and in-flight future resolves."""
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            self._generation += 1
            in_flight = [s for s in self._slots if s is not None]
            self._slots = [None] * self.max_slots
        self._stop.set()
        self.batcher.close(fail_pending=True)
        for s in in_flight:
            _fail_safe(s.req.future, RuntimeError("serving engine is shut down"))
        for t in (self._thread, self._supervisor):
            if t is not None and t is not threading.current_thread():
                t.join(timeout=30)
        if self.step_multi_graph is not None:
            self.step_multi_graph.release()
