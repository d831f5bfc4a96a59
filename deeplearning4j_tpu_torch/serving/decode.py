"""Autoregressive decode engine: paged KV-cache + continuous batching
(mirrors the single-engine ``DecodeEngine`` of
``deeplearning4j_tpu/serving/decode.py``).

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

Sampling is greedy / temperature / top-k / top-p, seeded and
counter-based (``ops.sampling``): the draw for token n of a request is
keyed ``fold_in(PRNGKey(seed), n)``, bit-exact with the reference's.

Decode features, each off by default:

  fused multi-step decode (``decode_horizon=H``)
      H decode steps with on-device sampling in one dispatch
      (``DecodeProgram.step_multi``); on the card it is one replay of a
      CUDA graph captured at ``load()`` (``serving.cuda_graphs``), on
      the CPU the eager ``step_multi``.  Host slot state changes only
      after the dispatch returns; the H (token, finite) pairs replay
      through the per-token bookkeeping and the overrun after a stop is
      dropped, so tokens and logits are bitwise H plain steps'.
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
      snapshot reports ``tp``.

Not ported here: tenant lanes, hot-swap and named models, the
prefill/decode roles and page transfer, warm bundles, autoscaling and
trace spans.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.kv_cache import alloc_cache, pages_for, reset_pool, scrub_pool
from ..ops.sampling import (filtered_logits, fold_in, gumbel_from_key, prng_key,
                            sample_tokens, uniform)
from ..utils.device import DeviceLike, resolve_device
from .batcher import ContinuousBatcher, pow2_buckets
from .engine import PoisonInputError, ReplicaCrashError, _fail_safe, _set_safe
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


class _Slot:
    """Host-side state of one occupied decode slot.  ``page_ids`` are the
    slot's private pages (freed at finish); ``shared_nodes`` the
    prefix-trie nodes it holds a reference on: the first ``n_matched``
    attached at admission, the rest pages its own prefill inserted."""

    __slots__ = ("req", "spec", "page_ids", "n_prompt", "pos",
                 "last_token", "tokens", "n_out", "max_new", "deadline",
                 "t_first", "t_last", "logits", "shared_nodes", "n_matched",
                 "n_prefilled")

    def __init__(self, req, page_ids: List[int], max_new: int):
        self.req = req
        self.spec = req.payload
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


class DecodeEngine:
    """``DecodeEngine(adapter).load()`` then ``generate(prompt_ids, ...)``.

    ``model`` provides ``decode_program()`` and ``params``
    (``models.TransformerDecodeAdapter``).  ``device`` defaults to
    ``cuda``.  The feature arguments and their checks are the
    reference's: ``max_retries``, ``decode_horizon``, ``prefill_chunk``,
    ``kv_dtype``, ``prefix_cache``, ``draft_model`` and ``speculate_k``
    (see the module docstring)."""

    def __init__(self, model, *, max_slots: int = 4, page_size: int = 16,
                 max_len: Optional[int] = None,
                 total_pages: Optional[int] = None,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, slo_ms: float = 30_000.0,
                 max_queue: int = 256, admission: str = "block",
                 max_retries: int = 1, default_max_new: int = 32,
                 prefix_cache: bool = False, draft_model=None,
                 speculate_k: int = 4, kv_dtype: Optional[str] = None,
                 decode_horizon: int = 1, prefill_chunk: Optional[int] = None,
                 tag: str = "v0", device: DeviceLike = None):
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
        if prefill_chunk is not None and draft_model is not None:
            raise ValueError(
                "chunked prefill + speculative decoding is unsupported "
                "(the draft pool's mirror prefill is not chunked)")
        if kv_dtype not in (None, "f32", "float32", "int8", "i8"):
            raise ValueError(f"kv_dtype {kv_dtype!r} not supported "
                             "(float32 or int8)")
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
        self.total_pages = int(total_pages if total_pages is not None
                               else 1 + self.max_slots * prog.pages_per_slot)
        if self.total_pages < 1 + prog.pages_per_slot:
            raise ValueError(
                f"total_pages {self.total_pages} cannot hold even one "
                f"full-length request ({prog.pages_per_slot} pages) plus "
                "the scratch page")
        self.metrics = DecodeMetrics()
        self.batcher = ContinuousBatcher(
            max_batch=self.max_slots, slo_ms=slo_ms, max_queue=max_queue,
            admission=admission, metrics=self.metrics)
        buckets = sorted(set(int(b) for b in (prompt_buckets
                                              or pow2_buckets(prog.max_len))))
        self.prompt_buckets = [b for b in buckets if 0 < b <= prog.max_len]
        if not self.prompt_buckets:
            raise ValueError(f"no prompt bucket <= max_len {prog.max_len}: {buckets}")
        self.max_prompt = min(self.prompt_buckets[-1], prog.max_len - 1)
        self.params = _to_device(getattr(model, "params", model), self.device)
        self._serve_tag = tag
        self._slots: List[Optional[_Slot]] = [None] * self.max_slots
        self._page_table = np.zeros((self.max_slots, prog.pages_per_slot), np.int64)
        self._free_pages = deque(range(1, self.total_pages))
        self._cache = None
        self.step_multi_graph = None     # serving.cuda_graphs.StepMultiGraph on cuda
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._loaded = False
        self._shutdown = False
        self._generation = 0
        self._chunk_cursor = 0     # round-robin over chunked prefills
        self._crash_next = False   # test hook: raise inside the next step
        self._thread: Optional[threading.Thread] = None
        self._supervisor: Optional[threading.Thread] = None

    # -- load ----------------------------------------------------------------

    def load(self) -> "DecodeEngine":
        """Allocate the page pool (and the draft's) on the device, capture
        the fused horizon's CUDA graph on a card, and start the decode
        loop and its supervisor."""
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
        if self.decode_horizon > 1 and self.device.type == "cuda":
            from .cuda_graphs import StepMultiGraph
            self.step_multi_graph = StepMultiGraph(prog, self.params, self._cache,
                                                   self.max_slots, self.decode_horizon,
                                                   self.device)
        with self._lock:
            self._refresh_gauges_locked()
        self._loaded = True
        self._start_loop()
        self._supervisor = threading.Thread(target=self._supervise,
                                            name="decode-supervisor", daemon=True)
        self._supervisor.start()
        return self

    # -- request path ----------------------------------------------------------

    def generate_async(self, prompt_ids, *, max_new_tokens: Optional[int] = None,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0, seed: int = 0,
                       slo_ms: Optional[float] = None,
                       deadline: Optional[float] = None,
                       echo_logits: bool = False) -> Future:
        """Enqueue one generation; the Future resolves to a
        ``GenerationResult`` (or a typed serving error)."""
        if not self._loaded:
            raise RuntimeError("DecodeEngine.load() must run before generate")
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
        return self.batcher.submit_request(spec, slo_ms=slo_ms, deadline=deadline)

    def generate(self, prompt_ids, **kw) -> GenerationResult:
        """Blocking ``generate_async``."""
        return self.generate_async(prompt_ids, **kw).result()

    # -- the loop and its supervisor ---------------------------------------------

    def _start_loop(self) -> None:
        with self._lock:
            self._generation += 1
            gen = self._generation
            self._thread = threading.Thread(target=self._loop, args=(gen,),
                                            name=f"decode-loop-{gen}", daemon=True)
            self._thread.start()

    def _supervise(self) -> None:
        """Respawn the decode loop if it dies outright (a crash its own
        handler could not absorb); its requests are retried or failed,
        never stranded."""
        while not self._stop.wait(0.05):
            with self._lock:
                if self._shutdown:
                    return
                t = self._thread
            if t is not None and not t.is_alive():
                self.metrics.inc("replica_crashes")
                self._drain_crashed(ReplicaCrashError("decode loop thread died"))
                with self._lock:
                    if self._shutdown:
                        return
                self.metrics.inc("replica_respawns")
                self._start_loop()

    def _loop(self, gen: int) -> None:
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
        cache is on), then the prefill and the first token (or, with
        chunked prefill, the chunk loop later).  Stops at the first
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
            need_total = pages_for(min(int(spec.prompt.shape[0]) + spec.max_new,
                                       prog.max_len), prog.page_size)
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
                now = time.monotonic()
                for nd in matched:
                    nd.refs += 1
                    nd.last_used = now
                ids = [self._free_pages.popleft() for _ in range(need)]
                self._page_table[i] = 0
                self._page_table[i, :m] = [nd.page_id for nd in matched]
                self._page_table[i, m:m + need] = ids
                slot = _Slot(r, ids, spec.max_new)
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
            self.metrics.inc("requests")
            if self.prefill_chunk is not None:
                # the chunk loop prefills it; not stepped until its last
                # chunk samples token 0
                slot.n_prefilled = m * prog.page_size
            else:
                self._prefill_slot(i)
            worked = True
        for r in reversed(leftovers):
            self.batcher.requeue_front(r)
        return worked

    def _bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        return self.prompt_buckets[-1]

    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prefill_rows(self, i: int, offset: int, take: int):
        """Prefill prompt tokens offset..offset+take-1 of slot ``i`` (the
        whole prompt through ``prefill``, else ``prefill_at``) into the
        target pool and, when speculating, the draft pool; returns the
        last row's logits [V]."""
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

        lg = run(self.program, self.params, self._cache)
        if self._draft_program is not None:
            # mirror the prompt into the draft pool (same page ids)
            run(self._draft_program, self._draft_params, self._draft_cache)
        return lg

    def _first_token(self, i: int, lg: torch.Tensor) -> None:
        """The end of a prefill: sample token 0, record TTFT, insert the
        prompt's pages into the trie, record the token."""
        s = self._slots[i]
        spec = s.spec
        tok, fin = sample_tokens(lg[None], [spec.temperature], [spec.top_k],
                                 [spec.top_p], [spec.seed], [0],
                                 self.program.vocab_size)
        tok_h, fin_h = int(tok[0]), bool(fin[0])
        lg_h = lg.float().cpu().numpy() if spec.echo_logits else None
        t1 = time.monotonic()
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
        self._first_token(i, self._prefill_rows(i, m, s.n_prompt - m))

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
        lg = self._prefill_rows(i, p, take)
        self.metrics.inc("prefill_chunks")
        if p + take < n:
            s.n_prefilled = p + take
            return True
        if p > s.n_matched * self.program.page_size:
            self.metrics.inc("chunked_prefills")   # took two chunks or more
        s.n_prefilled = None
        self._first_token(i, lg)
        return True

    # -- decode steps --------------------------------------------------------------

    def _gather_group(self, budgets: bool = False):
        """The slots a step serves (occupied and done prefilling) and their
        inputs as host arrays over every slot; None when there are none."""
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
            for i, s in enumerate(self._slots):
                if s is None or s.n_prefilled is not None:
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
        return (group, a, echo) if group else None

    def _take_crash(self) -> bool:
        """The test hook, taken by a step that serves a slot (an empty
        step leaves it set, so it always lands on requests in flight)."""
        with self._lock:
            crash, self._crash_next = self._crash_next, False
        return crash

    def _step_once(self) -> bool:
        """One decode step over every slot that holds a request."""
        got = self._gather_group()
        if got is None:
            return False
        if self._take_crash():
            raise ReplicaCrashError("injected decode-batch crash (test hook)")
        group, a, echo = got
        specs = [self._slots[i].spec for i in group]
        t0 = time.monotonic()
        kp, vp = self._cache
        _, _, lgs = self.program.step(
            self.params, kp, vp, self._dev(a["page_table"]), self._dev(a["tokens"]),
            self._dev(a["positions"]), self._dev(a["active"]))
        lgs = lgs[torch.as_tensor(group, device=self.device)]
        toks, fin = sample_tokens(
            lgs, [sp.temperature for sp in specs], [sp.top_k for sp in specs],
            [sp.top_p for sp in specs], [sp.seed for sp in specs],
            [int(a["steps"][i]) for i in group], self.program.vocab_size)
        toks_h = toks.cpu().numpy()
        fin_h = fin.cpu().numpy()
        lgs_h = lgs.float().cpu().numpy() if echo else None
        t1 = time.monotonic()
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

    def _step_multi(self, a: dict):
        """One fused dispatch of ``decode_horizon`` steps: a replay of the
        captured graph on the card, the eager ``step_multi`` on the CPU.
        Returns device (toks [H, S], fins [H, S], lgs [H, S, V])."""
        if self.step_multi_graph is not None:
            return self.step_multi_graph(**a)
        kp, vp = self._cache
        d = {k: self._dev(v) for k, v in a.items()}
        _, _, toks, fins, lgs = self.program.step_multi(
            self.params, kp, vp, d["page_table"], d["tokens"], d["positions"],
            d["active"], d["temps"], d["top_ks"], d["top_ps"], d["seeds"],
            d["steps"], d["budgets"], d["eos"], self.decode_horizon)
        return toks, fins, lgs

    def _step_fused_once(self) -> bool:
        """One fused dispatch of H = ``decode_horizon`` steps; the host
        syncs once per H tokens.  The H (token, finite) pairs replay
        through ``_record_token`` as H plain steps would: a slot that
        stops mid-horizon frees at the same token and the device's
        overrun after it (routed to the scratch page) is dropped.  Host
        slot state changes only after the dispatch returns, so a crash
        inside the horizon retries from the last recorded token."""
        got = self._gather_group(budgets=True)
        if got is None:
            return False
        crash = self._take_crash()
        group, a, echo = got
        a["eos"] = np.asarray(self.eos_id if self.eos_id is not None else -1, np.int64)
        H = self.decode_horizon
        t0 = time.monotonic()
        toks, fins, lgs = self._step_multi(a)
        toks_h = toks.cpu().numpy()             # [H, S]
        fins_h = fins.cpu().numpy()
        lgs_h = lgs.float().cpu().numpy() if echo else None
        t1 = time.monotonic()
        if crash:
            # the device has run H steps, none of them recorded: recovery
            # retries from the last recorded token
            raise ReplicaCrashError("injected decode-batch crash (test hook)")
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
        """One speculative round: k draft steps propose, the target
        verifies all k+1 rows in one ``spec_step``, and rejection sampling
        commits 1..k+1 tokens a slot.  Rejected rows' K/V are overwritten
        before they can be seen (the next round writes from the new
        position).  After a full acceptance the draft pool is one row
        behind, so a catch-up draft step writes the last proposal's row.

        A slot holds pages up to its last token, as the reference's does,
        so a verify row past its budget reads the scratch page, which
        other slots write in the same call.  Such rows commit nothing and
        ``spec_proposed`` / ``spec_accepted`` count only the proposals
        inside the budget, whose rows read the slot's own pages."""
        got = self._gather_group(budgets=True)
        if got is None:
            return False
        if self._take_crash():
            raise ReplicaCrashError("injected decode-batch crash (test hook)")
        group, a, echo = got
        k = self.speculate_k
        propose, accept = self._spec_fns
        d = {name: self._dev(v) for name, v in a.items() if name != "budgets"}
        sampling = (d["temps"], d["top_ks"], d["top_ps"], d["seeds"])
        t0 = time.monotonic()
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
        _, _, lgs = self.program.spec_step(self.params, kp, vp, d["page_table"],
                                           spec_tokens, d["positions"], d["active"])
        n_commit, commit, fin = accept(lgs, d_toks_t, torch.stack(d_probs, 1),
                                       *sampling, d["steps"])
        nc_h = n_commit.cpu().numpy()
        cm_h = commit.cpu().numpy()
        fin_h = fin.cpu().numpy()
        d_toks_h = d_toks_t.cpu().numpy()
        lgs_h = lgs.float().cpu().numpy() if echo else None
        t1 = time.monotonic()
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

    def _finish(self, i: int, now: float, reason: Optional[str] = None,
                error: Optional[BaseException] = None) -> None:
        with self._lock:
            s = self._slots[i]
            if s is None:
                return
            self._slots[i] = None
            self._free_pages.extend(s.page_ids)
            for nd in reversed(s.shared_nodes):
                # decref, never free: trie pages stay for the next
                # shared-prefix request until LRU eviction
                nd.refs -= 1
                nd.last_used = now
            s.shared_nodes = []
            self._page_table[i] = 0
            self._refresh_gauges_locked()
        if error is not None:
            self.metrics.inc("errors")
            _fail_safe(s.req.future, error)
            return
        self.metrics.inc({"eos": "eos_stops", "max_tokens": "max_token_stops",
                          "deadline": "deadline_stops"}[reason])
        tpot = ((s.t_last - s.t_first) * 1e3 / (s.n_out - 1)
                if s.n_out > 1 else None)
        if tpot is not None:
            self.metrics.tpot.record(tpot)
        _set_safe(s.req.future, GenerationResult(
            tokens=list(s.tokens), n_prompt=s.n_prompt, finish_reason=reason,
            model_tag=self._serve_tag, ttft_ms=(s.t_first - s.req.t_submit) * 1e3,
            tpot_ms=tpot,
            logits=np.stack(s.logits) if s.logits else None))

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
        now = time.monotonic()
        for s in in_flight:
            r = s.req
            r.retries += 1
            if r.retries <= self.max_retries and r.deadline > now \
                    and not r.future.done():
                self.metrics.inc("retries")
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
        active = sum(1 for s in self._slots if s is not None)
        self.metrics.set_gauge("active_slots", active)
        self.metrics.set_gauge("free_slots", self.max_slots - active)
        self.metrics.set_gauge("free_pages", len(self._free_pages))
        self.metrics.set_gauge("pages_in_use",
                               self.total_pages - 1 - len(self._free_pages))

    @property
    def current_tag(self) -> str:
        with self._lock:
            return self._serve_tag

    def metrics_snapshot(self) -> dict:
        snap = self.metrics.snapshot()
        snap["model"] = self.current_tag
        snap["queue_depth"] = self.batcher.qsize()
        snap["prompt_buckets"] = list(self.prompt_buckets)
        snap["max_slots"] = self.max_slots
        snap["total_pages"] = self.total_pages
        snap["pages_per_slot"] = self.program.pages_per_slot
        snap["prefix_cache"] = self._prefix_on
        snap["speculate_k"] = self.speculate_k if self._draft_program is not None else 0
        snap["kv_dtype"] = self._kv_dtype or "float32"
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
