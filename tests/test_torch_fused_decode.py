"""The port's host-overhead features of the decode engine: fused
multi-step decode (``decode_horizon``), chunked prefill
(``prefill_chunk``), the batcher's token-budget admission, and
crash-retry (``max_retries``), with their construction checks.

The same small LM as ``test_torch_decode_speed.py`` (vocab 61, 2 blocks,
d_model 32, 2 heads, max_len 64, pages of 8), built in JAX and loaded
into the port.  Fused, chunked and crash-retried engines must give the
port's plain engine's tokens and BITWISE its echoed logits (the same
per-row math in another grouping), and the reference's plain engine's
tokens; they are never held to the reference's fused or chunked engines.
On the CPU the fused horizon is the eager ``step_multi`` (the CUDA graph
of it is a card test in ``test_torch_cuda.py``).
"""

import numpy as np
import pytest

from deeplearning4j_tpu.models.transformer import TransformerDecodeAdapter as JAdapter
from deeplearning4j_tpu.models.transformer import TransformerLM as JLM
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.utils.serializer import save_model as j_save
from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
from deeplearning4j_tpu_torch.serving import (ContinuousBatcher, DecodeEngine,
                                              ReplicaCrashError)
from deeplearning4j_tpu_torch.utils.serializer import load_model

VOCAB, MAXLEN, PAGE = 61, 64, 8
SIZE = dict(vocab_size=VOCAB, n_layers=2, d_model=32, n_heads=2, max_len=MAXLEN)
PROMPT_LENS = (3, 9, 17, 30, 40)
SPECS = [dict(temperature=0.0), dict(temperature=0.8, top_k=10, seed=7),
         dict(temperature=0.0), dict(temperature=1.0, top_p=0.9, seed=3),
         dict(temperature=0.7, seed=11)]
MAX_NEW = (7, 11, 9, 13, 5)          # budgets that are no multiple of H


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jn = JLM(**SIZE)
    path = str(tmp_path_factory.mktemp("ckpt") / "lm.zip")
    j_save(jn, path)
    return jn, TransformerDecodeAdapter(load_model(path, device="cpu"))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, VOCAB, n).tolist() for n in PROMPT_LENS]


def _engine(adapter, **kw):
    kw = {"max_slots": 3, "page_size": PAGE, **kw}
    return DecodeEngine(adapter, device="cpu", **kw).load()


def _serve(engine, prompts, echo=True):
    futs = [engine.generate_async(p, max_new_tokens=n, echo_logits=echo, **kw)
            for p, n, kw in zip(prompts, MAX_NEW, SPECS)]
    return [f.result(timeout=120) for f in futs]


def _run(adapter, prompts, **kw):
    eng = _engine(adapter, **kw)
    try:
        return _serve(eng, prompts), eng.metrics_snapshot()
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def plain(models, prompts):
    return _run(models[1], prompts)[0]


@pytest.fixture(scope="module")
def reference(models, prompts):
    eng = JEngine(JAdapter(models[0]), max_slots=3, page_size=PAGE).load()
    try:
        return [r.tokens for r in _serve(eng, prompts, echo=False)]
    finally:
        eng.shutdown()


def _assert_same(results, plain, reference):
    for r, p, ref in zip(results, plain, reference):
        assert r.tokens == p.tokens == ref
        assert r.finish_reason == p.finish_reason
        np.testing.assert_array_equal(r.logits, p.logits)


# -- construction -------------------------------------------------------------------


_BAD = [dict(decode_horizon=0), dict(prefill_chunk=0),
        dict(decode_horizon=2, draft_model="self"), dict(prefill_chunk=8, draft_model="self"),
        dict(kv_dtype="bf16"), dict(max_slots=0)]


@pytest.mark.parametrize("kw", _BAD, ids=["horizon0", "chunk0", "horizon_x_draft",
                                          "chunk_x_draft", "kv_dtype", "slots0"])
def test_construction_checks(models, kw):
    adapter = models[1]
    kw = {k: adapter if v == "self" else v for k, v in kw.items()}
    with pytest.raises(ValueError):
        DecodeEngine(adapter, page_size=PAGE, device="cpu", **kw)


def test_features_need_the_program_entry_points(models):
    adapter = models[1]

    class Bare:
        params = adapter.params

        def decode_program(self, **kw):
            return adapter.decode_program(**kw)._replace(prefill_at=None, step_multi=None,
                                                         spec_step=None)

    for kw, what in ((dict(prefix_cache=True), "prefill_at"),
                     (dict(prefill_chunk=8), "prefill_at"),
                     (dict(decode_horizon=2), "step_multi"),
                     (dict(draft_model=adapter), "spec_step")):
        with pytest.raises(ValueError, match=what):
            DecodeEngine(Bare(), page_size=PAGE, device="cpu", **kw)


# -- fused multi-step decode ------------------------------------------------------------


@pytest.mark.parametrize("horizon", [2, 4])
def test_fused_horizon_is_bitwise_the_plain_engine(models, prompts, plain, reference, horizon):
    results, snap = _run(models[1], prompts, decode_horizon=horizon)
    _assert_same(results, plain, reference)
    c = snap["counters"]
    assert snap["decode_horizon"] == horizon and snap["pages_in_use"] == 0
    assert c["fused_dispatches"] == c["decode_steps"] > 0
    # the first token of each request comes from its prefill
    assert c["tokens_per_dispatch"] == sum(MAX_NEW) - len(MAX_NEW)


def test_fused_horizon_eos_stop(models, prompts, plain):
    eos = plain[0].tokens[3]                # the greedy request's fourth token
    stop = plain[0].tokens.index(eos) + 1
    for horizon in (1, 4):
        eng = _engine(models[1], decode_horizon=horizon, eos_id=eos)
        try:
            r = eng.generate(prompts[0], max_new_tokens=MAX_NEW[0], echo_logits=True)
            assert eng.metrics_snapshot()["pages_in_use"] == 0
        finally:
            eng.shutdown()
        assert r.finish_reason == "eos" and r.tokens == plain[0].tokens[:stop]
        np.testing.assert_array_equal(r.logits, plain[0].logits[:stop])


# -- chunked prefill -----------------------------------------------------------------


@pytest.mark.parametrize("chunk,page", [(8, PAGE), (17, PAGE), (64, PAGE), (12, 8),
                                        (12, 16)],
                         ids=["below", "at_a_prompt", "past_every_prompt", "chunk12_page8",
                              "chunk12_page16"])
def test_chunked_prefill_is_bitwise_the_plain_engine(models, prompts, plain, reference,
                                                     chunk, page):
    if page != PAGE:
        plain = _run(models[1], prompts, page_size=page)[0]
    results, snap = _run(models[1], prompts, prefill_chunk=chunk, page_size=page)
    _assert_same(results, plain, reference)
    c = snap["counters"]
    assert c["prefill_chunks"] == sum(-(-n // chunk) for n in PROMPT_LENS)
    assert c["chunked_prefills"] == sum(n > chunk for n in PROMPT_LENS)
    assert c["prefills"] == len(PROMPT_LENS) and snap["prefill_chunk"] == chunk


def test_chunked_prefill_with_the_prefix_cache(models, plain, reference, prompts):
    shared = prompts[4][:32]                # four full pages
    eng = _engine(models[1], prefill_chunk=12, prefix_cache=True)
    try:
        first = _serve(eng, [shared + [5]])[0]
        res = eng.generate(shared + [6, 7], max_new_tokens=9, echo_logits=True)
        snap = eng.metrics_snapshot()
        st = eng._debug_page_state()
    finally:
        eng.shutdown()
    base = _engine(models[1])
    try:
        want = [base.generate(p, max_new_tokens=n, echo_logits=True)
                for p, n in ((shared + [5], MAX_NEW[0]), (shared + [6, 7], 9))]
    finally:
        base.shutdown()
    for r, w in zip((first, res), want):
        assert r.tokens == w.tokens
        np.testing.assert_array_equal(r.logits, w.logits)
    c = snap["counters"]
    assert c["prefix_hits"] == 1 and c["prefix_hit_tokens"] == 32
    # the hit prefills only its 2-token suffix: one chunk, at offset 32
    assert c["prefill_chunks"] == 3 + 1 and c["chunked_prefills"] == 1
    assert len(st["trie"]) == 4 and snap["shared_pages"] == 4


def test_admit_token_budget_rule():
    b = ContinuousBatcher(max_batch=8, slo_ms=10_000)

    class P:
        def __init__(self, n):
            self.prompt = list(range(n))

    for n in (30, 5, 4, 40, 1):
        b.submit_request(P(n))
    got = b.admit(8, token_budget=10)
    assert [len(r.payload.prompt) for r in got] == [30]       # the head always
    got = b.admit(8, token_budget=10)
    assert [len(r.payload.prompt) for r in got] == [5, 4]     # 9 <= 10, 49 > 10
    got = b.admit(1, token_budget=100)
    assert [len(r.payload.prompt) for r in got] == [40]       # the slot limit
    b.submit_request("no prompt")                              # costs nothing
    got = b.admit(8, token_budget=1)
    assert [getattr(r.payload, "prompt", r.payload) for r in got] == [[0], "no prompt"]
    b.submit_request(P(3))
    assert len(b.admit(8)) == 1                                # no budget: no limit
    b.close()


# -- crash-retry ---------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(decode_horizon=4), dict(prefill_chunk=8)],
                         ids=["plain", "fused", "chunked"])
def test_crash_retry_is_identical_to_the_plain_engine(models, prompts, plain, reference, kw):
    eng = _engine(models[1], **kw)
    try:
        futs = [eng.generate_async(p, max_new_tokens=n, echo_logits=True, **s)
                for p, n, s in zip(prompts, MAX_NEW, SPECS)]
        with eng._lock:
            eng._crash_next = True
        results = [f.result(timeout=120) for f in futs]
        snap = eng.metrics_snapshot()
    finally:
        eng.shutdown()
    _assert_same(results, plain, reference)
    c = snap["counters"]
    assert c["replica_crashes"] == 1 and c["retries"] >= 1 and c["errors"] == 0
    assert snap["pages_in_use"] == 0


def test_no_retries_fails_in_flight_and_keeps_serving(models, prompts, plain):
    eng = _engine(models[1], max_retries=0, decode_horizon=2)
    try:
        futs = [eng.generate_async(p, max_new_tokens=n, echo_logits=True, **s)
                for p, n, s in zip(prompts, MAX_NEW, SPECS)]
        with eng._lock:
            eng._crash_next = True
        outcomes = []
        for f in futs:
            try:
                outcomes.append(f.result(timeout=120))
            except ReplicaCrashError as e:
                outcomes.append(e)
        after = eng.generate(prompts[2], max_new_tokens=MAX_NEW[2], echo_logits=True)
        snap = eng.metrics_snapshot()
    finally:
        eng.shutdown()
    failed = [o for o in outcomes if isinstance(o, ReplicaCrashError)]
    assert 1 <= len(failed) <= 3 and "retry budget exhausted" in str(failed[0])
    for o, p in zip(outcomes, plain):
        if not isinstance(o, ReplicaCrashError):
            assert o.tokens == p.tokens
    assert after.tokens == plain[2].tokens
    np.testing.assert_array_equal(after.logits, plain[2].logits)
    c = snap["counters"]
    assert c["retries"] == 0 and c["errors"] == len(failed) and snap["pages_in_use"] == 0


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_supervisor_respawns_a_dead_loop(models, prompts, plain):
    eng = _engine(models[1])
    try:
        eng.generate(prompts[0], max_new_tokens=2)
        old = eng._thread
        killed = []

        def die_once():
            if not killed:
                killed.append(True)
                raise SystemExit("decode loop killed")  # the loop's handler lets it through
            return DecodeEngine._admit_some(eng)

        eng._admit_some = die_once
        old.join(timeout=30)
        assert not old.is_alive() and killed
        r = eng.generate(prompts[2], max_new_tokens=MAX_NEW[2])
        c = eng.metrics_snapshot()["counters"]
    finally:
        eng.shutdown()
    assert eng._thread is not old and r.tokens == plain[2].tokens
    assert c["replica_respawns"] == 1 and c["replica_crashes"] == 1
