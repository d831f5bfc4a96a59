"""The port's decode path (paged KV cache, deterministic attention, the
plain ``DecodeEngine``, the CLI) against the JAX package's.

The same small LM (vocab 64, 2 blocks, d_model 64, 4 heads, max_len 64)
serves 4 co-batched prompts, two greedy and two seeded at temperature
> 0, in both engines: the tokens must be identical and the echoed
logits, the prefill row first, agree at atol 1e-5 (f32, sums in another
order).  Within the port, decode logits are bitwise the re-encode logits
(the reference's contract), on the CPU as on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import TransformerDecodeAdapter as JAdapter
from deeplearning4j_tpu.models.transformer import TransformerLM as JLM
from deeplearning4j_tpu.ops import kv_cache as jkv
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving.batcher import pow2_buckets as j_pow2_buckets
from deeplearning4j_tpu.utils.serializer import save_model as j_save
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
from deeplearning4j_tpu_torch.ops import kv_cache as tkv
from deeplearning4j_tpu_torch.serving import (
    ContinuousBatcher, DeadlineExceededError, DecodeEngine, OverloadedError,
    pow2_buckets,
)
from deeplearning4j_tpu_torch.utils.serializer import load_model

SIZE = dict(vocab_size=64, n_layers=2, d_model=64, n_heads=4, max_len=64)
PROMPT_LENS = (3, 9, 17, 30)
SPECS = [dict(temperature=0.0), dict(temperature=0.8, top_k=10, seed=7),
         dict(temperature=0.0), dict(temperature=1.0, top_p=0.9, seed=3)]
MAX_NEW = 12


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jn = JLM(**SIZE)
    path = str(tmp_path_factory.mktemp("ckpt") / "lm.zip")
    j_save(jn, path)
    return jn, load_model(path, device="cpu"), path


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, SIZE["vocab_size"], n).tolist() for n in PROMPT_LENS]


def _serve(engine, prompts):
    futs = [engine.generate_async(p, max_new_tokens=MAX_NEW, echo_logits=True, **kw)
            for p, kw in zip(prompts, SPECS)]
    return [f.result(timeout=300) for f in futs]


@pytest.fixture(scope="module")
def jax_results(models, prompts):
    eng = JEngine(JAdapter(models[0]), max_slots=4, page_size=8).load()
    try:
        return _serve(eng, prompts)
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def port_run(models, prompts):
    eng = DecodeEngine(TransformerDecodeAdapter(models[1]), max_slots=4,
                       page_size=8, device="cpu").load()
    try:
        results = _serve(eng, prompts)
        snap = eng.metrics_snapshot()
    finally:
        eng.shutdown()
    return eng, results, snap


# -- the engine against the JAX engine ----------------------------------------------


def test_tokens_identical_to_jax_engine(jax_results, port_run):
    _, results, _ = port_run
    for j, t in zip(jax_results, results):
        assert t.tokens == j.tokens
        assert t.finish_reason == j.finish_reason == "max_tokens"
        assert t.n_prompt == j.n_prompt


def test_prefill_and_step_logits_match_jax_engine(jax_results, port_run):
    _, results, _ = port_run
    for j, t in zip(jax_results, results):
        assert t.logits.shape == j.logits.shape == (MAX_NEW, SIZE["vocab_size"])
        np.testing.assert_allclose(t.logits[0], j.logits[0], atol=1e-5, rtol=0)
        np.testing.assert_allclose(t.logits, j.logits, atol=1e-5, rtol=0)


def test_greedy_tokens_are_the_reencode_argmax(port_run, prompts):
    eng, results, _ = port_run
    for p, r, kw in zip(prompts, results, SPECS):
        seq = torch.tensor([p + r.tokens[:-1]])
        with torch.inference_mode():
            ref = eng.program.reencode(eng.params, seq)[0, len(p) - 1:].numpy()
        np.testing.assert_array_equal(r.logits, ref)
        if kw["temperature"] == 0.0:
            assert ref.argmax(-1).tolist() == r.tokens


def test_metrics_and_pool_drain(port_run):
    _, results, snap = port_run
    assert snap["pages_in_use"] == 0 and snap["active_slots"] == 0
    c = snap["counters"]
    assert c["requests"] == c["prefills"] == 4
    assert c["tokens_out"] == 4 * MAX_NEW and c["max_token_stops"] == 4
    assert snap["ttft_ms"]["count"] == 4 and snap["tpot_ms"]["count"] == 4
    assert all(r.ttft_ms > 0 and r.tpot_ms > 0 for r in results)


def test_eos_stop_frees_pages(models, prompts, port_run):
    eos = port_run[1][0].tokens[2]          # the greedy request's third token
    eng = DecodeEngine(TransformerDecodeAdapter(models[1]), max_slots=2,
                       page_size=8, eos_id=eos, device="cpu").load()
    try:
        r = eng.generate(prompts[0], max_new_tokens=MAX_NEW)
        assert r.finish_reason == "eos" and r.tokens[-1] == eos
        assert r.tokens == port_run[1][0].tokens[:r.tokens.index(eos) + 1]
        assert eng.metrics_snapshot()["pages_in_use"] == 0
    finally:
        eng.shutdown()


def test_more_requests_than_slots_and_shutdown(models, prompts):
    eng = DecodeEngine(TransformerDecodeAdapter(models[1]), max_slots=2,
                       page_size=8, device="cpu").load()
    futs = [eng.generate_async(prompts[i % 4], max_new_tokens=4) for i in range(6)]
    assert all(len(f.result(timeout=120).tokens) == 4 for f in futs)
    eng.shutdown()
    eng.shutdown()                               # idempotent
    f = eng.batcher.submit_request(None)
    with pytest.raises(RuntimeError, match="shut down"):
        f.result(timeout=5)


def test_generate_validates_requests(models):
    eng = DecodeEngine(TransformerDecodeAdapter(models[1]), page_size=8, device="cpu")
    with pytest.raises(RuntimeError, match="load"):
        eng.generate([1, 2])
    eng.load()
    try:
        for bad in (dict(prompt_ids=[]), dict(prompt_ids=[64]),
                    dict(prompt_ids=[1], temperature=-1.0),
                    dict(prompt_ids=[1], top_p=0.0),
                    dict(prompt_ids=[1], max_new_tokens=0),
                    dict(prompt_ids=list(range(64)))):
            with pytest.raises(ValueError):
                eng.generate_async(**bad)
    finally:
        eng.shutdown()


# -- cache layout and deterministic attention ------------------------------------------


def test_cache_writes_and_gather_match_jax():
    rng = np.random.default_rng(3)
    n_layers, n_pages, page, H, d = 2, 7, 4, 2, 3
    pool = rng.standard_normal((n_layers, n_pages, page, H, d)).astype(np.float32)
    row = np.array([3, 5, 1], np.int32)
    rows = rng.standard_normal((9, H, d)).astype(np.float32)
    table = np.array([[3, 5, 1], [0, 0, 0], [2, 4, 6]], np.int32)
    pos = np.array([6, 2, 11], np.int32)
    step_rows = rng.standard_normal((3, H, d)).astype(np.float32)

    jp = jkv.write_prefill(jnp.asarray(pool), 1, jnp.asarray(row), jnp.asarray(rows), 4)
    jp = jkv.write_step(jp, 0, jnp.asarray(table), jnp.asarray(pos), jnp.asarray(step_rows))
    tp = torch.from_numpy(pool.copy())
    tkv.write_prefill(tp, 1, torch.from_numpy(row).long(), torch.from_numpy(rows), 4)
    tkv.write_step(tp, 0, torch.from_numpy(table).long(), torch.from_numpy(pos).long(),
                   torch.from_numpy(step_rows))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for layer in (0, 1):
        np.testing.assert_array_equal(
            tkv.gather_layer(tp, layer, torch.from_numpy(table).long()).numpy(),
            np.asarray(jkv.gather_layer(jp, layer, jnp.asarray(table))))
    assert tkv.pages_for(17, 8) == jkv.pages_for(17, 8) == 3
    assert tkv.pages_for(0, 8) == 1


def test_det_attention_matches_jax_and_chunks_bitwise(monkeypatch):
    rng = np.random.default_rng(4)
    B, H, Tq, L, d = 2, 2, 24, 32, 8
    q = rng.standard_normal((B, H, Tq, d)).astype(np.float32)
    k = rng.standard_normal((B, H, L, d)).astype(np.float32)
    v = rng.standard_normal((B, H, L, d)).astype(np.float32)
    vis = np.arange(L)[None, :] <= (np.arange(Tq) + 5)[:, None]
    bias = np.where(vis, 0.0, tkv.NEG_INF).astype(np.float32)[None, None]
    want = np.asarray(jkv.det_attention(*(jnp.asarray(a) for a in (q, k, v, bias))))
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    whole = tkv.det_attention(*args)
    np.testing.assert_allclose(whole.numpy(), want, atol=1e-6, rtol=1e-6)
    row_bytes = B * H * L * d * 4
    monkeypatch.setattr(tkv, "DET_CHUNK_BYTES", 5 * row_bytes)   # 5 rows a chunk
    assert torch.equal(tkv.det_attention(*args), whole)
    assert math.ceil(Tq / 5) > 1


def test_decode_program_ops_are_row_count_invariant():
    from deeplearning4j_tpu_torch.models.transformer import DECODE_ROWS, per_row
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((48, 40)).astype(np.float32))
    row = torch.from_numpy(rng.standard_normal(48).astype(np.float32))
    fn = lambda x: (x @ w, x.sum(-1, keepdim=True))
    want = per_row(fn, row[None])
    for n in (1, 4, DECODE_ROWS, DECODE_ROWS + 3, 3 * DECODE_ROWS):
        x = torch.from_numpy(rng.standard_normal((n, 48)).astype(np.float32))
        i = n // 2
        x[i] = row
        got = per_row(fn, x)
        assert got[0].shape == (n, 40) and got[1].shape == (n, 1)
        assert torch.equal(got[0][i], want[0][0]) and torch.equal(got[1][i], want[1][0])
    # keys past a row's last visible one add exact zeros in det_attention
    q = torch.from_numpy(rng.standard_normal((1, 2, 3, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 20, 8)).astype(np.float32))
            for _ in range(2))
    vis = torch.arange(20)[None, :] <= torch.tensor([4, 9, 11])[:, None]
    bias = torch.where(vis, 0.0, tkv.NEG_INF).float()[None, None]
    full = tkv.det_attention(q, k, v, bias)
    assert torch.equal(full, tkv.det_attention(q, k[:, :, :12], v[:, :, :12],
                                               bias[..., :12]))


def test_alloc_cache_is_f32_only():
    c = tkv.alloc_cache(2, 3, 4, 2, 8)
    assert c.k_pages.shape == (2, 3, 4, 2, 8) and not bool(c.v_pages.any())
    with pytest.raises(NotImplementedError):
        tkv.alloc_cache(2, 3, 4, 2, 8, dtype=torch.int8)


# -- admission queue ------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 5, 64, 1000])
def test_pow2_buckets_match_jax(n):
    assert pow2_buckets(n) == j_pow2_buckets(n)


def test_batcher_shed_deadline_and_requeue():
    now = [0.0]
    b = ContinuousBatcher(max_batch=2, slo_ms=100, max_queue=2, admission="shed",
                          clock=lambda: now[0])
    f1 = b.submit_request("a")
    f2 = b.submit_request("b", slo_ms=1000)
    with pytest.raises(OverloadedError):
        b.submit_request("c")
    now[0] = 0.5                               # past a's 100 ms deadline
    got = b.admit(2)
    assert [r.payload for r in got] == ["b"]
    with pytest.raises(DeadlineExceededError):
        f1.result(timeout=1)
    b.requeue_front(got[0])
    assert b.qsize() == 1 and b.wait_for_work(0.01)
    b.close()
    with pytest.raises(RuntimeError, match="shut down"):
        f2.result(timeout=1)
    with pytest.raises(ValueError):
        ContinuousBatcher(admission="drop")


# -- CLI ------------------------------------------------------------------------------


def test_cli_predict_matches_jax(models, tmp_path):
    jn, _, path = models
    x = np.random.default_rng(5).integers(0, SIZE["vocab_size"], (2, 40))
    np.savez(tmp_path / "x.npz", x=x)
    rc = cli.main(["predict", "--model", path, "--input", str(tmp_path / "x.npz"),
                   "--output", str(tmp_path / "y.npz"), "--device", "cpu"])
    assert rc == 0
    y = np.load(tmp_path / "y.npz")["predictions"]
    np.testing.assert_allclose(y, np.asarray(jn.output(x)), atol=1e-5, rtol=0)


def test_cli_generate_matches_the_engine(models, capsys):
    _, net, path = models
    prompt = "hi!"
    rc = cli.main(["generate", "--model", path, "--prompt", prompt,
                   "--max-tokens", "6", "--temperature", "0.9", "--top-k", "8",
                   "--seed", "11", "--device", "cpu"])
    assert rc == 0
    eng = DecodeEngine(TransformerDecodeAdapter(net), max_slots=1, page_size=16,
                       device="cpu").load()
    try:
        ids = [min(ord(c), SIZE["vocab_size"] - 1) for c in prompt]
        r = eng.generate(ids, max_new_tokens=6, temperature=0.9, top_k=8, seed=11)
    finally:
        eng.shutdown()
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out == prompt + "".join(chr(t) for t in r.tokens)
