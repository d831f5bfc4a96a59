"""The port's decode-side features against the JAX package's: int8 KV
pages, the offset / speculative / fused entry points of the decode
program, the device sampler, the radix prefix cache, speculative
decoding, and the feature counters and CLI flags.

One small LM (vocab 61, 2 blocks, d_model 32, 2 heads, max_len 64) is
built in JAX, saved with the reference serializer and loaded into the
port, so both packages hold the same weights; pages hold 8 tokens.

Tolerances: the pool ops (``_quantize_rows``, the int8 writes, the
int8 gather, ``scrub_pool``), the device sampler and ``uniform`` are
bitwise the JAX functions (the same rounded ops); the program entry
points' logits are within 1e-5 of the reference program's (f32 sums in
another order), and their sampled tokens equal.  Engines are held to
the reference's plain engine (token for token) and to the port's own
plain engine and re-encode (bitwise logits), never to the reference's
prefix, speculative, chunked or fused engines.  int8 is an envelope:
greedy tokens agree with the f32 re-encode's argmax on >= 80% of
positions, as in the reference's own test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import TransformerDecodeAdapter as JAdapter
from deeplearning4j_tpu.models.transformer import TransformerLM as JLM
from deeplearning4j_tpu.ops import kv_cache as jkv
from deeplearning4j_tpu.ops.sampling import sample_token as j_sample_token
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.utils.serializer import save_model as j_save
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.models.transformer import TransformerDecodeAdapter
from deeplearning4j_tpu_torch.ops import kv_cache as tkv
from deeplearning4j_tpu_torch.ops import sampling as ts
from deeplearning4j_tpu_torch.serving import DecodeEngine, PoisonInputError
from deeplearning4j_tpu_torch.utils.serializer import load_model

VOCAB, MAXLEN, PAGE = 61, 64, 8
SIZE = dict(vocab_size=VOCAB, n_layers=2, d_model=32, n_heads=2, max_len=MAXLEN)
PREFIX = list(range(1, 17))           # two full pages
K = 3


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jn = JLM(**SIZE)
    path = str(tmp_path_factory.mktemp("ckpt") / "lm.zip")
    j_save(jn, path)
    return jn, load_model(path, device="cpu"), path


@pytest.fixture(scope="module")
def adapter(models):
    return TransformerDecodeAdapter(models[1])


def _make(adapter, **kw):
    return DecodeEngine(adapter, max_slots=3, page_size=PAGE, default_max_new=8,
                        prompt_buckets=(16, 32), device="cpu", **kw).load()


@pytest.fixture(scope="module")
def port_of(tmp_path_factory):
    """A port adapter over the same weights as a JAX net."""
    def make(jnet):
        path = str(tmp_path_factory.mktemp("net") / "net.zip")
        j_save(jnet, path)
        return TransformerDecodeAdapter(load_model(path, device="cpu"))
    return make


@pytest.fixture(scope="module")
def engines(adapter, models, port_of):
    """The port's plain, prefix-cache, speculative (a 1-block draft of
    half the width) and int8 engines, and the reference's plain engine."""
    draft = port_of(JLM(vocab_size=VOCAB, n_layers=1, d_model=16, n_heads=2,
                        max_len=MAXLEN, seed=9))
    made = {"plain": _make(adapter), "pref": _make(adapter, prefix_cache=True),
            "i8": _make(adapter, kv_dtype="int8"),
            "spec": _make(adapter, draft_model=draft, speculate_k=K),
            "ref": JEngine(JAdapter(models[0]), max_slots=3, page_size=PAGE,
                           default_max_new=8, prompt_buckets=(16, 32)).load()}
    yield made
    for e in made.values():
        e.shutdown()


def _tokens(engine, prompt, **kw):
    return engine.generate(prompt, **kw).tokens


def _ctr(engine, key):
    return engine.metrics_snapshot()["counters"][key]


def _reencode_rows(engine, prompt, toks):
    seq = torch.tensor([list(prompt) + list(toks[:-1])])
    with torch.inference_mode():
        return engine.program.reencode(engine.params, seq)[0, len(prompt) - 1:].numpy()


def _partition_ok(engine) -> bool:
    """free / slot-private / trie-resident partition pages 1..N-1."""
    st = engine._debug_page_state()
    ids = st["free"] + st["private"] + st["trie"]
    return len(ids) == len(set(ids)) and sorted(ids) == list(range(1, engine.total_pages))


# -- pool ops against the JAX functions ------------------------------------------


def _rows_with_edges(rng, shape):
    """f32 rows [..., H, d] with a zero row, an inf row, a -inf row and a
    row whose scaled values end in .5 (rounded half to even)."""
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0] = 0.0
    x[1, 0, 1] = np.inf
    x[2, 1, 0] = -np.inf
    x[3] = 0.0
    x[3, 0, 0], x[3, 0, 1], x[3, 1, 0] = 127.0, 62.5, -3.5       # scale 1.0
    return x


def test_quantize_rows_bitwise_jax():
    x = _rows_with_edges(np.random.default_rng(0), (9, 2, 4))
    q, sc = tkv._quantize_rows(torch.from_numpy(x))
    jq, jsc = jkv._quantize_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    assert q[3, 0, :2].tolist() == [127, 62] and int(q[3, 1, 0]) == -4
    assert float(sc[0]) == 1.0 and not bool(q[0].any())      # zero row, exact zeros
    deq = q.float() * sc[:, None, None]
    assert not torch.isfinite(deq[1]).all() and not torch.isfinite(deq[2]).all()


def test_quantize_rows_carries_a_nan_row_through_its_scale():
    # the port gives a NaN row a NaN scale so the poison check sees it; the
    # reference's ``amax > 0`` gives it 1.0 and drops the NaN
    x = np.ones((2, 2, 4), np.float32)
    x[1, 0, 2] = np.nan
    q, sc = tkv._quantize_rows(torch.from_numpy(x))
    assert np.isnan(float(sc[1])) and not bool(q[1].any())
    assert torch.isnan(q[1].float() * sc[1]).all()
    assert float(sc[0]) == float(np.asarray(jkv._quantize_rows(jnp.asarray(x))[1])[0])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_alloc_and_pool_nbytes_match_jax(kv_dtype):
    t = tkv.alloc_cache(2, 5, PAGE, 3, 4, kv_dtype=kv_dtype)
    j = jkv.alloc_cache(2, 5, PAGE, 3, 4, kv_dtype=kv_dtype)
    assert tkv.pool_nbytes(t) == jkv.pool_nbytes(j)
    for tp, jp in zip(t, j):
        for a, b in zip(tkv._leaves(tp), jax.tree_util.tree_leaves(jp)):
            assert a.shape == b.shape and str(a.dtype).split(".")[-1] == b.dtype.name
            assert not bool(a.any())
    assert isinstance(t.k_pages, tkv.QuantPages) == (kv_dtype == "int8")


def _leaves_np(tpool, jpool):
    """(port leaves, JAX leaves) of one pool as numpy arrays."""
    return ([a.numpy() for a in tkv._leaves(tpool)],
            [np.asarray(a) for a in jax.tree_util.tree_leaves(jpool)])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pool_writes_gather_and_scrub_bitwise_jax(kv_dtype):
    rng = np.random.default_rng(1)
    n_layers, n_pages, page, H, d = 2, 9, 4, 2, 3
    tp = tkv.alloc_cache(n_layers, n_pages, page, H, d, kv_dtype=kv_dtype).k_pages
    jp = jkv.alloc_cache(n_layers, n_pages, page, H, d, kv_dtype=kv_dtype).k_pages
    t = lambda a: torch.from_numpy(np.asarray(a)).long()
    row = np.array([3, 5, 1], np.int32)
    prompt_rows = _rows_with_edges(rng, (9, H, d))
    table = np.array([[3, 5, 1], [0, 0, 0], [2, 4, 6], [7, 8, 2]], np.int32)
    pos = np.array([6, 2, 11, 3], np.int32)
    step_rows = rng.standard_normal((4, H, d)).astype(np.float32)
    # slot 0 writes 5 rows from position 9: rows 12.. pass its 3 pages
    spec_pos = np.array([9, 0, 2, 5], np.int32)
    spec_rows = rng.standard_normal((4, 5, H, d)).astype(np.float32)

    jp = jkv.write_prefill(jp, 1, jnp.asarray(row), jnp.asarray(prompt_rows), 2)
    jp = jkv.write_step(jp, 0, jnp.asarray(table), jnp.asarray(pos), jnp.asarray(step_rows))
    jp = jkv.write_tokens(jp, 1, jnp.asarray(table), jnp.asarray(spec_pos),
                          jnp.asarray(spec_rows))
    tkv.write_prefill(tp, 1, t(row), torch.from_numpy(prompt_rows), 2)
    tkv.write_step(tp, 0, t(table), t(pos), torch.from_numpy(step_rows))
    tkv.write_tokens(tp, 1, t(table), t(spec_pos), torch.from_numpy(spec_rows))
    for a, b in zip(*_leaves_np(tp, jp)):
        np.testing.assert_array_equal(a, b)
    # slot 0's rows at positions 12, 13 went to the scratch page, not a
    # page of its own
    scratch = (tp.q if kv_dtype else tp)[1, tkv.SCRATCH_PAGE, :2]
    assert bool(scratch.any())
    for layer in (0, 1):
        got = tkv.gather_layer(tp, layer, t(table)).numpy()
        want = np.asarray(jkv.gather_layer(jp, layer, jnp.asarray(table)))
        np.testing.assert_array_equal(got, want)
    ids = np.array([3, 7, 3], np.int32)
    jp = jkv.scrub_pool(jp, jnp.asarray(ids))
    tkv.scrub_pool(tp, t(ids))
    for a, b in zip(*_leaves_np(tp, jp)):
        np.testing.assert_array_equal(a, b)
        assert not a[:, [3, 7]].any()


# -- the device sampler and uniform ----------------------------------------------


_SPECS = [(0.0, 0, 1.0), (0.8, 0, 1.0), (0.8, 50, 1.0), (1.0, 0, 0.9), (0.7, 10, 0.5),
          (2.0, 1, 1.0)]


@pytest.mark.parametrize("mixed", [False, True], ids=["one_spec_a_batch", "mixed_batch"])
def test_device_sampler_bitwise_sample_tokens_and_jax(mixed):
    V = 97
    rng = np.random.default_rng(5)
    n = 12
    lgs = (rng.standard_normal((n, V)) * 3).astype(np.float32)
    lgs[4, 7] = np.nan
    seeds = rng.integers(0, 2**32, n, dtype=np.uint64)
    steps = rng.integers(0, 500, n)
    specs = [_SPECS[i % len(_SPECS)] if mixed else _SPECS[2] for i in range(n)]
    t, k, p = (np.array(c) for c in zip(*specs))
    tok, fin = ts.sample_tokens(torch.from_numpy(lgs), t.tolist(), k.tolist(), p.tolist(),
                                seeds.astype(np.int64).tolist(), steps.tolist(), V)
    dtok, dfin = ts.sample_tokens_device(
        torch.from_numpy(lgs), torch.from_numpy(t.astype(np.float32)), torch.from_numpy(k),
        torch.from_numpy(p.astype(np.float32)), torch.from_numpy(seeds.astype(np.int64)),
        torch.from_numpy(steps), V)
    assert torch.equal(dtok, tok) and torch.equal(dfin, fin)
    for i in range(n):
        if i == 4:
            continue
        jt, jf = j_sample_token(jnp.asarray(lgs[i]), jnp.float32(t[i]), jnp.int32(k[i]),
                                jnp.float32(p[i]), np.uint32(seeds[i]), jnp.int32(steps[i]), V)
        assert int(dtok[i]) == int(jt) and bool(dfin[i]) == bool(jf)
    assert dfin.tolist() == [i != 4 for i in range(n)]


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_uniform_bitwise_jax(seed):
    for stream in (1, 2, 3):
        for step in (0, 5, 2**31 - 1):
            jkey = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(np.uint32(seed)), stream), step)
            key = ts.fold_in(ts.fold_in(ts.prng_key(torch.tensor(seed)), stream),
                             torch.tensor(step))
            assert float(ts.uniform(key)) == float(jax.random.uniform(jkey))
    # a batch of keys gives each key's own draw
    seeds = torch.tensor([seed, 3, 11])
    steps = torch.tensor([[0, 1], [4, 9], [2, 2]])
    key = ts.fold_in(ts.fold_in(ts.prng_key(seeds[:, None]), 2), steps)
    u = ts.uniform(key)
    assert u.shape == (3, 2)
    for i in range(3):
        for j in range(2):
            jkey = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(np.uint32(int(seeds[i]))), 2), int(steps[i, j]))
            assert float(u[i, j]) == float(jax.random.uniform(jkey))


# -- the decode program's new entry points against the reference program ------------


@pytest.fixture(scope="module")
def programs(models, adapter):
    ja = JAdapter(models[0])
    return ja.decode_program(page_size=PAGE), ja.params, adapter.decode_program(
        page_size=PAGE), adapter.params


def _both_pools(jprog, tprog, n_pages):
    jp = jkv.alloc_cache(jprog.n_layers, n_pages, PAGE, jprog.n_heads, jprog.d_head)
    tp = tkv.alloc_cache(tprog.n_layers, n_pages, PAGE, tprog.n_heads, tprog.d_head)
    return list(jp), list(tp)


def _prefill_both(programs, jp, tp, row, prompt, bucket=32):
    jprog, jpar, tprog, tpar = programs
    padded = np.zeros(bucket, np.int64)
    padded[:len(prompt)] = prompt
    jp[0], jp[1], _ = jprog.prefill(jpar, jp[0], jp[1], jnp.asarray(row, jnp.int32),
                                    jnp.asarray(padded, jnp.int32), len(prompt))
    tprog.prefill(tpar, tp[0], tp[1], torch.from_numpy(row), torch.from_numpy(padded),
                  len(prompt))


def _assert_pools_close(jp, tp, skip_scratch=False):
    for j, t in zip(jp, tp):
        a, b = t.numpy(), np.asarray(j)
        if skip_scratch:
            a, b = a[:, 1:], b[:, 1:]
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_prefill_at_matches_reference_program(programs):
    jprog, jpar, tprog, tpar = programs
    pps = tprog.pages_per_slot
    jp, tp = _both_pools(jprog, tprog, 1 + pps)
    row = np.arange(1, 1 + pps, dtype=np.int64)
    prompt = np.random.default_rng(7).integers(0, VOCAB, 40)
    _prefill_both(programs, jp, tp, row, prompt[:16], bucket=16)
    # the rest at offset 16, in a bucket that overshoots the prompt
    suffix = np.zeros(32, np.int64)
    suffix[:24] = prompt[16:]
    jp[0], jp[1], jl = jprog.prefill_at(jpar, jp[0], jp[1], jnp.asarray(row, jnp.int32),
                                        jnp.asarray(suffix, jnp.int32), 24, 16)
    _, _, tl = tprog.prefill_at(tpar, tp[0], tp[1], torch.from_numpy(row),
                                torch.from_numpy(suffix), 24, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    _assert_pools_close(jp, tp)
    # the offset prefill's last logits are those of one prefill of the
    # whole prompt (the port's bitwise, the reference's within 1e-5)
    whole = _both_pools(jprog, tprog, 1 + pps)[1]
    padded = np.zeros(64, np.int64)
    padded[:40] = prompt
    _, _, tw = tprog.prefill(tpar, whole[0], whole[1], torch.from_numpy(row),
                             torch.from_numpy(padded), 40)
    assert torch.equal(tw, tl)


def test_spec_step_matches_reference_program(programs):
    jprog, jpar, tprog, tpar = programs
    pps = tprog.pages_per_slot
    jp, tp = _both_pools(jprog, tprog, 1 + 3 * pps)
    table = np.arange(1, 1 + 3 * pps, dtype=np.int64).reshape(3, pps)
    rng = np.random.default_rng(8)
    for s, n in enumerate((20, 30, 61)):
        _prefill_both(programs, jp, tp, table[s], rng.integers(0, VOCAB, n),
                      bucket=64 if n > 32 else 32)
    tokens = rng.integers(0, VOCAB, (3, K + 2))
    positions = np.array([20, 30, 61])     # slot 2 runs 2 rows past max_len
    active = np.array([True, False, True])
    jp[0], jp[1], jl = jprog.spec_step(jpar, jp[0], jp[1], jnp.asarray(table, jnp.int32),
                                       jnp.asarray(tokens, jnp.int32),
                                       jnp.asarray(positions, jnp.int32), jnp.asarray(active))
    _, _, tl = tprog.spec_step(tpar, tp[0], tp[1], torch.from_numpy(table),
                               torch.from_numpy(tokens), torch.from_numpy(positions),
                               torch.from_numpy(active))
    assert tl.shape == (3, K + 2, VOCAB)
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active], atol=1e-5, rtol=0)
    _assert_pools_close(jp, tp, skip_scratch=True)


def _live_mask(toks, fins, active, budgets, eos):
    """[H, S]: slot s is live at step j (the rows step_multi's contract
    covers)."""
    alive = np.asarray(active).copy()
    out = []
    for j in range(toks.shape[0]):
        out.append(alive.copy())
        alive = alive & fins[j] & (toks[j] != eos) & (j + 1 < budgets)
    return np.stack(out)


def test_step_multi_matches_reference_program(programs):
    jprog, jpar, tprog, tpar = programs
    pps = tprog.pages_per_slot
    jp, tp = _both_pools(jprog, tprog, 1 + 4 * pps)
    table = np.arange(1, 1 + 4 * pps, dtype=np.int64).reshape(4, pps)
    rng = np.random.default_rng(9)
    for s, n in enumerate((5, 12, 25, 9)):
        _prefill_both(programs, jp, tp, table[s], rng.integers(0, VOCAB, n), bucket=32)
    H = 5
    tokens = rng.integers(0, VOCAB, 4)
    positions = np.array([5, 12, 25, 9])
    active = np.array([True, True, True, False])
    temps = np.array([0.0, 0.9, 1.2, 0.0], np.float32)
    top_ks = np.array([0, 8, 0, 0])
    top_ps = np.array([1.0, 1.0, 0.8, 1.0], np.float32)
    seeds = np.array([1, 2**32 - 3, 77, 0])
    steps = np.array([1, 4, 9, 0])
    budgets = np.array([5, 2, 4, 1])
    # EOS: the greedy slot's third token, read from a first run
    args = lambda eos: (table, tokens, positions, active, temps, top_ks, top_ps, seeds, steps,
                        budgets, eos)

    def run_port(eos):
        pools = [p.clone() for p in tp]
        out = tprog.step_multi(tpar, pools[0], pools[1],
                               *(torch.from_numpy(np.asarray(a)) for a in args(eos)), H)
        return pools, out[2].numpy(), out[3].numpy(), out[4].numpy()

    eos = int(run_port(-1)[1][2, 0])
    pools, toks, fins, lgs = run_port(eos)
    j = jprog.step_multi(jpar, jp[0], jp[1], jnp.asarray(table, jnp.int32),
                         jnp.asarray(tokens, jnp.int32), jnp.asarray(positions, jnp.int32),
                         jnp.asarray(active), jnp.asarray(temps), jnp.asarray(top_ks, jnp.int32),
                         jnp.asarray(top_ps), jnp.asarray(seeds.astype(np.uint32)),
                         jnp.asarray(steps, jnp.int32), jnp.asarray(budgets, jnp.int32),
                         jnp.int32(eos), jnp.arange(H, dtype=jnp.int32))
    jtoks, jfins, jlgs = (np.asarray(a) for a in j[2:])
    live = _live_mask(toks, fins, active, budgets, eos)
    first = toks[:, 0].tolist().index(eos)                        # stopped at EOS
    assert first <= 2 and live[:, 0].tolist() == [True] * (first + 1) + [False] * (H - first - 1)
    assert not live[2:, 1].any() and not live[:, 3].any()          # budget 2; inactive
    assert (live.sum(0) <= budgets).all() and live[:, 2].sum() >= 2
    assert toks.shape == (H, 4) and lgs.shape == (H, 4, VOCAB)
    np.testing.assert_array_equal(toks[live], jtoks[live])
    np.testing.assert_array_equal(fins[live], jfins[live])
    np.testing.assert_allclose(lgs[live], jlgs[live], atol=1e-5, rtol=0)
    _assert_pools_close([j[0], j[1]], pools, skip_scratch=True)


def test_step_multi_is_bitwise_plain_steps(programs):
    _, _, tprog, tpar = programs
    pps = tprog.pages_per_slot
    tp = tkv.alloc_cache(tprog.n_layers, 1 + 3 * pps, PAGE, tprog.n_heads, tprog.d_head)
    table = torch.arange(1, 1 + 3 * pps).reshape(3, pps)
    rng = np.random.default_rng(10)
    for s, n in enumerate((7, 19, 30)):
        padded = torch.zeros(32, dtype=torch.long)
        padded[:n] = torch.from_numpy(rng.integers(0, VOCAB, n))
        tprog.prefill(tpar, tp[0], tp[1], table[s], padded, n)
    plain = [p.clone() for p in tp]
    tok = torch.from_numpy(rng.integers(0, VOCAB, 3))
    pos = torch.tensor([7, 19, 30])
    act = torch.ones(3, dtype=torch.bool)
    temps, ks, ps = torch.tensor([0.0, 0.8, 1.0]), torch.tensor([0, 5, 0]), torch.tensor([1.0, 1.0, 0.9])
    seeds, steps = torch.tensor([3, 4, 5]), torch.tensor([1, 1, 1])
    H = 4
    _, _, toks, fins, lgs = tprog.step_multi(tpar, tp[0], tp[1], table, tok, pos, act, temps,
                                             ks, ps, seeds, steps, torch.full((3,), 9),
                                             torch.tensor(-1), H)
    cur = tok
    for j in range(H):
        _, _, lg = tprog.step(tpar, plain[0], plain[1], table, cur, pos + j, act)
        t, f = ts.sample_tokens(lg, temps.tolist(), ks.tolist(), ps.tolist(), seeds.tolist(),
                                (steps + j).tolist(), VOCAB)
        assert torch.equal(lg, lgs[j]) and torch.equal(t, toks[j]) and bool(f.all())
        cur = t
    assert all(torch.equal(a, b) for a, b in zip(plain, tp))


# -- radix prefix cache -----------------------------------------------------------


def test_prefix_hit_is_bitwise_a_miss_and_counts(engines):
    pref, plain, ref = engines["pref"], engines["plain"], engines["ref"]
    h0, t0 = _ctr(pref, "prefix_hits"), _ctr(pref, "prefix_hit_tokens")
    _tokens(pref, PREFIX + [20, 21, 22])                 # seeds the trie
    p = PREFIX + [30, 31]
    res = pref.generate(p, max_new_tokens=8, echo_logits=True)
    assert _ctr(pref, "prefix_hits") == h0 + 1
    assert _ctr(pref, "prefix_hit_tokens") == t0 + len(PREFIX)
    miss = plain.generate(p, max_new_tokens=8, echo_logits=True)
    assert res.tokens == miss.tokens == _tokens(ref, p, max_new_tokens=8)
    np.testing.assert_array_equal(res.logits, miss.logits)
    np.testing.assert_array_equal(res.logits, _reencode_rows(pref, p, res.tokens))
    # an identical prompt hits its own insert; a miss counts as one
    a = _tokens(pref, PREFIX + [40], max_new_tokens=6)
    h1 = _ctr(pref, "prefix_hits")
    assert _tokens(pref, PREFIX + [40], max_new_tokens=6) == a
    assert _ctr(pref, "prefix_hits") == h1 + 1
    m0 = _ctr(pref, "prefix_misses")
    assert _tokens(pref, [42, 43, 44], max_new_tokens=6) == _tokens(ref, [42, 43, 44],
                                                                    max_new_tokens=6)
    assert _ctr(pref, "prefix_misses") == m0 + 1


def test_prefix_eviction_under_pool_pressure(engines):
    pref, ref = engines["pref"], engines["ref"]
    e0 = _ctr(pref, "prefix_evictions")
    rng = np.random.default_rng(3)
    for _ in range(3 * pref.total_pages // 4):          # unique prefixes
        pref.generate(rng.integers(0, VOCAB, size=32), max_new_tokens=1)
    assert _ctr(pref, "prefix_evictions") > e0
    assert _partition_ok(pref)
    p = PREFIX + [45]
    assert _tokens(pref, p, max_new_tokens=6) == _tokens(ref, p, max_new_tokens=6)


def test_shared_pages_gauge_tracks_the_trie(engines):
    pref = engines["pref"]
    _tokens(pref, PREFIX + [46, 47], max_new_tokens=2)
    snap = pref.metrics_snapshot()
    assert snap["shared_pages"] == len(pref._debug_page_state()["trie"]) > 0
    assert snap["prefix_cache"] is True and engines["plain"].metrics_snapshot()[
        "shared_pages"] == 0


def test_crash_retry_of_a_prefix_hit_never_double_decrefs(engines):
    pref, ref = engines["pref"], engines["ref"]
    _tokens(pref, PREFIX + [33], max_new_tokens=4)      # trie warm
    prompts = [PREFIX + [34 + i] for i in range(3)]
    want = [_tokens(ref, p, max_new_tokens=6) for p in prompts]
    r0 = _ctr(pref, "retries")
    futs = [pref.generate_async(p, max_new_tokens=6) for p in prompts]
    with pref._lock:
        pref._crash_next = True
    assert [f.result(timeout=60).tokens for f in futs] == want   # nothing stranded
    assert _ctr(pref, "retries") > r0
    assert _partition_ok(pref)
    assert all(nd.refs >= 0 for nd in pref._iter_trie())
    assert pref.metrics_snapshot()["pages_in_use"] == len(pref._debug_page_state()["trie"])


def test_poison_scrub_never_touches_referenced_pages(engines):
    """A poisoned request that attached shared prefix pages scrubs only
    its private pages: the trie's rows stay bitwise, and the next hit is
    exact."""
    pref = engines["pref"]
    p = PREFIX + [18, 19]
    want = _tokens(pref, p, max_new_tokens=6)
    trie = pref._debug_page_state()["trie"]
    before = [pool[:, trie].clone() for pool in pref._cache]
    nan = {"embed": pref.params["embed"], "pos": pref.params["pos"],
           "blocks": pref.params["blocks"],
           "head": {k: torch.full_like(v, float("nan")) for k, v in pref.params["head"].items()}}
    p0 = _ctr(pref, "poison_isolated")
    good = pref.params
    with pref._lock:
        pref.params = nan
    try:
        with pytest.raises(PoisonInputError):
            pref.generate(PREFIX + [22, 23], max_new_tokens=6)
    finally:
        with pref._lock:
            pref.params = good
    assert _ctr(pref, "poison_isolated") == p0 + 1
    assert _partition_ok(pref)
    assert all(torch.equal(b, pool[:, trie]) for b, pool in zip(before, pref._cache))
    assert _tokens(pref, p, max_new_tokens=6) == want


# -- int8 pages ------------------------------------------------------------------


def test_int8_inside_the_accuracy_envelope_and_pool_bytes_halved(engines):
    i8, plain = engines["i8"], engines["plain"]
    agree = total = 0
    for p in ([1, 2, 3], [5, 6], list(range(7, 19)), list(range(20, 50))):
        res = i8.generate(p, max_new_tokens=8)
        ref = _reencode_rows(plain, p, res.tokens)
        agree += sum(int(ref[j].argmax() == t) for j, t in enumerate(res.tokens))
        total += len(res.tokens)
    assert agree / total >= 0.80                        # envelope, not identity
    assert isinstance(i8._cache.k_pages, tkv.QuantPages)
    assert tkv.pool_nbytes(plain._cache) / tkv.pool_nbytes(i8._cache) >= 2.0
    assert i8.metrics_snapshot()["kv_dtype"] == "int8"


# -- speculative decoding ---------------------------------------------------------


def test_spec_fns_match_the_reference_at_temperature_0():
    # greedy proposals, and the leading accepts and commits of exact
    # rejection sampling, from the same logits (the sampling arm is held
    # by the next test)
    from deeplearning4j_tpu.serving.decode import _make_spec_fns as j_spec_fns
    from deeplearning4j_tpu_torch.serving.decode import _make_spec_fns
    V, S = 37, 5
    rng = np.random.default_rng(12)
    dlgs = (rng.standard_normal((K, S, V)) * 2).astype(np.float32)
    tlgs = (rng.standard_normal((S, K + 1, V)) * 2).astype(np.float32)
    # slot s agrees with the draft on its first s proposals
    for s_ in range(S):
        for j in range(min(s_, K)):
            tlgs[s_, j] = dlgs[j, s_]
    zs = np.zeros(S, np.float32)
    args = dict(ts=zs, ks=np.zeros(S, np.int32), ps=np.ones(S, np.float32),
                seeds=np.arange(S, dtype=np.uint32), steps=np.arange(S, dtype=np.int32))
    jprop, jacc = j_spec_fns(V, K)
    tprop, tacc = _make_spec_fns(V, K)
    tt = {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu" else v)
          for k, v in args.items()}
    jt, jp = zip(*[jprop(jnp.asarray(dlgs[j]), *args.values()) for j in range(K)])
    tt_, tp = zip(*[tprop(torch.from_numpy(dlgs[j]), *tt.values()) for j in range(K)])
    for a_, b_ in zip(jt, tt_):
        np.testing.assert_array_equal(np.asarray(a_), b_.numpy())
    for a_, b_ in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a_), b_.numpy())          # one-hot
    jn, jc, jf = jacc(jnp.asarray(tlgs), jnp.stack(jt, 1), jnp.stack(jp, 1), *args.values())
    tn, tc, tf = tacc(torch.from_numpy(tlgs), torch.stack(tt_, 1), torch.stack(tp, 1),
                      *tt.values())
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tn.tolist() == [1, 2, 3, 4, 4]


def test_spec_fns_match_the_reference_when_sampling():
    """At temperature 0.8 with top-k and top-p set, on fixed logits and a
    partly agreeing draft: propose's distributions (draft and target rows)
    within 1e-6 of the reference's and its tokens equal; accept's leading
    accepts and commits equal, over a full acceptance (bonus row), a
    rejection at j = 0 and rejections mid-round (residual resample).  No
    u, no top-p cut and no argmax on these inputs lies within 1e-5 of its
    decision boundary, so the equalities do not rest on the last bits."""
    from deeplearning4j_tpu.serving.decode import _make_spec_fns as j_spec_fns
    from deeplearning4j_tpu_torch.serving.decode import _make_spec_fns
    V, S, T = 37, 8, 0.8
    rng = np.random.default_rng(21)
    args = dict(ts=np.full(S, T, np.float32),
                ks=np.array([20, 0, 12, 20, 30, 0, 16, 25], np.int32),
                ps=np.array([0.9, 0.95, 1.0, 0.85, 0.9, 0.92, 1.0, 0.97], np.float32),
                seeds=np.arange(100, 100 + S, dtype=np.uint32),
                steps=np.arange(3, 3 + S, dtype=np.int32))
    ja = tuple(jnp.asarray(v) for v in args.values())
    ta = tuple(torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu" else v)
               for v in args.values())
    jprop, jacc = j_spec_fns(V, K)
    tprop, tacc = _make_spec_fns(V, K)

    def jkey(seed, stream, step):
        return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), stream), step)

    def propose_both(lgs, j):
        jt, jp = jprop(jnp.asarray(lgs), *ja[:4], ja[4] + j)
        tt, tp = tprop(torch.from_numpy(lgs), *ta[:4], ta[4] + j)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
        return jt, jp, tt, tp

    def clear_of_top_p(lgs):
        # no token's excluded mass sits within 1e-5 of its row's top_p
        srt = -np.sort(-lgs.astype(np.float64) / T, axis=-1)
        pr = np.exp(srt - srt[:, :1])
        pr /= pr.sum(-1, keepdims=True)
        cum = np.cumsum(pr, -1) - pr
        p = args["ps"].astype(np.float64)[:, None]
        assert (np.abs(cum - p)[p[:, 0] < 1.0] > 1e-5).all()

    def top2_gap(vals):
        top = np.sort(vals)[-2:]
        return top[1] - top[0]

    dlgs = (rng.standard_normal((K, S, V)) * 2).astype(np.float32)
    drafts = [propose_both(dlgs[j], j) for j in range(K)]
    for j, (jt, jp, tt, tp) in enumerate(drafts):
        clear_of_top_p(dlgs[j])
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        for s_ in range(S):
            g = np.asarray(jax.random.gumbel(jkey(args["seeds"][s_], 1, args["steps"][s_] + j),
                                             (V,)), np.float64)
            lp = np.log(np.maximum(np.asarray(jp[s_], np.float64), 1e-30))
            assert top2_gap(lp + g) > 1e-5, (j, s_)
    dtok = np.stack([np.asarray(d[0]) for d in drafts], 1)            # [S, K]
    # slots 0-1 agree with the draft on every row (full acceptance, bonus
    # row), 2-3 drop the first proposal (rejection at j = 0), 4-5 agree
    # on the first one or two rows and then drop the proposal (rejection
    # mid-round), 6-7 are the draft's rows perturbed (a fair accept test)
    tlgs = (rng.standard_normal((S, K + 1, V)) * 2).astype(np.float32)
    for s_, agree in ((0, K), (1, K), (2, 0), (3, 0), (4, 1), (5, 2)):
        for j in range(agree):
            tlgs[s_, j] = dlgs[j, s_]
        if agree < K:
            tlgs[s_, agree] = dlgs[agree, s_]
            tlgs[s_, agree, dtok[s_, agree]] = -30.0
    for s_ in (6, 7):
        for j in range(K):
            tlgs[s_, j] = dlgs[j, s_] + 0.7 * rng.standard_normal(V).astype(np.float32)
    targ = []
    for j in range(K + 1):
        clear_of_top_p(tlgs[:, j])
        targ.append(np.asarray(propose_both(np.ascontiguousarray(tlgs[:, j]), j)[1],
                               np.float64))
    targ = np.stack(targ, 1)                                          # [S, K+1, V]
    jn, jc, jf = jacc(jnp.asarray(tlgs), jnp.stack([d[0] for d in drafts], 1),
                      jnp.stack([d[1] for d in drafts], 1), *ja)
    tn, tc, tf = tacc(torch.from_numpy(tlgs), torch.stack([d[2] for d in drafts], 1),
                      torch.stack([d[3] for d in drafts], 1), *ta)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    n = np.asarray(jn)
    assert n[:2].tolist() == [K + 1] * 2 and n[2:4].tolist() == [1, 1]
    assert n[4:6].tolist() == [2, 3]
    dprob = np.stack([np.asarray(d[1], np.float64) for d in drafts], 1)  # [S, K, V]
    for s_ in range(S):
        seed, step0, a = args["seeds"][s_], args["steps"][s_], int(n[s_]) - 1
        for j in range(min(a + 1, K)):       # the accept tests that decide a
            u = float(jax.random.uniform(jkey(seed, 2, step0 + j)))
            d = dtok[s_, j]
            ratio = targ[s_, j, d] / max(dprob[s_, j, d], 1e-30)
            assert abs(u - ratio) > 1e-5, (s_, j, u, ratio)
        dp = dprob[s_, a] if a < K else np.zeros(V)
        resid = np.maximum(targ[s_, a] - dp, 0.0)
        resid = resid / resid.sum() if resid.sum() > 0 else targ[s_, a]
        g = np.asarray(jax.random.gumbel(jkey(seed, 3, step0 + a), (V,)), np.float64)
        assert top2_gap(np.log(np.maximum(resid, 1e-30)) + g) > 1e-5, s_


def test_self_draft_accepts_every_proposal(adapter, engines):
    eng = _make(adapter, draft_model=adapter, speculate_k=K)
    try:
        p = [3, 4, 5, 6]
        res = eng.generate(p, max_new_tokens=9)
        c = eng.metrics_snapshot()["counters"]
        assert res.tokens == _tokens(engines["ref"], p, max_new_tokens=9)
        assert c["spec_accepted"] == c["spec_proposed"] > 0
        assert eng.metrics_snapshot()["accepted_tokens_per_step"] == K + 1
    finally:
        eng.shutdown()


def test_self_draft_counts_only_proposals_inside_the_budget(adapter):
    # 18 + 6 tokens end on a page edge and the slot holds the reference's
    # 3 pages, so the last round verifies rows past the slot's last token
    # that read the scratch page, which two idle slots write in the same
    # call.  Every row inside the budget is bitwise the draft's row at the
    # same position (the draft is the target), and the counters count
    # exactly those rows' proposals, so a self-draft accepts them all
    eng = DecodeEngine(adapter, max_slots=3, page_size=PAGE, prompt_buckets=(16, 32),
                       draft_model=adapter, speculate_k=K, device="cpu")
    events = []       # ("draft" | "verify", page table, positions, active, logits)

    def recorder(kind, fn):
        def call(*a):
            out = fn(*a)
            events.append((kind, a[3].clone(), a[5].clone(), a[6].clone(), out[2].clone()))
            return out
        return call

    eng._draft_program = eng._draft_program._replace(
        step=recorder("draft", eng._draft_program.step))
    eng.program = eng.program._replace(spec_step=recorder("verify", eng.program.spec_step))
    eng.load()
    try:
        for t in (0.0, 0.9):
            eng.generate(list(range(30, 48)), max_new_tokens=6, temperature=t, seed=2)
        c = eng.metrics_snapshot()["counters"]
    finally:
        eng.shutdown()
    # a round is K draft steps then the verify; a catch-up step may come
    # before the next round's, so a round's proposals are the K draft
    # steps right before its verify
    drafts, inside, past = [], 0, 0
    for kind, table, pos, act, lgs in events:
        if kind == "draft":
            drafts.append((pos, act, lgs))
            continue
        assert int((table[act] > 0).sum()) == 3           # pages_for(18 + 6)
        for j, (dpos, dact, dlg) in enumerate(drafts[-K:]):
            assert torch.equal(dpos, pos + j) and torch.equal(dact, act)
            at = int((pos + j)[act].max())
            if at < 18 + 6 - 1:        # row j yields a token inside the budget
                assert torch.equal(lgs[act, j], dlg[act]), (pos.tolist(), j)
                inside += 1
            past += at >= 24           # the slot's pages end at 24
        drafts = []
    assert c["spec_accepted"] == c["spec_proposed"] == inside >= 2 * K and past >= 2


def test_spec_temp0_equals_the_plain_engines(engines):
    spec, plain, ref = engines["spec"], engines["plain"], engines["ref"]
    for p in ([1, 2, 3], list(range(10, 31)), [7]):
        res = spec.generate(p, max_new_tokens=10, echo_logits=True)
        base = plain.generate(p, max_new_tokens=10, echo_logits=True)
        assert res.tokens == base.tokens == _tokens(ref, p, max_new_tokens=10)
        np.testing.assert_array_equal(res.logits, base.logits)
    snap = spec.metrics_snapshot()
    assert snap["speculate_k"] == K and snap["accepted_tokens_per_step"] >= 1.0
    c = snap["counters"]
    assert c["spec_committed"] >= c["spec_steps"] and c["spec_proposed"] >= c["spec_accepted"]


def test_spec_seeded_sampling_is_deterministic(engines):
    spec = engines["spec"]
    runs = [_tokens(spec, [8, 9], max_new_tokens=10, temperature=0.9, top_k=12, seed=s)
            for s in (5, 5, 6)]
    assert runs[0] == runs[1] and len(runs[0]) == 10
    assert runs[0] != runs[2]


def test_spec_crash_mid_round_strands_nothing(engines):
    spec, ref = engines["spec"], engines["ref"]
    prompts = [[1, 2], [3, 4, 5], [6]]
    want = [_tokens(ref, p, max_new_tokens=6) for p in prompts]
    r0 = _ctr(spec, "retries")
    futs = [spec.generate_async(p, max_new_tokens=6) for p in prompts]
    with spec._lock:
        spec._crash_next = True
    assert [f.result(timeout=60).tokens for f in futs] == want
    assert _ctr(spec, "retries") > r0
    assert spec.metrics_snapshot()["pages_in_use"] == 0


def test_spec_draft_mismatch_and_bad_args_rejected(adapter, port_of):
    other = port_of(JLM(vocab_size=VOCAB + 2, n_layers=1, d_model=16, n_heads=2,
                                 max_len=MAXLEN, seed=3))
    with pytest.raises(ValueError, match="mismatch"):
        DecodeEngine(adapter, page_size=PAGE, draft_model=other, device="cpu")
    with pytest.raises(ValueError, match="speculate_k"):
        DecodeEngine(adapter, page_size=PAGE, draft_model=adapter, speculate_k=0,
                     device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        DecodeEngine(adapter, page_size=PAGE, kv_dtype="fp8", device="cpu")


# -- counters and the CLI ----------------------------------------------------------


_FEATURE_COUNTERS = (
    "retries", "replica_respawns", "prefix_hits", "prefix_misses", "prefix_inserts",
    "prefix_evictions", "prefix_hit_tokens", "spec_steps", "spec_proposed",
    "spec_accepted", "spec_committed", "fused_dispatches", "tokens_per_dispatch",
    "chunked_prefills", "prefill_chunks")


def test_counters_registered_at_zero_when_features_are_off(adapter):
    eng = _make(adapter)
    try:
        eng.generate([1, 2, 3], max_new_tokens=3)
        snap = eng.metrics_snapshot()
    finally:
        eng.shutdown()
    assert all(snap["counters"][k] == 0 for k in _FEATURE_COUNTERS)
    assert snap["shared_pages"] == 0 and snap["accepted_tokens_per_step"] is None
    assert (snap["prefix_cache"], snap["speculate_k"], snap["kv_dtype"],
            snap["decode_horizon"], snap["prefill_chunk"]) == (False, 0, "float32", 1, None)


def test_cli_flags_parse_and_reject_bad_input():
    p = cli.build_parser()
    a = p.parse_args(["generate", "--model", "m.zip", "--prompt", "hi", "--prefix-cache",
                      "--speculate", "d.zip,6", "--kv-dtype", "int8"])
    assert a.prefix_cache and a.kv_dtype == "int8"
    assert cli._parse_speculate(a.speculate) == ("d.zip", 6)
    a = p.parse_args(["generate", "--model", "m.zip", "--prompt", "hi",
                      "--speculate", "d.zip"])
    assert cli._parse_speculate(a.speculate) == ("d.zip", 4)
    assert not a.prefix_cache and a.kv_dtype == "float32"
    assert cli._parse_speculate(None) == (None, 4)
    for bad in ("d.zip,zero", "d.zip,0", "d.zip,-2"):
        with pytest.raises(SystemExit):
            cli._parse_speculate(bad)
    with pytest.raises(SystemExit):
        p.parse_args(["generate", "--model", "m.zip", "--prompt", "hi", "--kv-dtype", "fp8"])


def test_cli_generate_with_the_decode_flags(models, capsys):
    _, net, path = models
    rc = cli.main(["generate", "--model", path, "--prompt", "hey", "--max-tokens", "7",
                   "--prefix-cache", "--kv-dtype", "int8", "--speculate", f"{path},2",
                   "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    eng = DecodeEngine(TransformerDecodeAdapter(net), max_slots=1, page_size=16,
                       kv_dtype="int8", device="cpu").load()
    try:
        r = eng.generate([min(ord(c), VOCAB - 1) for c in "hey"], max_new_tokens=7)
    finally:
        eng.shutdown()
    assert out == "hey" + "".join(chr(t) for t in r.tokens)
