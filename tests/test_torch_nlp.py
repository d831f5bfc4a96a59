"""The port's NLP engine (``deeplearning4j_tpu_torch/nlp``) against the JAX
package's ``nlp/`` on the CPU.

``tests/test_nlp.py``'s cases run on the port.  Beyond them:
- the negative sampler's draws (``ops.sampling.split``/``randint``/
  ``uniform`` and ``_device_negs``) are bitwise ``jax.random``'s;
- the alias tables, the vocabulary, the Huffman codes and the pair stream
  fed to the update step (numpy path and native path, with its LR and
  valid rows) are bitwise the reference's;
- each update step equals the reference's on the same inputs within
  rtol 1e-5, atol 1e-6;
- Word2Vec SG, CBOW and SG-HS fits from one seed are within rtol 1e-4,
  atol 1e-5 of the reference's ``syn0``;
- a fit stacking 16 batches a dispatch is bitwise the one-batch fit;
- the word2vec C fixtures load, and the writer's bytes are the
  reference writer's.
"""

import os

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as jnlp
import deeplearning4j_tpu_torch.nlp as tnlp
from deeplearning4j_tpu_torch.nlp import (
    CommonPreprocessor, DefaultTokenizerFactory, Huffman, Word2Vec,
    build_vocab, read_word_vectors, write_word_vectors,
)
from deeplearning4j_tpu_torch.ops import sampling


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the fits run thousands of tiny ops, which
    several test workers sharing the cores would otherwise oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def topic_corpus(n_sentences=400, seed=0):
    """Two topics with disjoint vocab; sentences stay within one topic."""
    rng = np.random.default_rng(seed)
    topics = [
        ["cat", "dog", "pet", "fur", "paw", "tail", "meow", "bark"],
        ["cpu", "ram", "disk", "code", "byte", "chip", "core", "cache"],
    ]
    sentences = []
    for _ in range(n_sentences):
        words = rng.choice(topics[int(rng.integers(0, 2))], size=8)
        sentences.append(" ".join(words))
    return sentences


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# tests/test_nlp.py on the port
# ---------------------------------------------------------------------------


class TestTokenization:
    def test_default_tokenizer(self):
        toks = DefaultTokenizerFactory().tokenize("Hello, World! Foo-bar.")
        assert toks == ["hello", "world", "foobar"]

    def test_preprocessor(self):
        assert CommonPreprocessor().pre_process("Don't!") == "dont"


class TestVocab:
    def test_build_and_filter(self):
        corpus = [["a", "a", "a", "b", "b", "c"]] * 2
        vocab = build_vocab(corpus, min_word_frequency=3)
        assert "a" in vocab and "b" in vocab and "c" not in vocab
        assert vocab.count_of("a") == 6
        assert vocab.index_of("a") == 0  # frequency-sorted

    def test_huffman_codes(self):
        corpus = [["a"] * 8 + ["b"] * 4 + ["c"] * 2 + ["d"]]
        vocab = build_vocab(corpus, min_word_frequency=1)
        Huffman(vocab)
        words = {w.word: w for w in vocab.words}
        assert len(words["a"].codes) <= len(words["d"].codes)
        codes = ["".join(map(str, w.codes)) for w in vocab.words]
        for i, c1 in enumerate(codes):
            for j, c2 in enumerate(codes):
                if i != j:
                    assert not c2.startswith(c1)

    def test_unigram_table(self):
        corpus = [["x"] * 9 + ["y"]]
        vocab = build_vocab(corpus, min_word_frequency=1)
        p = vocab.unigram_table()
        assert p[vocab.index_of("x")] > p[vocab.index_of("y")]
        np.testing.assert_allclose(p.sum(), 1.0)


class TestWord2Vec:
    @pytest.mark.parametrize("mode", ["sg_neg", "cbow", "sg_hs"])
    def test_topics_separate_and_fit_is_the_references(self, mode):
        """The reference's semantic gate on the port's fit, and the port's
        ``syn0`` within rtol 1e-4, atol 1e-5 of the reference's from the
        same seed (same negatives, windows, LR schedule)."""
        kw = dict(layer_size=32, window=3, min_word_frequency=2,
                  negative=5, epochs=12, batch_size=128, seed=1,
                  learning_rate=0.05, subsampling=0,
                  cbow=(mode == "cbow"), hierarchic_softmax=(mode == "sg_hs"))
        w2v = Word2Vec(device="cpu", **kw)
        w2v.fit(topic_corpus())
        assert len(w2v.vocab) == 16
        within = w2v.similarity("cat", "dog")
        across = w2v.similarity("cat", "cpu")
        assert within > across + 0.2, f"{mode}: within={within:.3f} across={across:.3f}"
        nearest = w2v.words_nearest("cat", top_n=7)
        animal = {"dog", "pet", "fur", "paw", "tail", "meow", "bark"}
        assert len(set(nearest) & animal) >= 5, nearest
        ref = jnlp.Word2Vec(**kw)
        ref.fit(topic_corpus())
        assert [w.word for w in ref.vocab.words] == [w.word for w in w2v.vocab.words]
        _close(w2v.syn0, ref.syn0, 1e-4, 1e-5)
        _close(w2v.syn1, ref.syn1, 1e-4, 1e-5)

    def test_serializer_roundtrip_text(self, tmp_path):
        w2v = Word2Vec(layer_size=16, min_word_frequency=2, epochs=2, seed=0, device="cpu")
        w2v.fit(topic_corpus(100))
        path = str(tmp_path / "vecs.txt")
        write_word_vectors(w2v, path)
        loaded = read_word_vectors(path)
        assert set(loaded) == {w.word for w in w2v.vocab.words}
        np.testing.assert_allclose(loaded["cat"], w2v.word_vector("cat"),
                                   rtol=1e-4, atol=1e-5)

    def test_serializer_roundtrip_binary(self, tmp_path):
        w2v = Word2Vec(layer_size=16, min_word_frequency=2, epochs=2, seed=0, device="cpu")
        w2v.fit(topic_corpus(100))
        path = str(tmp_path / "vecs.bin")
        write_word_vectors(w2v, path, binary=True)
        loaded = read_word_vectors(path, binary=True)
        np.testing.assert_allclose(loaded["dog"], w2v.word_vector("dog"), rtol=1e-6)

    def test_empty_vocab_raises(self):
        with pytest.raises(ValueError, match="vocabulary"):
            Word2Vec(min_word_frequency=100, device="cpu").fit(["one two three"])

    def test_load_static_model(self, tmp_path):
        w2v = Word2Vec(layer_size=16, min_word_frequency=2, epochs=4, seed=0, device="cpu")
        w2v.fit(topic_corpus(200))
        path = str(tmp_path / "static.txt")
        write_word_vectors(w2v, path)
        static = tnlp.load_static_model(path)
        np.testing.assert_allclose(static.word_vector("cat"),
                                   w2v.word_vector("cat"), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(static.similarity("cat", "dog"),
                                   w2v.similarity("cat", "dog"), atol=1e-4)
        assert set(static.words_nearest("cat", 3)) == set(w2v.words_nearest("cat", 3))

    def test_assigned_tensor_or_readonly_array_stays_mutable(self):
        """The lazy-table contract: an assigned tensor or read-only array
        becomes a MUTABLE host copy; a writable array passes through."""
        w2v = Word2Vec(layer_size=8, min_word_frequency=1, epochs=1, seed=0, device="cpu")
        w2v.fit(["cat dog fish", "dog cat bird"])
        assert isinstance(w2v._syn0_pending, torch.Tensor)   # still on the device
        assert w2v.syn0.flags.writeable and w2v._syn0_pending is None
        t = torch.ones((len(w2v.vocab), 8))
        w2v.syn0 = t
        assert w2v.syn0.flags.writeable
        w2v.syn0[0, 0] = 42.0                     # must not raise, nor reach t
        assert float(t[0, 0]) == 1.0
        ro = np.ones((len(w2v.vocab), 8), np.float32)
        ro.flags.writeable = False
        w2v.syn0 = ro
        assert w2v.syn0.flags.writeable and w2v.syn0 is not ro
        host = np.zeros((len(w2v.vocab), 8), np.float32)
        w2v.syn0 = host
        assert w2v.syn0 is host

    def test_cuda_is_the_default_device_and_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Word2Vec(layer_size=8)


class TestNativeWindowGenerator:
    def test_pair_stream_structure_matches_oracle(self):
        from deeplearning4j_tpu_torch.nlp._native_windows import sg_windows
        result = sg_windows(
            np.asarray([5, 6, 7, 8, 9, 1, 2, 3], np.int32),
            np.asarray([0, 0, 0, 0, 0, 1, 1, 1], np.int32), window=3, seed=42)
        assert result is not None, "the native window library did not build"
        tokens = np.asarray([5, 6, 7, 8, 9, 1, 2, 3])
        sids = np.asarray([0, 0, 0, 0, 0, 1, 1, 1])
        cen, tgt, pos = result
        assert len(cen) == len(tgt) == len(pos) > 0
        assert (np.diff(pos) >= 0).all()
        by_center = {}
        for c, t, p in zip(cen, tgt, pos):
            assert tokens[p] == c
            by_center.setdefault(int(p), []).append(int(t))
        for i, ts in by_center.items():
            js = [j for j in range(len(tokens)) if j != i and sids[j] == sids[i]]
            b = max(abs(j - i) for j in js if tokens[j] in ts)
            assert 1 <= b <= 3
            assert sorted(ts) == sorted(int(tokens[j]) for j in js if abs(j - i) <= b)

    def test_no_cross_sentence_pairs(self):
        from deeplearning4j_tpu_torch.nlp._native_windows import sg_windows
        cen, tgt, _ = sg_windows(np.asarray([10, 11, 12, 20, 21, 22], np.int32),
                                 np.asarray([0, 0, 0, 1, 1, 1], np.int32), window=5, seed=7)
        for c, t in zip(cen, tgt):
            assert (c < 20) == (t < 20), (c, t)

    def test_window_zero_raises_cleanly(self):
        with pytest.raises(ValueError, match="window"):
            Word2Vec(layer_size=8, window=0, device="cpu")

    @pytest.mark.parametrize("seed", [0, 42, 2**63 + 5])
    def test_native_stream_is_the_references(self, seed):
        """Both packages compile the same ``native/w2v_window.cpp``: the
        same block gives the same pairs, bit for bit."""
        from deeplearning4j_tpu.nlp._native_windows import sg_windows as jw
        from deeplearning4j_tpu_torch.nlp._native_windows import sg_windows as tw
        rng = np.random.default_rng(3)
        toks = rng.integers(0, 50, 500).astype(np.int32)
        sids = np.sort(rng.integers(0, 40, 500)).astype(np.int32)
        want, got = jw(toks, sids, 5, seed), tw(toks, sids, 5, seed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

    def test_failed_build_is_logged_and_falls_back(self, monkeypatch, caplog):
        from deeplearning4j_tpu_torch.nlp import _native_windows as nw
        from deeplearning4j_tpu_torch.utils import native_build

        monkeypatch.setattr(nw, "_LIB", None)
        monkeypatch.setattr(native_build, "build_and_load", lambda *a, **k: None)
        with caplog.at_level("WARNING", logger="deeplearning4j_tpu_torch"):
            assert nw.sg_windows(np.zeros(4, np.int32), np.zeros(4, np.int32), 2, 0) is None
        assert any("numpy pair stream" in r.getMessage() for r in caplog.records)
        # the fit still runs, on the numpy stream
        w2v = Word2Vec(layer_size=8, min_word_frequency=1, epochs=1, seed=0, device="cpu")
        w2v.fit(["cat dog fish", "dog cat bird"])
        assert np.isfinite(w2v.syn0).all()


# ---------------------------------------------------------------------------
# the negatives: bitwise jax.random
# ---------------------------------------------------------------------------


def _jkey(seed):
    import jax
    return jax.random.PRNGKey(np.uint32(seed))


def _tkey(seed):
    return sampling.prng_key(torch.tensor(int(seed)))


@pytest.mark.parametrize("seed", [0, 1, 977, 12345, 2**31 + 11, 2**32 - 1])
@pytest.mark.parametrize("counter", [0, 3, 4095, 2**31 + 7])
def test_split_randint_uniform_are_jax_random_bitwise(seed, counter):
    import jax

    jk = jax.random.fold_in(_jkey(seed), np.uint32(counter))
    tk = sampling.fold_in(_tkey(seed), torch.tensor(counter))
    np.testing.assert_array_equal(np.asarray(jk), [int(tk[0]), int(tk[1])])
    for num in (2, 3):
        for j, (a, b) in enumerate(zip(jax.random.split(jk, num), sampling.split(tk, num))):
            np.testing.assert_array_equal(np.asarray(a), [int(b[0]), int(b[1])])
    for shape in [(1,), (7, 3), (64, 5)]:
        n = int(np.prod(shape))
        for lo, hi in [(0, 1), (0, 16), (0, 2000), (0, 65536), (0, 65537), (0, 100000), (3, 9)]:
            want = np.asarray(jax.random.randint(jk, shape, lo, hi))
            got = sampling.randint(tk, n, lo, hi).reshape(shape).numpy()
            np.testing.assert_array_equal(got, want)
        want = np.asarray(jax.random.uniform(jk, shape))
        got = sampling.uniform(tk, n).reshape(shape).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("vocab", [16, 2000, 100000])
@pytest.mark.parametrize("rows,n_neg", [(128, 5), (64, 2)])
def test_device_negatives_are_the_references(vocab, rows, n_neg):
    """``_device_negs`` over a stack of counters: bitwise the reference's
    jitted sampler on a Zipf table (alias tables built by both)."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.nlp.sequencevectors import _build_alias_table as jalias
    from deeplearning4j_tpu.nlp.sequencevectors import _device_negs as jnegs
    from deeplearning4j_tpu_torch.nlp.sequencevectors import _build_alias_table as talias
    from deeplearning4j_tpu_torch.nlp.sequencevectors import _device_negs as tnegs

    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    p = p ** 0.75
    p /= p.sum()
    jp, ja = jalias(p)
    tp, ta = talias(p)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ta, ja)
    seed = int(np.random.SeedSequence([12345, 977]).generate_state(1)[0])
    counters = np.asarray([0, 1, 2, 15, 16, 1000], np.uint32)
    want = np.asarray(jnegs(_jkey(seed), jnp.asarray(counters),
                            (jnp.asarray(jp.astype(np.float32)),
                             jnp.asarray(ja.astype(np.int32))), n_neg, rows))
    got = tnegs(_tkey(seed), torch.from_numpy(counters.astype(np.int64)),
                (torch.from_numpy(tp.astype(np.float32)), torch.from_numpy(ta)), n_neg, rows)
    np.testing.assert_array_equal(got.numpy(), want)
    # one counter at a time is the same draw as the stack
    for i, c in enumerate(counters):
        one = tnegs(_tkey(seed), torch.tensor([int(c)]),
                    (torch.from_numpy(tp.astype(np.float32)), torch.from_numpy(ta)), n_neg, rows)
        np.testing.assert_array_equal(one.numpy(), want[i * rows:(i + 1) * rows])


# ---------------------------------------------------------------------------
# vocabulary, Huffman and the pair stream: bitwise
# ---------------------------------------------------------------------------


def _zipf_corpus(n_sent=300, vocab=60, seed=0, length=12):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    p /= p.sum()
    return [[f"w{i}" for i in rng.choice(vocab, size=int(rng.integers(1, length)), p=p)]
            for _ in range(n_sent)]


def test_vocab_and_huffman_are_the_references():
    corpus = _zipf_corpus()
    j = jnlp.build_vocab(corpus, 2)
    t = tnlp.build_vocab(corpus, 2)
    assert [(w.word, w.count, w.index) for w in j.words] == \
        [(w.word, w.count, w.index) for w in t.words]
    np.testing.assert_array_equal(t.unigram_table(), j.unigram_table())
    jnlp.Huffman(j)
    tnlp.Huffman(t)
    assert [(w.codes, w.points) for w in j.words] == [(w.codes, w.points) for w in t.words]


class _Recorder:
    """Records every call of the skip-gram step seam and leaves the tables
    as they are."""

    def __init__(self):
        self.calls = []

    def __call__(self, owner, syn0, syn1, centers, contexts, negatives, valid, lr, chunks=1):
        as_np = lambda a: np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
        self.calls.append((as_np(centers).astype(np.int64), as_np(contexts).astype(np.int64),
                           as_np(negatives).astype(np.int64), as_np(valid),
                           np.asarray(as_np(lr), np.float32).reshape(-1), chunks))
        return syn0, syn1


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("subsampling", [0.0, 1e-2])
def test_pair_stream_lr_and_negatives_are_the_references(monkeypatch, native, subsampling):
    """Every batch the step seam sees — centers, contexts, negatives, valid
    rows, per-batch LR, chunk count — bitwise the reference's, on the
    native pair generator and on the numpy fallback, with subsampling."""
    import deeplearning4j_tpu.nlp._native_windows as jnw
    import deeplearning4j_tpu_torch.nlp._native_windows as tnw

    if not native:
        monkeypatch.setattr(jnw, "sg_windows", lambda *a, **k: None)
        monkeypatch.setattr(tnw, "sg_windows", lambda *a, **k: None)
    rec = {}
    for name, mod in (("ref", jnlp), ("port", tnlp)):
        r = rec[name] = _Recorder()
        monkeypatch.setattr(mod.SequenceVectors, "_sg_step",
                            lambda self, *a, _r=r: _r(self, *a))
    kw = dict(layer_size=8, window=4, min_word_frequency=1, negative=3, epochs=2,
              batch_size=64, seed=3, subsampling=subsampling)
    corpus = _zipf_corpus(200)
    jnlp.SequenceVectors(**kw).fit_sequences(corpus)
    tnlp.SequenceVectors(device="cpu", **kw).fit_sequences(corpus)
    assert len(rec["port"].calls) == len(rec["ref"].calls) > 2
    for got, want in zip(rec["port"].calls, rec["ref"].calls):
        for a, b in zip(got[:5], want[:5]):
            np.testing.assert_array_equal(a, b)
        assert got[5] == want[5]


# ---------------------------------------------------------------------------
# the update steps on the same inputs
# ---------------------------------------------------------------------------


def _step_inputs(seed=0, V=40, D=16, B=64, K=5, W=6):
    rng = np.random.default_rng(seed)
    syn0 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    syn1 = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    # few distinct rows: every batch repeats rows many times
    centers = rng.integers(0, 8, B).astype(np.int32)
    contexts = rng.integers(0, V, B).astype(np.int32)
    negs = rng.integers(0, V, (B, K)).astype(np.int32)
    valid = (np.arange(B) < B - 7).astype(np.float32)
    ctx = rng.integers(0, V, (B, W)).astype(np.int32)
    cmask = (rng.random((B, W)) < 0.7).astype(np.float32)
    cmask[-3:] = 0.0
    return syn0, syn1, centers, contexts, negs, valid, ctx, cmask


def _t(a):
    a = torch.from_numpy(np.array(a))
    return a.long() if a.dtype == torch.int32 else a


@pytest.mark.parametrize("chunks", [1, 4])
def test_sg_and_cbow_steps_are_the_references(chunks):
    import jax.numpy as jnp

    from deeplearning4j_tpu.nlp import sequencevectors as J
    from deeplearning4j_tpu_torch.nlp import sequencevectors as T

    syn0, syn1, c, t, n, v, ctx, cm = _step_inputs()
    lr = np.asarray([0.05, 0.04, 0.03, 0.02][:chunks], np.float32) if chunks > 1 \
        else np.float32(0.05)
    want = J._sg_neg_step(jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(c), jnp.asarray(t),
                          jnp.asarray(n), jnp.asarray(v), jnp.asarray(lr), chunks)
    got = T._sg_neg_step(_t(syn0), _t(syn1), _t(c), _t(t), _t(n), _t(v),
                         _t(lr) if chunks > 1 else float(lr), chunks)
    for a, b in zip(got, want):
        _close(a, b, 1e-5, 1e-6)
    want = J._cbow_neg_step(jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(ctx),
                            jnp.asarray(cm), jnp.asarray(c), jnp.asarray(n),
                            jnp.asarray(lr), chunks)
    got = T._cbow_neg_step(_t(syn0), _t(syn1), _t(ctx), _t(cm), _t(c), _t(n),
                           _t(lr) if chunks > 1 else float(lr), chunks)
    for a, b in zip(got, want):
        _close(a, b, 1e-5, 1e-6)


@pytest.mark.parametrize("chunks", [1, 4])
def test_hs_step_is_the_references(chunks):
    import jax.numpy as jnp

    from deeplearning4j_tpu.nlp import sequencevectors as J
    from deeplearning4j_tpu_torch.nlp import sequencevectors as T

    rng = np.random.default_rng(1)
    syn0, syn1, c, _, _, _, _, _ = _step_inputs(1)
    pts = rng.integers(0, 39, (64, 6)).astype(np.int32)
    cds = rng.integers(0, 2, (64, 6)).astype(np.float32)
    msk = (rng.random((64, 6)) < 0.8).astype(np.float32)
    msk[-5:] = 0
    lr = np.float32(0.03)
    want = J._sg_hs_step(jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(c),
                         jnp.asarray(pts), jnp.asarray(cds), jnp.asarray(msk),
                         jnp.asarray(lr), chunks)
    got = T._sg_hs_step(_t(syn0), _t(syn1), _t(c), _t(pts), _t(cds), _t(msk), float(lr), chunks)
    for a, b in zip(got, want):
        _close(a, b, 1e-5, 1e-6)


def test_occurrence_scale_and_inference_steps_are_the_references():
    import jax.numpy as jnp

    from deeplearning4j_tpu.nlp import sequencevectors as J
    from deeplearning4j_tpu_torch.nlp import sequencevectors as T

    syn0, syn1, c, t, n, v, ctx, cm = _step_inputs(2)
    np.testing.assert_array_equal(
        T._occurrence_scale(_t(c), 40, _t(v)).numpy(),
        np.asarray(J._occurrence_scale(jnp.asarray(c), 40, jnp.asarray(v))))
    vec = np.random.default_rng(5).normal(0, 0.1, 16).astype(np.float32)
    want = J._infer_sg_step(jnp.asarray(vec), jnp.asarray(syn1), jnp.asarray(t),
                            jnp.asarray(n), jnp.asarray(v), jnp.float32(0.02))
    _close(T._infer_sg_step(_t(vec), _t(syn1), _t(t), _t(n), _t(v), 0.02), want, 1e-5, 1e-6)
    want = J._infer_dm_step(jnp.asarray(vec), jnp.asarray(syn0), jnp.asarray(syn1),
                            jnp.asarray(ctx), jnp.asarray(cm), jnp.asarray(t),
                            jnp.asarray(n), jnp.asarray(v), jnp.float32(0.02))
    _close(T._infer_dm_step(_t(vec), _t(syn0), _t(syn1), _t(ctx), _t(cm), _t(t), _t(n),
                            _t(v), 0.02), want, 1e-5, 1e-6)


def test_repeated_rows_sum_in_index_order():
    """``add_rows`` sums duplicates (``t[idx] += v`` would keep one) in
    index order: bitwise a Python loop over the rows."""
    from deeplearning4j_tpu_torch.ops.scatter import add_rows

    rng = np.random.default_rng(0)
    table = rng.normal(size=(5, 3)).astype(np.float32)
    idx = np.asarray([1, 1, 4, 1, 0, 4, 1])
    rows = rng.normal(size=(7, 3)).astype(np.float32)
    want = table.copy()
    for i, r in zip(idx, rows):
        want[i] = want[i] + r
    got = add_rows(torch.from_numpy(table.copy()), torch.from_numpy(idx),
                   torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["sg", "cbow", "dbow"])
def test_sixteen_stacked_batches_are_bitwise_one(mode):
    """The stacking promise: 16 batches a dispatch against one, bitwise."""
    def fit(k):
        if mode == "dbow":
            m = tnlp.ParagraphVectors(dm=False, layer_size=16, window=3, epochs=2,
                                      batch_size=64, seed=4, device="cpu")
        else:
            m = tnlp.Word2Vec(layer_size=16, window=3, min_word_frequency=1, epochs=2,
                              batch_size=64, seed=4, subsampling=0,
                              cbow=(mode == "cbow"), device="cpu")
        m._device_batches = k
        if mode == "dbow":
            m.fit(topic_corpus(120))
        else:
            m.fit(topic_corpus(200))
        return m.syn0, m.syn1
    for a, b in zip(fit(16), fit(1)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the word2vec C formats
# ---------------------------------------------------------------------------


def test_golden_fixtures_load_and_write_back_the_references_bytes(tmp_path):
    want = np.load(os.path.join(FIX, "w2v_golden_vectors.npy"))
    text = read_word_vectors(os.path.join(FIX, "w2v_golden.txt"), binary=False)
    assert sorted(text) == [f"word{i}" for i in range(5)]
    np.testing.assert_allclose(np.stack([text[f"word{i}"] for i in range(5)]), want, atol=1e-4)
    binv = read_word_vectors(os.path.join(FIX, "w2v_golden.bin"), binary=True)
    np.testing.assert_array_equal(np.stack([binv[f"word{i}"] for i in range(5)]), want)
    for binary, vecs in ((False, text), (True, binv)):
        port, ref = str(tmp_path / f"p{binary}"), str(tmp_path / f"r{binary}")
        write_word_vectors(vecs, port, binary=binary)
        jnlp.write_word_vectors(vecs, ref, binary=binary)
        with open(port, "rb") as f, open(ref, "rb") as g:
            assert f.read() == g.read()
    with open(os.path.join(FIX, "w2v_golden.bin"), "rb") as f, \
            open(str(tmp_path / "pTrue"), "rb") as g:
        assert g.read() == f.read()


def test_a_fitted_models_vectors_write_the_references_bytes(tmp_path):
    """A port model and a reference model holding the same table write the
    same files, both formats."""
    w2v = Word2Vec(layer_size=8, min_word_frequency=2, epochs=1, seed=0, device="cpu")
    w2v.fit(topic_corpus(60))
    ref = jnlp.Word2Vec(layer_size=8, min_word_frequency=2, epochs=1, seed=0)
    ref.fit(topic_corpus(60))
    ref.syn0 = w2v.syn0.copy()
    for binary in (False, True):
        a, b = str(tmp_path / f"a{binary}"), str(tmp_path / f"b{binary}")
        write_word_vectors(w2v, a, binary=binary)
        jnlp.write_word_vectors(ref, b, binary=binary)
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()
