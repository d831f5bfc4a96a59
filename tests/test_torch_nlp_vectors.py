"""The port's SequenceVectors, ParagraphVectors and GloVe
(``deeplearning4j_tpu_torch/nlp``) against the JAX package's on the CPU.

``tests/test_nlp_vectors.py``'s semantic gates run on the port; beyond
them, PV-DM, PV-DBOW (negative sampling and hierarchical softmax),
generic-element and GloVe fits from one seed are within rtol 1e-4,
atol 1e-5 of the reference's tables, ``infer_vector`` is deterministic
given its seed and within the same tolerance of the reference's on the
same tables, ``_glove_step`` matches on the same inputs, and the
co-occurrence counts are the reference's dictionary exactly.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as jnlp
from deeplearning4j_tpu_torch.nlp import (
    CoOccurrences, Glove, ParagraphVectors, SequenceVectors,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the fits run thousands of tiny ops, which
    several test workers sharing the cores would otherwise oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ANIMALS = ["cat", "dog", "pet", "fur", "paw", "tail", "meow", "bark"]
TECH = ["cpu", "ram", "disk", "code", "byte", "chip", "core", "cache"]


def topic_docs(n_docs=120, words_per_doc=20, seed=0):
    rng = np.random.default_rng(seed)
    docs, labels, topics = [], [], []
    for i in range(n_docs):
        t = int(rng.integers(0, 2))
        vocab = ANIMALS if t == 0 else TECH
        docs.append(" ".join(rng.choice(vocab, size=words_per_doc)))
        labels.append(f"DOC_{i}")
        topics.append(t)
    return docs, labels, topics


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _within_across(pv, labels, topics):
    vecs = np.stack([pv.doc_vector(lb) for lb in labels])
    vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-9)
    t = np.asarray(topics)
    sims = vecs @ vecs.T
    off = ~np.eye(len(t), dtype=bool)
    return sims[(t[:, None] == t[None, :]) & off].mean(), sims[t[:, None] != t[None, :]].mean()


class TestSequenceVectors:
    def test_generic_elements(self):
        rng = np.random.default_rng(3)
        seqs = []
        for _ in range(400):
            base = 0 if rng.integers(0, 2) == 0 else 10
            seqs.append([int(base + x) for x in rng.integers(0, 8, size=8)])
        kw = dict(layer_size=32, window=3, min_word_frequency=2, epochs=12,
                  batch_size=128, seed=1, learning_rate=0.05)
        sv = SequenceVectors(device="cpu", **kw).fit_sequences(seqs)
        within = sv.similarity(0, 1)
        across = sv.similarity(0, 10)
        assert within > across + 0.2, f"within={within:.3f} across={across:.3f}"
        ref = jnlp.SequenceVectors(**kw).fit_sequences(seqs)
        _close(sv.syn0, ref.syn0)


class TestParagraphVectors:
    @pytest.mark.parametrize("dm", [True, False], ids=["dm", "dbow"])
    def test_doc_vectors_cluster_and_fit_is_the_references(self, dm):
        docs, labels, topics = topic_docs()
        kw = dict(dm=dm, layer_size=24, window=3, epochs=20, batch_size=128, seed=1,
                  learning_rate=0.05)
        pv = ParagraphVectors(device="cpu", **kw)
        pv.fit(docs, labels)
        within, across = _within_across(pv, labels, topics)
        assert within > across + 0.15, f"dm={dm}: within={within:.3f} across={across:.3f}"
        ref = jnlp.ParagraphVectors(**kw)
        ref.fit(docs, labels)
        assert ref.label_index == pv.label_index
        _close(pv.syn0, ref.syn0)
        _close(pv.syn1, ref.syn1)
        # inference from the same tables and seed is the reference's
        a = pv.infer_vector(["cat", "dog", "pet", "fur"], steps=50, seed=3)
        ref.syn0, ref.syn1 = pv.syn0.copy(), pv.syn1.copy()
        b = ref.infer_vector(["cat", "dog", "pet", "fur"], steps=50, seed=3)
        _close(a, b, 1e-5, 1e-6)

    @pytest.mark.parametrize("dm", [True, False], ids=["dm", "dbow"])
    def test_infer_unseen_doc(self, dm):
        docs, labels, topics = topic_docs()
        pv = ParagraphVectors(dm=dm, layer_size=24, window=3, epochs=20,
                              batch_size=128, seed=1, learning_rate=0.05, device="cpu")
        pv.fit(docs, labels)
        inferred = pv.infer("cat dog pet fur meow bark tail paw cat dog")
        assert inferred.shape == (24,)
        near = pv.nearest_labels(inferred, top_n=10)
        t_by_label = dict(zip(labels, topics))
        animal_hits = sum(1 for lb in near if t_by_label[lb] == 0)
        assert animal_hits >= 8, f"only {animal_hits}/10 animal docs: {near}"

    def test_infer_is_deterministic_given_seed(self):
        docs, labels, _ = topic_docs(40)
        pv = ParagraphVectors(dm=False, layer_size=16, epochs=3, batch_size=128, seed=1,
                              device="cpu")
        pv.fit(docs, labels)
        a = pv.infer_vector(["cat", "dog", "pet"], seed=5)
        b = pv.infer_vector(["cat", "dog", "pet"], seed=5)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, pv.infer_vector(["cat", "dog", "pet"], seed=6))

    def test_requires_labels_match(self):
        pv = ParagraphVectors(layer_size=8, device="cpu")
        with pytest.raises(ValueError, match="labels"):
            pv.fit_sequences([["a", "b"]], labels=["x", "y"])

    def test_unsupported_combos_rejected(self):
        with pytest.raises(NotImplementedError, match="DM"):
            ParagraphVectors(dm=True, hierarchic_softmax=True, device="cpu")
        with pytest.raises(NotImplementedError, match="CBOW"):
            SequenceVectors(cbow=True, hierarchic_softmax=True, device="cpu")

    def test_dbow_with_hierarchical_softmax(self):
        docs, labels, topics = topic_docs()
        kw = dict(dm=False, hierarchic_softmax=True, layer_size=24, window=3, epochs=20,
                  batch_size=128, seed=1, learning_rate=0.05)
        pv = ParagraphVectors(device="cpu", **kw)
        pv.fit(docs, labels)
        within, across = _within_across(pv, labels, topics)
        assert within > across + 0.15, f"within={within:.3f} across={across:.3f}"
        ref = jnlp.ParagraphVectors(**kw)
        ref.fit(docs, labels)
        _close(pv.syn0, ref.syn0)
        with pytest.raises(NotImplementedError, match="hierarchical"):
            pv.infer_vector(["cat"])

    def test_words_nearest_excludes_label_rows(self):
        docs, labels, _ = topic_docs(40)
        pv = ParagraphVectors(dm=False, layer_size=16, epochs=3, batch_size=128, seed=1,
                              device="cpu")
        pv.fit(docs, labels)
        near = pv.words_nearest("cat", top_n=10)
        assert all(isinstance(w, str) and not w.startswith("DOC_") for w in near)


def _glove_sentences(n=300):
    rng = np.random.default_rng(0)
    sentences = []
    for _ in range(n):
        vocab = ANIMALS if rng.integers(0, 2) == 0 else TECH
        sentences.append(" ".join(rng.choice(vocab, size=10)))
    return sentences


class TestGlove:
    def test_cooccurrence_weighting(self):
        cooc = CoOccurrences(window=2, symmetric=True).count(
            [np.asarray([0, 1, 2], np.int32)])
        assert cooc[(0, 1)] == 1.0 and cooc[(1, 0)] == 1.0
        assert cooc[(0, 2)] == 0.5 and cooc[(2, 0)] == 0.5

    @pytest.mark.parametrize("vocab", [30, 3000])
    @pytest.mark.parametrize("window,symmetric", [(15, True), (5, False), (1, True)])
    def test_cooccurrences_are_the_references_dictionary(self, window, symmetric, vocab):
        """Same keys in the same insertion order, every weight bitwise, on a
        vocabulary of many repeated pairs and on one of mostly single pairs."""
        rng = np.random.default_rng(window)
        corpus = [rng.integers(0, vocab, int(rng.integers(0, 25))).astype(np.int32)
                  for _ in range(200)] + [np.zeros(0, np.int32)]
        want = jnlp.CoOccurrences(window, symmetric).count(corpus)
        got = CoOccurrences(window, symmetric).count(corpus)
        assert list(got) == list(want)
        np.testing.assert_array_equal(np.asarray(list(got.values())).view(np.int64),
                                      np.asarray(list(want.values())).view(np.int64))

    def test_glove_step_is_the_references(self):
        import jax.numpy as jnp

        from deeplearning4j_tpu.nlp.glove import _glove_step as jstep
        from deeplearning4j_tpu_torch.nlp.glove import _glove_step as tstep

        rng = np.random.default_rng(4)
        V, D, B = 20, 8, 64
        tabs = [rng.normal(0, 0.2, (V, D)), rng.normal(0, 0.2, (V, D)),
                rng.normal(0, 0.1, V), rng.normal(0, 0.1, V),
                1 + rng.random((V, D)), 1 + rng.random((V, D)), 1 + rng.random(V),
                1 + rng.random(V)]
        tabs = [t.astype(np.float32) for t in tabs]
        rows = rng.integers(0, 6, B).astype(np.int32)      # repeated rows
        cols = rng.integers(0, V, B).astype(np.int32)
        logx = rng.normal(0, 1, B).astype(np.float32)
        fx = rng.random(B).astype(np.float32)
        fx[-4:] = 0
        want = jstep(*[jnp.asarray(t) for t in tabs], jnp.asarray(rows), jnp.asarray(cols),
                     jnp.asarray(logx), jnp.asarray(fx), jnp.float32(0.05))
        tt = [torch.from_numpy(t.copy()) for t in tabs]
        loss = tstep(*tt, torch.from_numpy(rows).long(), torch.from_numpy(cols).long(),
                     torch.from_numpy(logx), torch.from_numpy(fx), 0.05)
        for got, w in zip(tt + [loss], want):
            _close(got.numpy(), w, 1e-5, 1e-6)

    def test_topics_separate_and_fit_is_the_references(self):
        sentences = _glove_sentences()
        kw = dict(layer_size=24, window=5, min_word_frequency=2, epochs=30,
                  learning_rate=0.05, seed=1)
        glove = Glove(device="cpu", **kw)
        glove.fit(sentences)
        assert len(glove.vocab) == 16
        assert glove.losses[-1] < glove.losses[0] * 0.5, glove.losses[::10]
        within = glove.similarity("cat", "dog")
        across = glove.similarity("cat", "cpu")
        assert within > across + 0.2, f"within={within:.3f} across={across:.3f}"
        nearest = glove.words_nearest("cat", top_n=7)
        assert len(set(nearest) & set(ANIMALS[1:])) >= 5, nearest
        ref = jnlp.Glove(**kw)
        ref.fit(sentences)
        _close(glove.syn0, ref.syn0)
        _close(glove.losses, ref.losses, 1e-4, 0)

    def test_small_batches_pad_like_the_reference(self):
        """A corpus whose entries do not fill the last batch: the padded
        rows are inert in both."""
        sentences = _glove_sentences(40)
        kw = dict(layer_size=8, window=3, min_word_frequency=1, epochs=4,
                  batch_size=100, seed=2)
        g = Glove(device="cpu", **kw).fit(sentences)
        r = jnlp.Glove(**kw).fit(sentences)
        _close(g.syn0, r.syn0)

    def test_empty_corpus_raises(self):
        with pytest.raises(ValueError, match="vocabulary|co-occurrence"):
            Glove(min_word_frequency=100, device="cpu").fit(["one two three"])
        with pytest.raises(ValueError, match="co-occurrence"):
            Glove(device="cpu").fit(["one", "two"])
