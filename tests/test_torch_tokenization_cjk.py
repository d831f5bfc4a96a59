"""The port's tokenizers (``deeplearning4j_tpu_torch/nlp/tokenization.py``)
against the JAX package's: every case of ``tests/test_tokenization_cjk.py``
gives the same token lists (and tag and base-form pairs) in both
packages and the reference test's expected values, and the CJK Word2Vec
pipelines train on the port (on the CPU) to the reference's vocabulary."""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp.tokenization as J
import deeplearning4j_tpu_torch.nlp.tokenization as T
from deeplearning4j_tpu_torch.nlp import Word2Vec


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the fits run thousands of tiny ops, which
    several test workers sharing the cores would otherwise oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POS_DICT = {"研究": (100, "名詞"), "生命": (80, "名詞"), "する": (200, "動詞"),
            "を": (500, "助詞"), "猫": (50, "名詞"), "犬": (50, "名詞"),
            "食べる": (40, "動詞"), "の": (600, "助詞")}
BASE_DICT = {"食べた": (30, "動詞", "食べる"), "食べる": (40, "動詞"),
             "猫": (50, "名詞"), "が": (500, "助詞"), "を": (500, "助詞"),
             "魚": (40, "名詞")}

# (id, factory(module), method, text, expected)
CASES = [
    ("char", lambda m: m.CJKTokenizerFactory(mode="char"), "tokenize", "我爱北京",
     ["我", "爱", "北", "京"]),
    ("bigram", lambda m: m.CJKTokenizerFactory(mode="bigram"), "tokenize", "我爱北京",
     ["我爱", "爱北", "北京"]),
    ("unigram_run", lambda m: m.CJKTokenizerFactory(mode="bigram"), "tokenize", "我", ["我"]),
    ("user_dict_longest", lambda m: m.CJKTokenizerFactory(
        user_dictionary=["北京", "北京大学"], mode="char"), "tokenize", "我爱北京大学",
     ["我", "爱", "北京大学"]),
    ("dict_bigram_fallback", lambda m: m.CJKTokenizerFactory(
        user_dictionary=["東京"], mode="bigram"), "tokenize", "私は東京です", None),
    ("mixed_script", lambda m: m.CJKTokenizerFactory(
        user_dictionary=["机器学习"], mode="char"), "tokenize", "我用 JAX 做机器学习 v2!", None),
    ("hangul", lambda m: m.CJKTokenizerFactory(mode="char"), "tokenize", "한국", ["한", "국"]),
    ("kana", lambda m: m.CJKTokenizerFactory(mode="char"), "tokenize", "カタカナ", None),
    ("registry_kwargs", lambda m: m.get_tokenizer_factory(
        "chinese", user_dictionary=["北京"], mode="char"), "tokenize", "北京", ["北京"]),
    ("lattice_overlap", lambda m: m.CJKTokenizerFactory(
        user_dictionary={"研究": 100, "研究生": 5, "生命": 80, "命": 10}, mode="lattice"),
     "tokenize", "研究生命", ["研究", "生命"]),
    ("greedy_trap", lambda m: m.CJKTokenizerFactory(
        user_dictionary=["研究", "研究生", "生命", "命"], mode="bigram"),
     "tokenize", "研究生命", ["研究生", "命"]),
    ("lattice_fallback", lambda m: m.CJKTokenizerFactory(
        user_dictionary={"東京": 10}, mode="lattice"), "tokenize", "東京都", ["東京", "都"]),
    ("lattice_nothing", lambda m: m.CJKTokenizerFactory(
        user_dictionary={"東京": 10}, mode="lattice"), "tokenize", "大阪", ["大", "阪"]),
    ("lattice_mixed", lambda m: m.CJKTokenizerFactory(
        user_dictionary={"機械": 5, "学習": 5}, mode="lattice"), "tokenize",
     "hello 機械学習 world", ["hello", "機械", "学習", "world"]),
    ("lattice_longest", lambda m: m.CJKTokenizerFactory(
        user_dictionary=["北京", "北京大学", "大学"], mode="lattice"), "tokenize",
     "北京大学", ["北京大学"]),
    ("pos_filter", lambda m: m.PosFilterTokenizerFactory(allowed_tags=["NN", "NNS", "NNP"]),
     "tokenize", "the fast dog jumped over the lazy cats", ["fast", "dog", "lazy", "cats"]),
    ("pos_pairs", lambda m: m.PosFilterTokenizerFactory(allowed_tags=["NN", "NNS", "NNP"]),
     "tokenize_with_tags", "the dog jumped", [("the", "DT"), ("dog", "NN"), ("jumped", "VBD")]),
    ("pos_registry", lambda m: m.get_tokenizer_factory("pos", allowed_tags=["NN"]),
     "tokenize", "the dog jumped", ["dog"]),
    ("lattice_tags", lambda m: m.CJKTokenizerFactory(user_dictionary=POS_DICT, mode="lattice"),
     "tokenize_with_tags", "研究を生命する",
     [("研究", "名詞"), ("を", "助詞"), ("生命", "名詞"), ("する", "動詞")]),
    ("unknown_tags", lambda m: m.CJKTokenizerFactory(
        user_dictionary=POS_DICT, mode="lattice",
        preprocessor=m.CasePreservingPreprocessor()), "tokenize_with_tags", "猫が JAX", None),
    ("plain_freqs", lambda m: m.CJKTokenizerFactory(
        user_dictionary={"研究": 100, "生命": 80}, mode="lattice"), "tokenize", "研究生命",
     ["研究", "生命"]),
    ("pos_compose", lambda m: m.PosFilterTokenizerFactory(
        allowed_tags=["名詞"], base=m.CJKTokenizerFactory(user_dictionary=POS_DICT,
                                                         mode="lattice"),
        tagger=m.CJKTokenizerFactory(user_dictionary=POS_DICT, mode="lattice")),
     "tokenize", "研究を生命する", ["研究", "生命"]),
    ("morphology", lambda m: m.CJKTokenizerFactory(user_dictionary=BASE_DICT, mode="lattice"),
     "tokenize_with_morphology", "猫が魚を食べた",
     [("猫", "名詞", "猫"), ("が", "助詞", "が"), ("魚", "名詞", "魚"), ("を", "助詞", "を"),
      ("食べた", "動詞", "食べる")]),
    ("base_forms", lambda m: m.BaseFormTokenizerFactory(
        m.CJKTokenizerFactory(user_dictionary=BASE_DICT, mode="lattice")),
     "tokenize", "魚を食べた", ["魚", "を", "食べる"]),
    ("baseform_registry", lambda m: m.get_tokenizer_factory(
        "baseform", base=m.CJKTokenizerFactory(user_dictionary=BASE_DICT, mode="lattice")),
     "tokenize", "食べた", ["食べる"]),
    ("default", lambda m: m.DefaultTokenizerFactory(), "tokenize",
     "Hello, World! Foo-bar. Don't stop", None),
]


@pytest.mark.parametrize("factory,method,text,expected", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_tokens_are_the_references(factory, method, text, expected):
    got = getattr(factory(T), method)(text)
    want = getattr(factory(J), method)(text)
    assert got == want
    if expected is not None:
        assert got == expected


def test_mixed_script_and_fallback_contents():
    toks = T.CJKTokenizerFactory(user_dictionary=["机器学习"], mode="char").tokenize(
        "我用 JAX 做机器学习 v2!")
    assert "jax" in toks and "机器学习" in toks and "v2" in toks
    toks = T.CJKTokenizerFactory(user_dictionary=["東京"], mode="bigram").tokenize("私は東京です")
    assert "東京" in toks and all(len(t) <= 2 for t in toks)
    assert T.CJKTokenizerFactory(mode="char").tokenize("カタカナ") != []


def test_tags_of_unknown_tokens():
    f = T.CJKTokenizerFactory(user_dictionary=POS_DICT, mode="lattice",
                              preprocessor=T.CasePreservingPreprocessor())
    got = dict(f.tokenize_with_tags("猫が JAX"))
    assert got["猫"] == "名詞" and got["が"] == f.UNKNOWN_TAG and got["JAX"] == "NNP"
    g = T.CJKTokenizerFactory(user_dictionary={"研究": 100}, mode="lattice")
    assert g.tag(["研究"]) == [g.UNKNOWN_TAG]


def test_rule_based_tagger_and_segmenter_are_the_references():
    words = ["the", "quick", "dog", "quickly", "jumped", "over", "3", "fences", "running"]
    assert T.RuleBasedPosTagger().tag(words) == J.RuleBasedPosTagger().tag(words) == \
        ["DT", "NN", "NN", "RB", "VBD", "IN", "CD", "NNS", "VBG"]
    for text, want in [("Hello world. How are you? Fine!",
                        ["Hello world.", "How are you?", "Fine!"]),
                       ("Dr. Smith arrived. He was late.", ["Dr. Smith arrived.", "He was late."]),
                       ("这是第一句。这是第二句。", ["这是第一句。", "这是第二句。"])]:
        assert T.SentenceSegmenter().segment(text) == J.SentenceSegmenter().segment(text) == want
    docs = ["The dog barked. The cat slept." for _ in range(20)]
    assert list(T.TextSentenceIterator(docs)) == list(J.TextSentenceIterator(docs))


def test_registry_and_iterators():
    for name in ("default", "cjk", "chinese", "japanese", "korean"):
        assert T.get_tokenizer_factory(name) is not None
    with pytest.raises(ValueError, match="default"):
        T.get_tokenizer_factory("klingon")

    class Upper:
        def tokenize(self, s):
            return s.upper().split()

    T.register_tokenizer_factory("upper-test-port", Upper)
    assert T.get_tokenizer_factory("upper-test-port").tokenize("a b") == ["A", "B"]
    it = T.AggregatingSentenceIterator(T.CollectionSentenceIterator(["a b", "c"]),
                                       T.CollectionSentenceIterator(["d"]),
                                       preprocessor=str.upper)
    assert list(it) == ["A B", "C", "D"]
    with pytest.raises(ValueError, match="mode"):
        T.CJKTokenizerFactory(mode="word")
    with pytest.raises(ValueError, match="frequency"):
        T.CJKTokenizerFactory(user_dictionary={"研究": (1, "名詞", "研究", "extra")})
    with pytest.raises(ValueError, match="base_form"):
        T.BaseFormTokenizerFactory(T.DefaultTokenizerFactory())
    assert isinstance(Word2Vec(tokenizer_factory="cjk", device="cpu").tokenizer,
                      T.CJKTokenizerFactory)


def test_word2vec_trains_on_unspaced_cjk_corpus():
    from deeplearning4j_tpu.nlp import Word2Vec as JW

    rng = np.random.default_rng(0)
    animals = ["猫咪", "狗狗", "宠物", "毛皮"]
    computers = ["电脑", "内存", "代码", "芯片"]
    sentences = ["".join(rng.choice(animals if rng.integers(0, 2) == 0 else computers, size=8))
                 for _ in range(300)]
    kw = dict(layer_size=32, window=3, min_word_frequency=2, epochs=12, batch_size=128,
              learning_rate=0.05, seed=1, subsampling=0)
    w2v = Word2Vec(device="cpu", tokenizer_factory=T.CJKTokenizerFactory(
        user_dictionary=animals + computers, mode="char"), **kw)
    w2v.fit(sentences)
    assert w2v.has_word("猫咪") and w2v.has_word("电脑")
    within, across = w2v.similarity("猫咪", "狗狗"), w2v.similarity("猫咪", "电脑")
    assert within > across + 0.2, f"within={within:.3f} across={across:.3f}"
    ref = JW(tokenizer_factory=J.CJKTokenizerFactory(user_dictionary=animals + computers,
                                                     mode="char"), **kw).fit(sentences)
    np.testing.assert_allclose(w2v.syn0, ref.syn0, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["pos", "baseform", "pos_latin"])
def test_filtered_word2vec_vocabularies(kind):
    rng = np.random.default_rng(0)
    if kind == "pos":
        nouns, fillers = ["研究", "生命", "猫", "犬"], ["を", "の", "する", "食べる"]
        sentences = ["".join(str(rng.choice(nouns)) + str(rng.choice(fillers)) for _ in range(6))
                     for _ in range(200)]
        cjk = T.CJKTokenizerFactory(user_dictionary=POS_DICT, mode="lattice")
        f = T.PosFilterTokenizerFactory(allowed_tags=["名詞"], base=cjk, tagger=cjk)
        w2v = Word2Vec(layer_size=16, window=3, min_word_frequency=2, epochs=2, batch_size=128,
                       seed=1, subsampling=0, tokenizer_factory=f, device="cpu")
        w2v.fit(sentences)
        assert {w.word for w in w2v.vocab.words} == set(nouns)
    elif kind == "baseform":
        sentences = ["猫が魚を" + ("食べた" if rng.integers(0, 2) else "食べる") for _ in range(100)]
        f = T.BaseFormTokenizerFactory(T.CJKTokenizerFactory(user_dictionary=BASE_DICT,
                                                             mode="lattice"))
        w2v = Word2Vec(layer_size=8, window=2, min_word_frequency=2, epochs=1, seed=1,
                       subsampling=0, tokenizer_factory=f, device="cpu")
        w2v.fit(sentences)
        assert w2v.has_word("食べる") and not w2v.has_word("食べた")
    else:
        f = T.PosFilterTokenizerFactory(allowed_tags=["NN", "NNS", "NNP"])
        w2v = Word2Vec(layer_size=16, min_word_frequency=1, epochs=1, window=2,
                       tokenizer_factory=f, device="cpu")
        w2v.fit(["the dog chased the cat over the fence"] * 30)
        assert all(w in w2v.vocab for w in ("dog", "cat", "fence"))
        assert "the" not in w2v.vocab and "chased" not in w2v.vocab
