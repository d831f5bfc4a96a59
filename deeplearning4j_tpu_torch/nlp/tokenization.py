"""Tokenization — TokenizerFactory registry + preprocessors + CJK.

Parity targets: reference text/tokenization/ (DefaultTokenizerFactory
wraps a streaming whitespace tokenizer; CommonPreprocessor lowercases and
strips punctuation) and the CJK language packs —
deeplearning4j-nlp-chinese/.../ChineseTokenizer.java (word segmentation),
deeplearning4j-nlp-japanese (kuromoji), deeplearning4j-nlp-korean.

Zero-egress inversion of the language packs: their ~19.7K LoC are mostly
VENDORED DICTIONARIES + analyzer glue.  The capability — segmenting
unspaced CJK text into trainable tokens — is covered by
``CJKTokenizerFactory``: longest-match against a user-supplied dictionary
(the hook where a real lexicon slots in), falling back to overlapping
bigrams (the standard statistical-IR baseline for CJK) or single
characters.  The registry (``register_tokenizer_factory`` /
``get_tokenizer_factory``) mirrors the reference's pluggable
TokenizerFactory class-name configuration.

A copy of ``deeplearning4j_tpu/nlp/tokenization.py``: tokenization is
Python on the host and touches no device.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence


class CommonPreprocessor:
    """Lowercase + strip punctuation (reference CommonPreprocessor)."""

    _PUNCT = re.compile(r"[!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~«»“”‘’]")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class CasePreservingPreprocessor(CommonPreprocessor):
    """Strip punctuation but KEEP case — POS tagging needs capitalization
    (the NNP heuristic); used as the PosFilterTokenizerFactory default."""

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token)


class EndingPreProcessor:
    """Crude English stemmer (reference EndingPreProcessor: strips s/ed/ing/ly)."""

    def pre_process(self, token: str) -> str:
        for suffix in ("ing", "ed", "ly", "s"):
            if token.endswith(suffix) and len(token) > len(suffix) + 2:
                return token[: -len(suffix)]
        return token


class DefaultTokenizerFactory:
    """Whitespace/regex tokenizer factory (reference DefaultTokenizerFactory).

    Preprocessing is memoized per distinct raw token: corpora are Zipfian,
    so the regex/lower work runs once per vocabulary entry instead of once
    per token occurrence (measured ~3× tokenizer throughput on the w2v
    bench corpus; the cache is capped to bound adversarial memory)."""

    _CACHE_CAP = 1 << 20

    def __init__(self, preprocessor=None):
        self._cache: Dict[str, str] = {}
        self.preprocessor = preprocessor or CommonPreprocessor()

    @property
    def preprocessor(self):
        return self._preprocessor

    @preprocessor.setter
    def preprocessor(self, value) -> None:
        # the memo cache holds the OLD preprocessor's outputs — swapping
        # preprocessors mid-stream must not serve stale results
        self._preprocessor = value
        self._cache.clear()

    def tokenize(self, sentence: str) -> List[str]:
        if self.preprocessor is None:
            return sentence.split()
        cache = self._cache
        toks = sentence.split()
        try:  # warm-cache fast path: direct hashing, no per-token branches
            return [p for p in [cache[t] for t in toks] if p]
        except KeyError:
            pass
        pre = self.preprocessor.pre_process
        out = []
        for t in toks:
            p = cache.get(t)
            if p is None:
                p = pre(t)
                if len(cache) < self._CACHE_CAP:
                    cache[t] = p
            if p:
                out.append(p)
        return out


def _is_cjk(ch: str) -> bool:
    """CJK Unified Ideographs (+ext A), Hiragana, Katakana, Hangul."""
    o = ord(ch)
    return (0x4E00 <= o <= 0x9FFF      # CJK Unified Ideographs
            or 0x3400 <= o <= 0x4DBF   # CJK Extension A
            or 0x3040 <= o <= 0x309F   # Hiragana
            or 0x30A0 <= o <= 0x30FF   # Katakana
            or 0xAC00 <= o <= 0xD7AF   # Hangul syllables
            or 0x1100 <= o <= 0x11FF)  # Hangul jamo


class CJKTokenizerFactory:
    """Segmenter for unspaced CJK text with a user-dictionary hook.

    ``mode`` selects the in-run algorithm:
      - "lattice" (kuromoji's algorithm class, reference
        deeplearning4j-nlp-japanese vendored ViterbiBuilder): build a word
        lattice over the run from dictionary entries + single-char
        fallback nodes and take the min-cost Viterbi path.  Dictionary
        words cost ``-log f(w)`` when ``user_dictionary`` is a
        {word: frequency} mapping (uniform when a plain sequence), so
        overlapping entries resolve globally — where greedy longest-match
        commits to 研究生|命, the lattice picks 研究|生命 when the
        frequencies say so.  Unmatched chars ride fallback nodes whose
        cost exceeds any dictionary word.
      - "bigram": greedy longest-match against the dictionary, unmatched
        spans become overlapping character bigrams (standard CJK IR
        baseline; a single leftover char becomes a unigram)
      - "char": greedy longest-match; unmatched spans one char per token
    Non-CJK spans (latin words, digits) tokenize by whitespace with the
    preprocessor applied, so mixed-script corpora work end-to-end.

    Dictionary entries may carry a POS tag — value ``(frequency, tag)``
    instead of a bare frequency — and ``tokenize_with_tags`` /
    ``tag`` expose them per token (the kuromoji lexicon's POS column,
    reference deeplearning4j-nlp-japanese).  The factory then plugs into
    ``PosFilterTokenizerFactory`` as BOTH base and tagger for
    POS-filtered CJK vectorization.
    """

    #: fallback unigram cost — higher than any realistic dictionary word
    #: (-log f with f normalized over the dictionary stays below ~20)
    _FALLBACK_COST = 25.0

    #: tag emitted for tokens with no dictionary POS (fallback chars,
    #: bigrams, unknown words) — kuromoji's unknown-word analog
    UNKNOWN_TAG = "X"

    def __init__(self, user_dictionary=None,
                 mode: str = "bigram", preprocessor=None):
        if mode not in ("bigram", "char", "lattice"):
            raise ValueError(
                f"mode must be 'bigram', 'char' or 'lattice', got {mode!r}")
        self.mode = mode
        self.preprocessor = preprocessor or CommonPreprocessor()
        # dictionary values: frequency, (frequency, pos_tag), or
        # (frequency, pos_tag, base_form) — the morphological surfaces the
        # reference's kuromoji dictionaries carry
        # (deeplearning4j-nlp-japanese vendored lexicon rows hold POS and
        # base-form columns next to the cost); tags are opaque strings
        # (名詞/動詞 for a Japanese lexicon, NN/JJ for an English one) and
        # base_form is the lemma a conjugated surface reduces to
        # (食べた → 食べる, kuromoji Token.getBaseForm)
        self._pos: Dict[str, str] = {}
        self._base: Dict[str, str] = {}
        if isinstance(user_dictionary, dict):
            freqs = {}
            for w, v in user_dictionary.items():
                if isinstance(v, (tuple, list)):
                    if len(v) not in (2, 3):
                        raise ValueError(
                            f"dictionary entry {w!r}: expected frequency, "
                            f"(frequency, pos_tag) or (frequency, pos_tag, "
                            f"base_form), got {v!r}")
                    freqs[w] = v[0]
                    self._pos[w] = str(v[1])
                    if len(v) == 3:
                        self._base[w] = str(v[2])
                else:
                    freqs[w] = v
            if any(c <= 0 for c in freqs.values()):
                raise ValueError("user_dictionary frequencies must be > 0")
            total = float(sum(freqs.values()))
            # works for raw counts AND probability-valued frequencies —
            # only the ratios matter to the Viterbi comparison
            self._costs = {w: -math.log(c / total)
                           for w, c in freqs.items()}
        else:
            # uniform frequencies; mild length bonus keeps longest-match
            # behavior for non-overlapping text
            self._costs = {w: 10.0 - 0.01 * len(w)
                           for w in (user_dictionary or ())}
        self.dictionary = set(self._costs)
        self._max_word = max((len(w) for w in self.dictionary), default=0)
        self._latin_tagger = None  # lazy RuleBasedPosTagger for mixed text

    def _segment_lattice(self, run: str) -> List[str]:
        """Min-cost Viterbi path through the word lattice."""
        n = len(run)
        best = [math.inf] * (n + 1)
        back: List[Optional[tuple]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == math.inf:
                continue
            # fallback single-char edge keeps the lattice connected
            c = best[i] + self._FALLBACK_COST
            if c < best[i + 1]:
                best[i + 1] = c
                back[i + 1] = (i, run[i])
            for L in range(1, min(self._max_word, n - i) + 1):
                w = run[i:i + L]
                wc = self._costs.get(w)
                if wc is not None and best[i] + wc < best[i + L]:
                    best[i + L] = best[i] + wc
                    back[i + L] = (i, w)
        out: List[str] = []
        pos = n
        while pos > 0:
            prev, w = back[pos]
            out.append(w)
            pos = prev
        return out[::-1]

    def _segment_cjk(self, run: str) -> List[str]:
        if self.mode == "lattice":
            return self._segment_lattice(run)
        out: List[str] = []
        i, n = 0, len(run)
        pending_start = 0

        def flush_fallback(start: int, end: int) -> None:
            span = run[start:end]
            if not span:
                return
            if self.mode == "char" or len(span) == 1:
                out.extend(span)
            else:
                out.extend(span[j:j + 2] for j in range(len(span) - 1))

        while i < n:
            match = None
            if self.dictionary:
                for L in range(min(self._max_word, n - i), 0, -1):
                    if run[i:i + L] in self.dictionary:
                        match = run[i:i + L]
                        break
            if match:
                flush_fallback(pending_start, i)
                out.append(match)
                i += len(match)
                pending_start = i
            else:
                i += 1
        flush_fallback(pending_start, n)
        return out

    def tokenize(self, sentence: str) -> List[str]:
        tokens: List[str] = []
        buf: List[str] = []  # non-CJK accumulator

        def flush_non_cjk() -> None:
            if buf:
                for t in "".join(buf).split():
                    t = self.preprocessor.pre_process(t) if self.preprocessor else t
                    if t:
                        tokens.append(t)
                buf.clear()

        i = 0
        while i < len(sentence):
            if _is_cjk(sentence[i]):
                flush_non_cjk()
                j = i
                while j < len(sentence) and _is_cjk(sentence[j]):
                    j += 1
                tokens.extend(self._segment_cjk(sentence[i:j]))
                i = j
            else:
                buf.append(sentence[i])
                i += 1
        flush_non_cjk()
        return tokens

    def tag(self, tokens: Sequence[str]) -> List[str]:
        """POS tags for already-segmented tokens: dictionary entries carry
        their lexicon tag (kuromoji's per-token POS surface), unknown CJK
        tokens get UNKNOWN_TAG, and latin tokens in mixed-script text fall
        through to the rule-based English tagger.  This signature makes
        the factory directly usable as PosFilterTokenizerFactory's
        ``tagger`` (with itself as ``base``)."""
        out = []
        for t in tokens:
            tag = self._pos.get(t)
            if tag is not None:
                out.append(tag)
            elif t and _is_cjk(t[0]):
                out.append(self.UNKNOWN_TAG)
            else:
                if self._latin_tagger is None:
                    self._latin_tagger = RuleBasedPosTagger()
                out.append(self._latin_tagger.tag([t])[0])
        return out

    def tokenize_with_tags(self, sentence: str) -> List[tuple]:
        """(token, pos_tag) pairs — the lattice/segmenter output annotated
        with the dictionary's POS column (reference kuromoji
        Token.getPartOfSpeechLevel1)."""
        toks = self.tokenize(sentence)
        return list(zip(toks, self.tag(toks)))

    def base_form(self, token: str) -> str:
        """The dictionary lemma for a surface form, or the surface itself
        (reference kuromoji Token.getBaseForm: conjugated 食べた → 食べる)."""
        return self._base.get(token, token)

    def tokenize_with_morphology(self, sentence: str) -> List[tuple]:
        """(surface, pos_tag, base_form) triples — the full per-token
        morphological surface of the reference's Japanese analyzer."""
        toks = self.tokenize(sentence)
        return [(t, g, self.base_form(t))
                for t, g in zip(toks, self.tag(toks))]


# ---------------------------------------------------------------------------
# POS tagging hook (the deeplearning4j-nlp-uima PosUimaTokenizerFactory role)
# ---------------------------------------------------------------------------


class RuleBasedPosTagger:
    """Dependency-free English POS tagger: closed-class lookup + suffix
    heuristics (the pluggable default — swap in any ``tag(tokens)``
    callable for a real model).  Tags follow the Penn treebank names the
    reference's UIMA annotators emit."""

    _CLOSED = {
        "the": "DT", "a": "DT", "an": "DT", "this": "DT", "that": "DT",
        "these": "DT", "those": "DT",
        "i": "PRP", "you": "PRP", "he": "PRP", "she": "PRP", "it": "PRP",
        "we": "PRP", "they": "PRP", "me": "PRP", "him": "PRP", "her": "PRP",
        "them": "PRP", "us": "PRP",
        "my": "PRP$", "your": "PRP$", "his": "PRP$", "its": "PRP$",
        "our": "PRP$", "their": "PRP$",
        "in": "IN", "on": "IN", "at": "IN", "by": "IN", "for": "IN",
        "with": "IN", "from": "IN", "of": "IN", "to": "TO", "as": "IN",
        "into": "IN", "over": "IN", "under": "IN",
        "and": "CC", "or": "CC", "but": "CC", "nor": "CC",
        "is": "VBZ", "are": "VBP", "was": "VBD", "were": "VBD",
        "be": "VB", "been": "VBN", "being": "VBG", "am": "VBP",
        "have": "VBP", "has": "VBZ", "had": "VBD",
        "do": "VBP", "does": "VBZ", "did": "VBD",
        "will": "MD", "would": "MD", "can": "MD", "could": "MD",
        "shall": "MD", "should": "MD", "may": "MD", "might": "MD",
        "must": "MD",
        "not": "RB", "very": "RB", "quite": "RB", "too": "RB",
    }

    def tag(self, tokens: Sequence[str]) -> List[str]:
        out = []
        for t in tokens:
            low = t.lower()
            if low in self._CLOSED:
                out.append(self._CLOSED[low])
            elif low.replace(".", "", 1).replace(",", "").isdigit():
                out.append("CD")
            elif low.endswith("ly"):
                out.append("RB")
            elif low.endswith("ing") and len(low) > 4:
                out.append("VBG")
            elif low.endswith("ed") and len(low) > 3:
                out.append("VBD")
            elif low.endswith(("ous", "ful", "ive", "able", "ible", "al",
                               "ic")) and len(low) > 4:
                out.append("JJ")
            elif low.endswith("s") and not low.endswith(("ss", "us", "is")) \
                    and len(low) > 3:
                out.append("NNS")
            elif t[:1].isupper():
                out.append("NNP")
            else:
                out.append("NN")
        return out


class PosFilterTokenizerFactory:
    """Tokenize with ``base`` then keep only tokens whose POS tag is in
    ``allowed_tags`` (reference PosUimaTokenizerFactory: tokens outside the
    allowed set are stripped before vectorization).  ``tagger`` is any
    object with ``tag(tokens) -> tags`` — rule-based English default."""

    def __init__(self, allowed_tags: Sequence[str], base=None, tagger=None,
                 preprocessor=None):
        # default base preserves case: lowercasing before tagging would
        # make the NNP (proper noun) heuristic unreachable
        self.base = base or DefaultTokenizerFactory(
            preprocessor=preprocessor or CasePreservingPreprocessor())
        self.allowed = set(allowed_tags)
        self.tagger = tagger or RuleBasedPosTagger()

    def tokenize(self, sentence: str) -> List[str]:
        tokens = self.base.tokenize(sentence)
        tags = self.tagger.tag(tokens)
        return [t for t, g in zip(tokens, tags) if g in self.allowed]

    def tokenize_with_tags(self, sentence: str) -> List[tuple]:
        """(token, tag) pairs without filtering — the annotation surface."""
        tokens = self.base.tokenize(sentence)
        return list(zip(tokens, self.tagger.tag(tokens)))


class BaseFormTokenizerFactory:
    """Tokenize with ``base`` then replace each surface form by its
    dictionary lemma (reference kuromoji BaseFormFilter behavior: train
    vectors on 食べる regardless of which conjugation appeared).  ``base``
    is any factory with a ``base_form(token)`` method — the CJK factory
    with (frequency, pos_tag, base_form) dictionary entries."""

    def __init__(self, base):
        if not hasattr(base, "base_form"):
            raise ValueError("base factory must expose base_form(token) — "
                             "use CJKTokenizerFactory with (frequency, "
                             "pos_tag, base_form) dictionary entries")
        self.base = base

    def tokenize(self, sentence: str) -> List[str]:
        return [self.base.base_form(t) for t in self.base.tokenize(sentence)]


#: name → factory constructor (the reference configures TokenizerFactory
#: by class name; this registry is the same seam without reflection)
_TOKENIZER_FACTORIES: Dict[str, Callable[..., object]] = {}


def register_tokenizer_factory(name: str, ctor: Callable[..., object]) -> None:
    _TOKENIZER_FACTORIES[name.lower()] = ctor


def get_tokenizer_factory(name: str, **kwargs):
    """Build a registered tokenizer factory by name
    ('default', 'cjk', 'chinese', 'japanese', 'korean', ...)."""
    key = name.lower()
    if key not in _TOKENIZER_FACTORIES:
        raise ValueError(f"unknown tokenizer factory {name!r} "
                         f"(known: {sorted(_TOKENIZER_FACTORIES)})")
    return _TOKENIZER_FACTORIES[key](**kwargs)


register_tokenizer_factory("default", DefaultTokenizerFactory)
register_tokenizer_factory("cjk", CJKTokenizerFactory)
register_tokenizer_factory("pos", PosFilterTokenizerFactory)
register_tokenizer_factory("baseform", BaseFormTokenizerFactory)
# the language-specific names share the CJK segmenter; a real lexicon
# arrives via user_dictionary (the vendored-dictionary seam)
register_tokenizer_factory("chinese", CJKTokenizerFactory)
register_tokenizer_factory("japanese", CJKTokenizerFactory)
register_tokenizer_factory("korean", CJKTokenizerFactory)


class SentenceSegmenter:
    """Rule-based sentence boundary detection (the deeplearning4j-nlp-uima
    SentenceAnnotator role, dependency-free): splits on .!?… followed by
    whitespace + an uppercase/digit/CJK start, protecting common
    abbreviations and decimal numbers."""

    # always-protected abbreviations vs ones that are ordinary words at a
    # genuine sentence end ("she said no.", "the old st."): the latter
    # only protect when the next sentence starts with a digit ("No. 5")
    _ABBREV = {"mr", "mrs", "ms", "dr", "prof", "sr", "jr", "vs",
               "etc", "e.g", "i.e", "inc", "ltd", "co"}
    _ABBREV_NUM = {"no", "fig", "vol", "st", "p", "pp"}
    # CJK terminators split with NO following whitespace (real CJK prose
    # has none); latin terminators require it (protects decimals/initials)
    _BOUNDARY = re.compile(r"(?<=[。！？])\s*|(?<=[.!?…])\s+")

    def segment(self, text: str) -> List[str]:
        parts = self._BOUNDARY.split(text.strip())
        out: List[str] = []
        for p in parts:
            p = p.strip()
            if not p:
                continue
            if out:
                prev = out[-1]
                last_word = prev[:-1].rsplit(None, 1)[-1].lower() if " " in prev \
                    else prev[:-1].lower()
                # re-join: abbreviation before the split, or a lowercase
                # continuation (the boundary regex can't look back far)
                word = last_word.rstrip(".")
                abbrev = prev.endswith(".") and (
                    word in self._ABBREV
                    or (word in self._ABBREV_NUM and p[:1].isdigit()))
                if abbrev or p[:1].islower():
                    out[-1] = prev + " " + p
                    continue
            out.append(p)
        return out


class TextSentenceIterator:
    """Raw-text sentence iterator: SentenceSegmenter over whole documents
    (reference UimaSentenceIterator's role — feed documents, iterate
    sentences)."""

    def __init__(self, documents: Iterable[str], segmenter=None):
        self.documents = documents
        self.segmenter = segmenter or SentenceSegmenter()

    def __iter__(self) -> Iterable[str]:
        for doc in self.documents:
            yield from self.segmenter.segment(doc)


class LineSentenceIterator:
    """Sentence-per-line corpus iterator (reference BasicLineIterator)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterable[str]:
        with open(self.path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


class CollectionSentenceIterator:
    def __init__(self, sentences: List[str]):
        self.sentences = sentences

    def __iter__(self):
        return iter(self.sentences)


class AggregatingSentenceIterator:
    """Chain several sentence iterators (reference
    AggregatingSentenceIterator), with an optional per-sentence
    preprocessor (reference SentencePreProcessor)."""

    def __init__(self, *iterators, preprocessor: Optional[Callable[[str], str]] = None):
        self.iterators = list(iterators)
        self.preprocessor = preprocessor

    def __iter__(self):
        for it in self.iterators:
            for s in it:
                yield self.preprocessor(s) if self.preprocessor else s
