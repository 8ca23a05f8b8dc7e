"""Text preprocessing: the keras_preprocessing.text API in numpy (a
copy of flexflow_tpu/keras/preprocessing/text.py)."""
from __future__ import annotations

import collections
from typing import Dict, List, Optional

import numpy as np

_FILTERS = '!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n'


def text_to_word_sequence(text: str, filters: str = _FILTERS,
                          lower: bool = True, split: str = " ") -> List[str]:
    if lower:
        text = text.lower()
    text = text.translate(str.maketrans(filters, split * len(filters)))
    return [w for w in text.split(split) if w]


def one_hot(text: str, n: int, filters: str = _FILTERS, lower: bool = True,
            split: str = " ") -> List[int]:
    """Hashing-trick word ids in [1, n) (collisions possible, as in the
    keras original)."""
    words = text_to_word_sequence(text, filters, lower, split)
    return [(hash(w) % (n - 1)) + 1 for w in words]


class Tokenizer:
    """Corpus vocabulary fitting + text -> id-sequence conversion.

    Word index is 1-based (0 is reserved for padding); when `num_words`
    is set, only the num_words-1 most frequent words convert, matching
    the keras contract the reuters/imdb pipelines rely on."""

    def __init__(self, num_words: Optional[int] = None,
                 filters: str = _FILTERS, lower: bool = True,
                 split: str = " ", oov_token: Optional[str] = None):
        self.num_words = num_words
        self.filters = filters
        self.lower = lower
        self.split = split
        self.oov_token = oov_token
        self.word_counts: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict())
        self.word_docs: Dict[str, int] = collections.defaultdict(int)
        self.word_index: Dict[str, int] = {}
        self.index_word: Dict[int, str] = {}
        self.index_docs: Dict[int, int] = {}
        self.document_count = 0

    def fit_on_texts(self, texts):
        for text in texts:
            self.document_count += 1
            words = text_to_word_sequence(text, self.filters, self.lower,
                                          self.split)
            for w in words:
                self.word_counts[w] = self.word_counts.get(w, 0) + 1
            for w in set(words):
                self.word_docs[w] += 1
        by_freq = sorted(self.word_counts.items(),
                         key=lambda kv: (-kv[1], kv[0]))
        vocab = [w for w, _ in by_freq]
        if self.oov_token is not None:
            vocab = [self.oov_token] + vocab
        self.word_index = {w: i + 1 for i, w in enumerate(vocab)}
        self.index_word = {i: w for w, i in self.word_index.items()}
        self.index_docs = {
            self.word_index[w]: c for w, c in self.word_docs.items()
        }

    def _id(self, w: str) -> Optional[int]:
        i = self.word_index.get(w)
        if i is None or (self.num_words and i >= self.num_words):
            if self.oov_token is not None:
                return self.word_index[self.oov_token]
            return None
        return i

    def texts_to_sequences(self, texts) -> List[List[int]]:
        out = []
        for text in texts:
            ids = [self._id(w) for w in text_to_word_sequence(
                text, self.filters, self.lower, self.split)]
            out.append([i for i in ids if i is not None])
        return out

    def texts_to_matrix(self, texts, mode: str = "binary") -> np.ndarray:
        if mode not in ("binary", "count", "freq", "tfidf"):
            raise ValueError(f"unknown mode {mode!r}")
        n = self.num_words or (len(self.word_index) + 1)
        seqs = self.texts_to_sequences(texts)
        m = np.zeros((len(seqs), n), np.float32)
        for r, seq in enumerate(seqs):
            if not seq:
                continue
            counts = collections.Counter(seq)
            for idx, c in counts.items():
                if mode == "binary":
                    m[r, idx] = 1.0
                elif mode == "count":
                    m[r, idx] = c
                elif mode == "freq":
                    m[r, idx] = c / len(seq)
                else:  # tfidf: idf from FIT-TIME document frequencies,
                    # so featurization is batch-independent (keras
                    # semantics: document_count/index_docs at fit)
                    tf = 1.0 + np.log(c)
                    df = self.index_docs.get(idx, 0)
                    m[r, idx] = tf * np.log(
                        1 + self.document_count / (1.0 + df))
        return m
