"""BM25 of the reference, vectorised over documents given as word ids.

The semantics are the system's lexical index (the Rust reference's
rag_engine.rs:2083-2247): tokens are lowercased runs of alphanumeric
characters of 3 bytes or more; k1 = 1.5, b = 0.75; idf = max(ln((N - df +
0.5) / (df + 0.5)), 0); score = sum over the query's distinct terms of idf
* tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl)), in f64.

The benchmark draws every word from a vocabulary of lowercase ASCII words
of three letters or more, so `tokenize` of a text is exactly its words,
and a document is its array of word ids (tests hold the two forms equal).
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

K1 = 1.5
B = 0.75

_ALNUM_RUN = re.compile(r"[^\W_]+")


def tokenize(text: str) -> List[str]:
    """Lowercased alphanumeric runs of at least 3 bytes."""
    return [t.lower() for t in _ALNUM_RUN.findall(text) if len(t.encode("utf-8")) >= 3]


class Bm25:
    """An index over documents `words[offsets[i]:offsets[i + 1]]` (word ids
    below `vocab_size`)."""

    def __init__(self, words: np.ndarray, offsets: np.ndarray, vocab_size: int):
        n_docs = len(offsets) - 1
        doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), np.diff(offsets))
        keys, tf = np.unique(words.astype(np.int64) * n_docs + doc_of, return_counts=True)
        term = keys // n_docs
        self.post_doc = (keys % n_docs).astype(np.int64)  # sorted by term, then doc
        self.post_tf = tf.astype(np.float64)
        self.term_ptr = np.searchsorted(term, np.arange(vocab_size + 1))
        self.doc_len = np.diff(offsets).astype(np.float64)
        self.n_docs = int(np.count_nonzero(self.doc_len))
        self.avgdl = float(self.doc_len.sum()) / max(self.n_docs, 1)

    def scores(self, query_terms) -> np.ndarray:
        """[n_docs] f64 BM25 of every document (0 where no term matches)."""
        out = np.zeros(len(self.doc_len), dtype=np.float64)
        for t in sorted(set(int(x) for x in query_terms)):
            lo, hi = self.term_ptr[t], self.term_ptr[t + 1]
            df = float(hi - lo)
            if df == 0:
                continue
            idf = max(np.log((self.n_docs - df + 0.5) / (df + 0.5)), 0.0)
            docs, tf = self.post_doc[lo:hi], self.post_tf[lo:hi]
            denom = tf + K1 * (1.0 - B + B * (self.doc_len[docs] / self.avgdl))
            out[docs] += idf * tf * (K1 + 1.0) / denom
        return out
