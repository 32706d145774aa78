"""BM25 lexical index — host-side inverted index, device-blendable output
(copy of rust_local_rag_tpu/ops/bm25.py; the native C++ index of the JAX
package is not part of this port yet).

Mirrors the reference's LexicalIndex (rag_engine.rs:2083-2237) exactly:
  * tokenize: split on non-alphanumeric, keep tokens with >= 3 chars,
    lowercase (rag_engine.rs:2242-2247). NOTE the reference filters on BYTE
    length before lowercasing; we match that by filtering on the raw token's
    UTF-8 byte length.
  * BM25 with k1 = 1.5, b = 0.75 (rag_engine.rs:2190-2191)
  * idf = max(ln((N - df + 0.5) / (df + 0.5)), 0) (rag_engine.rs:2197-2199)
  * score = idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl/avgdl))
    (rag_engine.rs:2208-2213)

Sparse scoring stays on host (a few thousand postings per query); the engine
scatters the top-`limit` scores into a dense slot-aligned vector that rides
into the device blend kernel (SURVEY.md §7 "BM25 blending").
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Set, Tuple


# runs of str.isalnum() characters: \w is isalnum() plus "_" in Python's
# re, so [^\W_] is exactly isalnum()
_ALNUM_RUN_RE = re.compile(r"[^\W_]+")


def tokenize(text: str) -> List[str]:
    """Lowercased unicode-alphanumeric tokens with raw length >= 3 bytes.

    Matches rag_engine.rs:2242-2247 (`token.len() >= 3` is a byte-length
    check in Rust; for ASCII corpora this equals the char count, and for
    multibyte text the byte check is reproduced here). Same tokens as the
    JAX package's per-character loop, found with one regex scan.
    """
    return [
        tok.lower()
        for tok in _ALNUM_RUN_RE.findall(text)
        if len(tok) >= 3 or len(tok.encode("utf-8")) >= 3
    ]


class LexicalIndex:
    """In-memory inverted index with BM25 scoring (reference-parity)."""

    K1 = 1.5
    B = 0.75

    def __init__(self) -> None:
        self.term_postings: Dict[str, Dict[str, int]] = {}
        self.doc_lengths: Dict[str, int] = {}
        self.doc_terms: Dict[str, Dict[str, int]] = {}
        self.total_docs = 0
        self.total_length = 0
        # chunk_id -> ChunkStore slab slot, maintained when callers add
        # chunks with an explicit slot; lets the engine skip the per-hit
        # string-id mapping on the query hot path (score_slots_into)
        self._id_to_slot: Dict[str, int] = {}
        self._slots_aligned = True

    @property
    def slots_aligned(self) -> bool:
        """True while every indexed chunk carried an explicit store slot
        (score_slots_into is exact only then)."""
        return self._slots_aligned

    def clear(self) -> None:
        self.term_postings.clear()
        self.doc_lengths.clear()
        self.doc_terms.clear()
        self.total_docs = 0
        self.total_length = 0
        self._id_to_slot.clear()
        self._slots_aligned = True

    def add_chunk(self, chunk_id: str, text: str, slot: int = None) -> None:
        if chunk_id in self.doc_terms:
            self.remove_chunk(chunk_id)
        if slot is None:
            self._slots_aligned = False
        else:
            self._id_to_slot[chunk_id] = int(slot)

        tokens = tokenize(text)
        if not tokens:
            return

        term_counts: Dict[str, int] = {}
        for tok in tokens:
            term_counts[tok] = term_counts.get(tok, 0) + 1

        doc_length = sum(term_counts.values())
        if doc_length == 0:
            return

        for term, count in term_counts.items():
            self.term_postings.setdefault(term, {})[chunk_id] = count

        self.doc_lengths[chunk_id] = doc_length
        self.doc_terms[chunk_id] = term_counts
        self.total_docs += 1
        self.total_length += doc_length

    def remove_chunk(self, chunk_id: str) -> None:
        self._id_to_slot.pop(chunk_id, None)
        term_counts = self.doc_terms.pop(chunk_id, None)
        if term_counts is not None:
            for term in term_counts:
                postings = self.term_postings.get(term)
                if postings is not None:
                    postings.pop(chunk_id, None)
                    if not postings:
                        del self.term_postings[term]
            length = self.doc_lengths.pop(chunk_id, None)
            if length is not None:
                self.total_length = max(0, self.total_length - length)
            if self.total_docs > 0:
                self.total_docs -= 1
        else:
            self.doc_lengths.pop(chunk_id, None)

        if self.total_docs == 0:
            self.total_length = 0

    def score(self, query: str, limit: int) -> List[Tuple[str, float]]:
        """Top-`limit` (chunk_id, bm25) pairs, descending (ties arbitrary,
        as in the reference's HashMap-order sort)."""
        if self.total_docs == 0:
            return []

        tokens = tokenize(query)
        if not tokens:
            return []

        unique_terms: Set[str] = set(tokens)
        avg_doc_len = (
            self.total_length / self.total_docs if self.total_docs else 0.0
        )

        scores: Dict[str, float] = {}
        for term in unique_terms:
            postings = self.term_postings.get(term)
            if not postings:
                continue
            df = float(len(postings))
            idf = max(
                math.log((self.total_docs - df + 0.5) / (df + 0.5)), 0.0
            )
            if idf == 0.0 and df >= 1024:
                # exact skip, matching the native index: a clamped-to-zero
                # idf contributes exactly 0 to every doc, so walking the
                # (by construction huge, df >= N/2) posting list only
                # produces zero-score entries that cannot affect the
                # hybrid blend (lex_norm 0). Small corpora keep the walk
                # so docs matching ONLY ubiquitous terms still show up in
                # the raw candidate list (historical contract).
                continue
            for doc_id, term_freq in postings.items():
                doc_length = float(self.doc_lengths.get(doc_id, 0))
                if doc_length == 0.0:
                    continue
                tf = float(term_freq)
                denom = tf + self.K1 * (
                    1.0 - self.B + self.B * (doc_length / avg_doc_len)
                )
                if denom == 0.0:
                    continue
                scores[doc_id] = scores.get(doc_id, 0.0) + idf * (
                    tf * (self.K1 + 1.0)
                ) / denom

        results = sorted(scores.items(), key=lambda kv: -kv[1])
        if limit > 0 and len(results) > limit:
            results = results[:limit]
        return results

    def unseen_mass(self, query: str) -> float:
        """IDF-weighted share of the query's terms the corpus has NEVER
        seen (df == 0), each weighted at the limiting idf ln((N+0.5)/0.5).

        A query whose informative terms are absent from the entire indexed
        corpus cannot be grounded by retrieval — this is the engine-level
        out-of-domain signal the joint rejection gate pairs with a
        dense-cosine ceiling (rag_engine.py). 0.0 on an empty query or
        empty index (never rejects). Duplicate terms count once.
        """
        if self.total_docs == 0:
            return 0.0
        terms = set(tokenize(query))
        if not terms:
            return 0.0
        idf_max = math.log((self.total_docs + 0.5) / 0.5)
        num = den = 0.0
        for term in terms:
            postings = self.term_postings.get(term)
            df = float(len(postings)) if postings else 0.0
            idf = (
                max(
                    math.log(
                        (self.total_docs - df + 0.5) / (df + 0.5)
                    ),
                    0.0,
                )
                if df
                else idf_max
            )
            den += idf
            if not df:
                num += idf
        return num / den if den else 0.0

    def score_slots_into(self, query: str, limit: int, out_slots, out_vals) -> int:
        """Hot-path scoring: write the top-`limit` hits as (store slot,
        score) directly into the caller's int32/f32 row buffers, skipping
        the per-hit (chunk_id, score) tuple list. Only valid while
        slots_aligned. Returns the number of hits written."""
        if not self._slots_aligned:
            raise RuntimeError("index has chunks without registered slots")
        n = 0
        for cid, s in self.score(query, limit):
            slot = self._id_to_slot.get(cid)
            if slot is None or n >= len(out_slots):
                continue
            out_slots[n] = slot
            out_vals[n] = s
            n += 1
        return n

    def compile_all(self) -> int:
        """Interface parity with the native index's snapshot precompile;
        the pure-Python scorer has no compiled form."""
        return 0

    def contains(self, chunk_id: str) -> bool:
        return chunk_id in self.doc_terms

    def drop_stale(self, valid_ids: Set[str] | Iterable[str]) -> None:
        valid = set(valid_ids)
        for stale in [cid for cid in self.doc_terms if cid not in valid]:
            self.remove_chunk(stale)
