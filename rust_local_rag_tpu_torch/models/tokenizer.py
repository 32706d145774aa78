"""Tokenization for the port's encoder and reranker.

Two backends, as in rust_local_rag_tpu/models/tokenizer.py:
  * WordPieceTokenizer: a pure-Python reading of a local tokenizer.json
    (WordPiece model; NFD + Lowercase + StripAccents normaliser;
    WhitespaceSplit + isolated Punctuation pre-tokeniser; added tokens;
    "[CLS] $A [SEP]" template). It gives the ids the JAX package's
    HuggingFace and native tokenizers give, without the ``tokenizers``
    package.
  * HashTokenizer: deterministic and vocabulary-free (copied verbatim).

Both produce [batch, L] int32 id matrices plus masks padded to a bucketed
length, the shapes the JAX package's encoder sees, and the reranker's fixed
[batch, seq_len] head + tail packing (encode_batch_headtail).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Reserved ids for the hash tokenizer
PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
UNK_ID = 3
_N_SPECIAL = 4

_WORD_RE = re.compile(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]")

# Padding buckets: sequences pad up to the nearest bucket to bound the
# number of distinct compiled shapes.
DEFAULT_BUCKETS = (64, 128, 256, 512)


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def bucket_batch(n: int) -> int:
    """Round a batch dimension up to a power of two (bounds the number of
    compiled batch shapes; padded rows are dropped by the caller)."""
    b = 1
    while b < n:
        b *= 2
    return b


def headtail_pack(
    rows: Sequence[Sequence[int]], seq_len: int, pad_id: int = PAD_ID
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack untruncated token rows into fixed [B, seq_len] with the judge
    trainer's truncation: rows longer than seq_len keep the HEAD seq_len//3
    + the TAIL remainder, so the trailing yes/no question and "Answer:" cue
    survive (training/train_reranker.py PromptPairBatcher._encode). The
    serving judge MUST encode through this same function: round 4 traced the
    rejection-gate leak (junk yes-p 0.65 at serve vs 0.07 in training) to
    serving head-only truncation at max_len=512 — every long prompt was
    judged at RoPE positions and cut points the judge never trained on."""
    B = len(rows)
    ids = np.full((B, seq_len), pad_id, dtype=np.int32)
    mask = np.zeros((B, seq_len), dtype=np.int32)
    head = seq_len // 3
    for b, r in enumerate(rows):
        r = list(r)
        if len(r) > seq_len:
            r = r[:head] + r[-(seq_len - head):]
        ids[b, : len(r)] = r
        mask[b, : len(r)] = 1
    return ids, mask


class HashTokenizer:
    """Deterministic hashing tokenizer (vocab-free).

    Each lowercase word maps to `_N_SPECIAL + blake2b(word) % (vocab - 4)`.
    Collisions are rare at vocab 30k for natural text and irrelevant for the
    retrieval-stack plumbing this backs.
    """

    def __init__(self, vocab_size: int = 30528, max_len: int = 512):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def tokenize(self, text: str) -> List[int]:
        ids = [CLS_ID]
        for w in _WORD_RE.findall(text.lower()):
            h = int.from_bytes(
                hashlib.blake2b(w.encode("utf-8"), digest_size=8).digest(), "little"
            )
            ids.append(_N_SPECIAL + h % (self.vocab_size - _N_SPECIAL))
            if len(ids) >= self.max_len - 1:
                break
        ids.append(SEP_ID)
        return ids

    def tokenize_full(self, text: str) -> List[int]:
        """Untruncated ids (head/tail packing needs the real tail)."""
        ids = [CLS_ID]
        for w in _WORD_RE.findall(text.lower()):
            h = int.from_bytes(
                hashlib.blake2b(w.encode("utf-8"), digest_size=8).digest(), "little"
            )
            ids.append(_N_SPECIAL + h % (self.vocab_size - _N_SPECIAL))
        ids.append(SEP_ID)
        return ids

    def encode_batch_headtail(
        self, texts: Sequence[str], seq_len: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-shape [B, seq_len] judge encoding (see headtail_pack)."""
        return headtail_pack([self.tokenize_full(t) for t in texts], seq_len, PAD_ID)

    def encode_batch(
        self, texts: Sequence[str], buckets: Sequence[int] = DEFAULT_BUCKETS
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids [B, L], mask [B, L]) padded to a bucketed length."""
        tokenized = [self.tokenize(t) for t in texts]
        longest = max((len(t) for t in tokenized), default=1)
        L = bucket_length(min(longest, self.max_len), buckets)
        ids = np.full((len(texts), L), PAD_ID, dtype=np.int32)
        mask = np.zeros((len(texts), L), dtype=np.int32)
        for i, toks in enumerate(tokenized):
            toks = toks[:L]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask



# Rust's char::is_whitespace (the White_Space property), which the
# WhitespaceSplit pre-tokeniser splits on. Python's str.isspace() also
# accepts U+001C..U+001F, so the set is spelled out.
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005"
    "\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000"
)
_ASCII_PUNCT = "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
# ASCII fast path of the pre-tokeniser: each punctuation char alone, runs
# of everything else between whitespace
_ASCII_WORD_RE = re.compile(
    "[" + re.escape(_ASCII_PUNCT) + "]|[^\t\n\x0b\x0c\r " + re.escape(_ASCII_PUNCT) + "]+"
)


def _is_punct(ch: str) -> bool:
    """HF's Punctuation pre-tokeniser: ASCII punctuation or Unicode P*."""
    return ch in _ASCII_PUNCT or unicodedata.category(ch).startswith("P")


def _normalize(text: str) -> str:
    """NFD, then per-character lowercase (Rust's char::to_lowercase, with
    no final-sigma context), then drop combining marks (category M*)."""
    if text.isascii():
        return text.lower()
    text = "".join(c.lower() for c in unicodedata.normalize("NFD", text))
    return "".join(c for c in text if not unicodedata.category(c).startswith("M"))


def _pre_tokenize(text: str) -> List[str]:
    if text.isascii():
        return _ASCII_WORD_RE.findall(text)
    words: List[str] = []
    cur: List[str] = []
    for ch in text:
        if ch in _WHITESPACE or _is_punct(ch):
            if cur:
                words.append("".join(cur))
                cur = []
            if ch not in _WHITESPACE:
                words.append(ch)
        else:
            cur.append(ch)
    if cur:
        words.append("".join(cur))
    return words


def _alternation(tokens: Dict[str, int]) -> Optional["re.Pattern[str]"]:
    """Leftmost-longest matcher over literal tokens (HF AddedVocabulary)."""
    if not tokens:
        return None
    ordered = sorted(tokens, key=len, reverse=True)
    return re.compile("|".join(re.escape(t) for t in ordered))


def _split_on(
    text: str, pattern, ids: Dict[str, int]
) -> List[Tuple[str, Optional[int]]]:
    """[(piece, None) | (token, id)] in order; empty pieces dropped."""
    if pattern is None:
        return [(text, None)] if text else []
    out: List[Tuple[str, Optional[int]]] = []
    pos = 0
    for m in pattern.finditer(text):
        if m.start() > pos:
            out.append((text[pos : m.start()], None))
        out.append((m.group(0), ids[m.group(0)]))
        pos = m.end()
    if pos < len(text):
        out.append((text[pos:], None))
    return out


class WordPieceTokenizer:
    """Pure-Python tokenizer.json reader for the committed WordPiece asset.

    Pipeline, in HuggingFace ``tokenizers`` order: added tokens with
    normalized=false are matched in the raw text; each remaining piece is
    normalised and added tokens with normalized=true are matched in it;
    what is left is pre-tokenised and each word becomes greedy
    longest-match-first WordPiece ids (a word with an unmatchable position,
    or longer than max_input_chars_per_word, is one [UNK]); the template
    wraps the ids in [CLS] ... [SEP]. Word -> ids results are cached, which
    changes no result.
    """

    _CACHE_CAP = 1 << 18

    def __init__(self, path: str, max_len: int = 512, spec: Optional[dict] = None):
        """`spec`, when given, is the parsed tokenizer.json (path then only
        names it in errors)."""
        if spec is None:
            with open(path, "r", encoding="utf-8") as f:
                spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "WordPiece":
            raise ValueError(f"{path}: model type {model.get('type')!r} is not WordPiece")
        self._vocab: Dict[str, int] = {k: int(v) for k, v in model["vocab"].items()}
        self._prefix = model.get("continuing_subword_prefix", "##")
        self._max_chars = int(model.get("max_input_chars_per_word") or 100)
        self._unk = self._vocab[model["unk_token"]]
        raw_added: Dict[str, int] = {}
        norm_added: Dict[str, int] = {}
        for tok in spec.get("added_tokens") or []:
            if tok.get("single_word") or tok.get("lstrip") or tok.get("rstrip"):
                raise ValueError(f"{path}: added token options of {tok['content']!r} not supported")
            (norm_added if tok.get("normalized") else raw_added)[tok["content"]] = int(tok["id"])
        self._raw_added, self._raw_re = raw_added, _alternation(raw_added)
        self._norm_added, self._norm_re = norm_added, _alternation(norm_added)
        self._cls = self._vocab["[CLS]"]
        self._sep = self._vocab["[SEP]"]
        self._pad = self._vocab.get("[PAD]", 0)
        ids = list(self._vocab.values()) + list(raw_added.values()) + list(norm_added.values())
        self.vocab_size = max(ids) + 1
        self.max_len = max_len
        self._max_piece = max(len(k) for k in self._vocab)
        self._cache: Dict[str, Tuple[int, ...]] = {}

    def _word_ids(self, word: str) -> Tuple[int, ...]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        n = len(word)
        if n > self._max_chars:
            ids: Tuple[int, ...] = (self._unk,)
        else:
            pieces: List[int] = []
            start = 0
            while start < n:
                end = min(n, start + self._max_piece)
                found = None
                while start < end:
                    sub = word[start:end]
                    found = self._vocab.get(self._prefix + sub if start else sub)
                    if found is not None:
                        break
                    end -= 1
                if found is None:
                    pieces = [self._unk]
                    break
                pieces.append(found)
                start = end
            ids = tuple(pieces)
        if len(self._cache) >= self._CACHE_CAP:
            self._cache.clear()
        self._cache[word] = ids
        return ids

    def tokenize_full(self, text: str) -> List[int]:
        """Untruncated ids, [CLS] ... [SEP]."""
        ids = [self._cls]
        for piece, tid in _split_on(text, self._raw_re, self._raw_added):
            if tid is not None:
                ids.append(tid)
                continue
            norm = _normalize(piece)
            for sub, sid in _split_on(norm, self._norm_re, self._norm_added):
                if sid is not None:
                    ids.append(sid)
                    continue
                for word in _pre_tokenize(sub):
                    ids.extend(self._word_ids(word))
        ids.append(self._sep)
        return ids

    def tokenize(self, text: str) -> List[int]:
        return self.tokenize_full(text)[: self.max_len]

    def tokenize_full_batch(self, texts: Sequence[str]) -> List[List[int]]:
        """Untruncated ids of each text (the trainers' batch encode)."""
        return [self.tokenize_full(t) for t in texts]

    def token_to_id(self, token: str) -> Optional[int]:
        """The id of a vocabulary entry or added token, None if absent."""
        for table in (self._raw_added, self._norm_added, self._vocab):
            if token in table:
                return table[token]
        return None

    def encode_batch_headtail(
        self, texts: Sequence[str], seq_len: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-shape [B, seq_len] judge encoding of the untruncated ids
        (see headtail_pack), padded with [PAD]."""
        return headtail_pack(self.tokenize_full_batch(texts), seq_len, self._pad)

    def encode_batch(
        self, texts: Sequence[str], buckets: Sequence[int] = DEFAULT_BUCKETS
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids [B, L], mask [B, L]) padded to a bucketed length."""
        tokenized = [self.tokenize(t) for t in texts]
        longest = max((len(t) for t in tokenized), default=1)
        L = bucket_length(min(longest, self.max_len), buckets)
        ids = np.full((len(texts), L), self._pad, dtype=np.int32)
        mask = np.zeros((len(texts), L), dtype=np.int32)
        for i, toks in enumerate(tokenized):
            toks = toks[:L]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask


def load_tokenizer(
    path: Optional[str] = None, vocab_size: int = 30528, max_len: int = 512
):
    """For an existing tokenizer.json the native WordPiece tokenizer
    (models/native_tokenizer.py; raises when its library cannot be built),
    or the pure-Python WordPieceTokenizer when RAG_TPU_NATIVE_TOKENIZER=0;
    else the deterministic hash tokenizer."""
    if path and os.path.exists(path):
        if os.environ.get("RAG_TPU_NATIVE_TOKENIZER", "1") == "0":
            return WordPieceTokenizer(path, max_len=max_len)
        from rust_local_rag_tpu_torch.models.native_tokenizer import NativeWordPieceTokenizer

        return NativeWordPieceTokenizer(path, max_len=max_len)
    return HashTokenizer(vocab_size=vocab_size, max_len=max_len)
