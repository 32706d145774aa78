"""The native WordPiece tokenizer of the port (port of
rust_local_rag_tpu/models/native_tokenizer.py over its own copy of the C++
source, csrc/wordpiece.cpp, built with g++ at first use by kernels/build.py).

The C++ kernel implements the serving pipeline of the committed
tokenizer.json for pure-ASCII inputs, where NFD and StripAccents are
identity and Lowercase is a byte map. Every text outside that envelope
(non-ASCII bytes, control characters, literal special-token strings such
as "[CLS]") is routed to the port's pure-Python WordPieceTokenizer, as
the JAX package routes it to its HuggingFace tokenizer; the two give the
same ids (tests/test_torch_text.py), so the combined tokenizer gives the
pure-Python ids on every input (tests/test_torch_native_tokenizer.py).
The routing is the JAX package's semantics, not a fallback: the routed
texts are counted in ``routed_texts``.
"""

from __future__ import annotations

import json
import re
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from rust_local_rag_tpu_torch.kernels import build
from rust_local_rag_tpu_torch.models.tokenizer import (
    DEFAULT_BUCKETS,
    WordPieceTokenizer,
    bucket_length,
    headtail_pack,
)

# Texts the C++ kernel must not see: anything outside printable ASCII and
# the whitespace bytes it knows, or a literal special-token string (added
# tokens match verbatim in the raw text, before any pre-tokeniser split)
_FALLBACK_RE = re.compile(r"[^\x20-\x7e\t\n\r\v\f]|\[(?:PAD|UNK|CLS|SEP|MASK)\]")
# the same test in three cheaper parts: the alternation above costs ~3x as
# much a character, and most texts are ASCII with no "["
_CONTROL_RE = re.compile(r"[\x00-\x08\x0e-\x1f\x7f]")
_SPECIAL_RE = re.compile(r"\[(?:PAD|UNK|CLS|SEP|MASK)\]")


def outside_envelope(text: str) -> bool:
    """bool(_FALLBACK_RE.search(text)): the text goes to the pure-Python
    tokenizer."""
    return (
        not text.isascii()
        or _CONTROL_RE.search(text) is not None
        or ("[" in text and _SPECIAL_RE.search(text) is not None)
    )


class NativeWordPieceTokenizer:
    """WordPieceTokenizer's interface (``tokenize``, ``encode_batch``,
    ``encode_batch_headtail``, ``vocab_size``, ``max_len``) backed by
    csrc/wordpiece.cpp for the texts inside its envelope."""

    def __init__(self, path: str, max_len: int = 512):
        self._lib = build.load("wordpiece")
        self.max_len = max_len
        self._py = WordPieceTokenizer(path, max_len=max_len)
        self.vocab_size = self._py.vocab_size
        self._pad = self._py._pad
        with open(path, "r", encoding="utf-8") as f:
            spec = json.load(f)
        vocab = spec["model"]["vocab"]
        n = len(vocab)
        by_id: List[Optional[str]] = [None] * n
        for tok_str, tid in vocab.items():
            by_id[int(tid)] = tok_str
        yes_id = -1
        for added in spec.get("added_tokens") or []:
            if added.get("special"):
                continue  # the specials are in the vocabulary already
            if added["content"] != "yes":
                raise RuntimeError(f"{path}: added token {added['content']!r} is not modelled by the native kernel")
            yes_id = int(added["id"])
            if yes_id >= n:
                # reserve the id with a piece the kernel never matches
                # (non-ASCII bytes never reach it)
                by_id.append("￿-added-token-slot")
                n += 1
        for name in ("[CLS]", "[SEP]", "[UNK]"):
            if name not in vocab:
                raise RuntimeError(f"{path}: vocabulary has no {name}")
        blob = b"\0".join(t.encode("utf-8") for t in by_id) + b"\0"
        self._handle = self._lib.wp_create(
            blob, len(blob), n, int(vocab["[CLS]"]), int(vocab["[SEP]"]), int(vocab["[UNK]"]), yes_id,
            int(spec["model"].get("max_input_chars_per_word") or 64),
        )
        # texts sent to the pure-Python tokenizer (non-ASCII, control bytes,
        # literal special tokens, or head/tail rows longer than the buffer)
        self.routed_texts = 0
        self._count_lock = threading.Lock()

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            self._lib.wp_destroy(h)
            self._handle = None

    def _route(self, texts: Sequence[str]) -> List[int]:
        """Indices of the texts outside the kernel's envelope, counted."""
        idx = [i for i, t in enumerate(texts) if outside_envelope(t)]
        if idx:
            with self._count_lock:
                self.routed_texts += len(idx)
        return idx

    def _encode_native(self, texts: Sequence[str], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids [B, max_len] int32, lens [B] int32) for ASCII texts; ids
        past a row's length are undefined."""
        raw = [t.encode("ascii") for t in texts]
        offsets = np.zeros(len(raw) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in raw], out=offsets[1:])
        ids = np.zeros((len(raw), max_len), dtype=np.int32)
        lens = np.zeros(len(raw), dtype=np.int32)
        self._lib.wp_encode_batch(self._handle, b"".join(raw), offsets.ctypes.data, len(raw), max_len,
                                  ids.ctypes.data, lens.ctypes.data)
        return ids, lens

    def tokenize(self, text: str) -> List[int]:
        """[CLS] ... [SEP] ids truncated to max_len."""
        if self._route([text]):
            return self._py.tokenize(text)
        ids, lens = self._encode_native([text], self.max_len)
        return ids[0, : int(lens[0])].tolist()

    def tokenize_full(self, text: str) -> List[int]:
        """Untruncated [CLS] ... [SEP] ids."""
        return self.tokenize_full_batch([text])[0]

    def tokenize_full_batch(self, texts: Sequence[str], cap: int = 1024) -> List[List[int]]:
        """Untruncated ids of each text. The kernel encodes into a buffer of
        `cap` ids; a row that fills it (its true tail unknown) goes to the
        pure-Python tokenizer, counted in routed_texts."""
        texts = list(texts)
        routed = set(self._route(texts))
        native = [i for i in range(len(texts)) if i not in routed]
        rows: List[List[int]] = [[] for _ in texts]
        if native:
            ids, lens = self._encode_native([texts[i] for i in native], cap)
            full = [i for j, i in enumerate(native) if int(lens[j]) >= cap]
            if full:
                with self._count_lock:
                    self.routed_texts += len(full)
            for j, i in enumerate(native):
                rows[i] = ids[j, : int(lens[j])].tolist()
            routed.update(full)
        for i in routed:
            rows[i] = self._py.tokenize_full(texts[i])
        return rows

    def token_to_id(self, token: str) -> Optional[int]:
        return self._py.token_to_id(token)

    def encode_batch_headtail(self, texts: Sequence[str], seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed [B, seq_len] judge encoding (tokenizer.headtail_pack) of the
        untruncated ids (tokenize_full_batch with a buffer of max(1024,
        2 seq_len) ids)."""
        return headtail_pack(self.tokenize_full_batch(texts, cap=max(1024, 2 * seq_len)), seq_len, self._pad)

    def encode_batch(
        self, texts: Sequence[str], buckets: Sequence[int] = DEFAULT_BUCKETS
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids [B, L], mask [B, L]) padded with [PAD] to a bucketed
        length: the ids and mask WordPieceTokenizer.encode_batch gives."""
        texts = list(texts)
        routed = self._route(texts)
        skip = set(routed)
        native = [i for i in range(len(texts)) if i not in skip]
        nat_ids, nat_lens = self._encode_native([texts[i] for i in native], self.max_len)
        py_rows = [self._py.tokenize(texts[i]) for i in routed]
        longest = max(int(nat_lens.max(initial=1)), max((len(r) for r in py_rows), default=1))
        L = bucket_length(min(longest, self.max_len), buckets)
        ids = np.full((len(texts), L), self._pad, dtype=np.int32)
        mask = np.zeros((len(texts), L), dtype=np.int32)
        if native:
            rows = np.asarray(native)
            w = min(L, self.max_len)  # a row holds at most max_len ids
            m = np.arange(L)[None, :] < np.minimum(nat_lens, L)[:, None]
            ids[rows, :w] = np.where(m[:, :w], nat_ids[:, :w], self._pad)
            mask[rows] = m
        for i, row in zip(routed, py_rows):
            row = row[:L]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask
