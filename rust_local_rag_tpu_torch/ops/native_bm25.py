"""The native C++ BM25 index of the port (port of
rust_local_rag_tpu/ops/native_bm25.py over its own copy of the C++ source,
csrc/lexical.cpp, built with g++ at first use by kernels/build.py).

The index is keyed by integer slots (the ChunkStore slab slots); a thin
adapter maps chunk-id strings to slots so it has the interface of the
pure-Python ops/bm25.LexicalIndex, which stays as its plain twin. Scores
are f32 sums of f64 terms where the Python index sums in f64.

Selection (make_lexical_index): RAG_TPU_NATIVE_BM25=0 selects the Python
index; otherwise the library is built or the call raises. The JAX package
falls back to Python when its prebuilt library is missing; the port builds
from its own sources, so a failed build is a fault to show.

Concurrency: the C++ index is not safe for concurrent calls. Scoring
writes the index's shared scratch and compiles posting snapshots lazily
(csrc/lexical.cpp header), and the batcher scores two batches at once
under a shared read lock, so every call on a handle, and the wrapper's own
scratch buffers and id maps, are serialised by one lock per index.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from rust_local_rag_tpu_torch.kernels import build
from rust_local_rag_tpu_torch.ops.bm25 import LexicalIndex, tokenize
from rust_local_rag_tpu_torch.utils import profiling


def _joined(text: str) -> bytes:
    """The pre-tokenised form bm25_add_tokens / bm25_score_tokens take:
    the tokens of ops/bm25.tokenize joined by 0x01, UTF-8."""
    return "\x01".join(tokenize(text)).encode("utf-8")


joined_tokens = _joined


class NativeLexicalIndex:
    """ops/bm25.LexicalIndex's interface, backed by csrc/lexical.cpp."""

    def __init__(self) -> None:
        self._lib = build.load("lexical")
        self._h = self._lib.bm25_create()
        self._lock = threading.Lock()
        self._id_to_slot: Dict[str, int] = {}
        self._slot_to_id: Dict[int, str] = {}
        # auto-allocated slots start far above any store slot so mixed
        # explicit / auto adds never collide in _slot_to_id
        self._next_slot = 1 << 40
        # True while every add carried an explicit ChunkStore slot: the
        # index then scores in store-slot space and score_slots_into needs
        # no per-hit Python
        self._slots_aligned = True
        self._scratch_slots = np.zeros(0, dtype=np.int64)
        self._scratch_vals = np.zeros(0, dtype=np.float32)

    @property
    def slots_aligned(self) -> bool:
        return self._slots_aligned

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.bm25_destroy(h)
            self._h = None

    @property
    def total_docs(self) -> int:
        with self._lock:
            return int(self._lib.bm25_num_docs(self._h))

    def _slot_for(self, chunk_id: str, slot: Optional[int]) -> int:
        """The index slot of chunk_id (caller holds the lock): the store
        slot when given, dropping a stale id that held it (slot reuse after
        a document replacement) and the chunk's old slot; else an
        auto-allocated one."""
        existing = self._id_to_slot.get(chunk_id)
        if slot is not None:
            slot = int(slot)
            if existing is not None and existing != slot:
                self._lib.bm25_remove_chunk(self._h, existing)
                self._slot_to_id.pop(existing, None)
            prior = self._slot_to_id.get(slot)
            if prior is not None and prior != chunk_id:
                # the stale id must not alias the new chunk's postings
                self._id_to_slot.pop(prior, None)
                self._lib.bm25_remove_chunk(self._h, slot)
            self._id_to_slot[chunk_id] = slot
            self._slot_to_id[slot] = chunk_id
            return slot
        self._slots_aligned = False
        if existing is None:
            existing = self._next_slot
            self._next_slot += 1
            self._id_to_slot[chunk_id] = existing
            self._slot_to_id[existing] = chunk_id
        return existing

    def add_chunk(self, chunk_id: str, text: str, slot: Optional[int] = None) -> None:
        """Index text under chunk_id, tokenised host-side by ops/bm25.tokenize
        (the C++ core only counts the tokens). A chunk whose text tokenises
        to nothing is not indexed, and its id mapping is dropped again, as
        the Python index keeps no entry for it."""
        self.add_joined(chunk_id, _joined(text), slot)

    def add_joined(self, chunk_id: str, data: bytes, slot: Optional[int] = None) -> None:
        """add_chunk for a text already tokenised by joined_tokens (a text
        indexed into several indexes is tokenised once)."""
        with self._lock:
            s = self._slot_for(chunk_id, slot)
            self._lib.bm25_add_tokens(self._h, s, data, len(data))
            if not self._lib.bm25_contains(self._h, s):
                self._slot_to_id.pop(self._id_to_slot.pop(chunk_id), None)

    def remove_chunk(self, chunk_id: str) -> None:
        with self._lock:
            slot = self._id_to_slot.pop(chunk_id, None)
            if slot is not None:
                self._slot_to_id.pop(slot, None)
                self._lib.bm25_remove_chunk(self._h, slot)

    def contains(self, chunk_id: str) -> bool:
        with self._lock:
            slot = self._id_to_slot.get(chunk_id)
            return slot is not None and bool(self._lib.bm25_contains(self._h, slot))

    def _score_into_scratch(self, data: bytes, tokens: bool, limit: int) -> int:
        """Top-`limit` (slot, score) pairs into the scratch buffers (caller
        holds the lock); -> the number written."""
        if len(self._scratch_slots) < limit:
            self._scratch_slots = np.zeros(limit, dtype=np.int64)
            self._scratch_vals = np.zeros(limit, dtype=np.float32)
        fn = self._lib.bm25_score_tokens if tokens else self._lib.bm25_score
        return int(fn(self._h, data, len(data), limit,
                      self._scratch_slots.ctypes.data, self._scratch_vals.ctypes.data))

    def score(self, query: str, limit: int) -> List[Tuple[str, float]]:
        """Top-`limit` (chunk_id, bm25) pairs, descending; every hit when
        limit <= 0."""
        data = _joined(query)
        with self._lock:
            if limit <= 0:
                limit = int(self._lib.bm25_num_docs(self._h))
            if limit <= 0:
                return []
            n = self._score_into_scratch(data, True, limit)
            slots = self._scratch_slots[:n].tolist()
            vals = self._scratch_vals[:n].tolist()
            return [(self._slot_to_id[s], v) for s, v in zip(slots, vals) if s in self._slot_to_id]

    def score_slots_into(self, query: str, limit: int, out_slots, out_vals) -> int:
        """Hot-path scoring: the top-`limit` hits written straight into the
        caller's int32 / f32 row buffers as ChunkStore slots, in one call.
        Valid only while slots_aligned. A pure-ASCII query is tokenised in
        C++ (for ASCII text the byte rules equal ops/bm25.tokenize); any
        other goes through the Python tokenizer. -> hits written."""
        if not self._slots_aligned:
            raise RuntimeError("index has chunks without registered slots")
        if limit <= 0:
            return 0
        ascii_query = query.isascii()
        data = query.encode("ascii") if ascii_query else _joined(query)
        self._acquire()
        try:
            n = min(self._score_into_scratch(data, not ascii_query, limit), len(out_slots))
            out_slots[:n] = self._scratch_slots[:n]
            out_vals[:n] = self._scratch_vals[:n]
        finally:
            self._lock.release()
        return n

    def unseen_mass(self, query: str) -> float:
        """The share of the query's idf weight carried by terms no indexed
        chunk holds (ops/bm25.LexicalIndex.unseen_mass, computed in C++)."""
        data = _joined(query)
        self._acquire()
        try:
            return float(self._lib.bm25_unseen_mass(self._h, data, len(data)))
        finally:
            self._lock.release()

    def _acquire(self) -> None:
        """Take the index's lock on a query's path; while the tracer is on,
        the wait is recorded as bm25.lock_wait."""
        tracer = profiling.TRACER
        if not tracer.on:
            self._lock.acquire()
            return
        t0 = tracer.clock()
        self._lock.acquire()
        tracer.interval("bm25.lock_wait", t0, tracer.clock())

    def compile_all(self) -> int:
        """Build every term's read-optimised posting snapshot up front, so no
        query pays a lazy compile (a copy and sort of the posting list).
        -> the number of terms compiled."""
        with self._lock:
            return int(self._lib.bm25_compile_all(self._h))

    def drop_stale(self, valid_ids: Set[str] | Iterable[str]) -> None:
        valid = set(valid_ids)
        with self._lock:
            keep = np.array(sorted(s for c, s in self._id_to_slot.items() if c in valid), dtype=np.int64)
            self._lib.bm25_drop_stale(self._h, keep.ctypes.data, len(keep))
            for cid in [c for c in self._id_to_slot if c not in valid]:
                self._slot_to_id.pop(self._id_to_slot.pop(cid), None)

    def clear(self) -> None:
        with self._lock:
            self._lib.bm25_destroy(self._h)
            self._h = self._lib.bm25_create()
            self._id_to_slot.clear()
            self._slot_to_id.clear()
            self._slots_aligned = True


def make_lexical_index():
    """NativeLexicalIndex, or the pure-Python LexicalIndex when
    RAG_TPU_NATIVE_BM25=0. Raises when the native library cannot be built."""
    if os.environ.get("RAG_TPU_NATIVE_BM25") == "0":
        return LexicalIndex()
    return NativeLexicalIndex()
