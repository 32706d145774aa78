"""The native C++ BM25 index of the port (port of
rust_local_rag_tpu/ops/native_bm25.py over the port's own C++ source,
csrc/lexical.cpp, built with g++ at first use by kernels/build.py).

The index is keyed by integer slots (the ChunkStore slab slots); a thin
adapter maps chunk-id strings to slots so it has the interface of the
pure-Python ops/bm25.LexicalIndex, which stays as its plain twin. Scores
are f32 sums of f64 terms where the Python index sums in f64.

Writes: `add_chunks` indexes a batch of chunks in one native call under
one hold of the lock. An ASCII text goes to the C++ tokeniser as it is
(for ASCII its byte rule equals ops/bm25.tokenize); any other is
tokenised here by ops/bm25.tokenize and sent joined. `add_chunk` is a
batch of one. While the tracer is on, the counters bm25.texts_native and
bm25.texts_python count the texts tokenised in C++ and in Python.

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

import array
import itertools
import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from rust_local_rag_tpu_torch.kernels import build
from rust_local_rag_tpu_torch.ops.bm25 import LexicalIndex, tokenize
from rust_local_rag_tpu_torch.utils import profiling


def _joined(text: str) -> bytes:
    """The pre-tokenised form bm25_add_batch / bm25_score_tokens take:
    the tokens of ops/bm25.tokenize joined by 0x01, UTF-8."""
    return "\x01".join(tokenize(text)).encode("utf-8")



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
        """add_chunks of one chunk."""
        self.add_chunks([chunk_id], [text], None if slot is None else [slot])

    def add_chunks(self, chunk_ids: Sequence[str], texts: Sequence[str],
                   slots: Optional[Sequence[int]] = None) -> None:
        """Index texts[i] under chunk_ids[i] at slots[i] (auto-allocated
        slots when slots is None), in order, as that many add_chunk calls
        would: the slots are settled first (_slot_for), then one native
        call adds every text. A chunk id seen twice in one call sends the
        texts before it first, so its old slot is removed after they were
        added. A chunk whose text tokenises to nothing is not indexed, and
        its id mapping is dropped again, as the Python index keeps no entry
        for it."""
        n = len(chunk_ids)
        is_ascii = [t.isascii() for t in texts]
        native = sum(is_ascii)
        profiling.count("bm25.texts_native", native)
        profiling.count("bm25.texts_python", n - native)
        if n == 0:
            return
        data = [t.encode("ascii") if a else _joined(t) for t, a in zip(texts, is_ascii)]
        buf = b"".join(data)
        offsets = array.array("q", itertools.accumulate(map(len, data), initial=0))
        flags = array.array("B", [not a for a in is_ascii])
        at = array.array("q", bytes(8 * n))
        indexed = array.array("B", bytes(n))
        with self._lock:
            lo, seen = 0, set()
            for i, cid in enumerate(chunk_ids):
                if cid in seen:
                    self._add_native(chunk_ids, buf, offsets, flags, at, indexed, lo, i)
                    lo, seen = i, set()
                seen.add(cid)
                at[i] = self._slot_for(cid, None if slots is None else slots[i])
            self._add_native(chunk_ids, buf, offsets, flags, at, indexed, lo, n)

    def _add_native(self, chunk_ids, buf: bytes, offsets, flags, at, indexed, lo: int, hi: int) -> None:
        """Texts lo..hi-1 of an add_chunks through bm25_add_batch (caller holds
        the lock; offsets, flags, at and indexed are array.array buffers);
        the ids of those that produced no tokens are unmapped."""
        self._lib.bm25_add_batch(self._h, at.buffer_info()[0] + 8 * lo, buf, offsets.buffer_info()[0] + 8 * lo,
                                 flags.buffer_info()[0] + lo, hi - lo, indexed.buffer_info()[0] + lo)
        done = indexed.tobytes()
        i = done.find(0, lo, hi)
        while i >= 0:
            cid, slot = chunk_ids[i], at[i]
            if self._id_to_slot.get(cid) == slot:
                del self._id_to_slot[cid]
                self._slot_to_id.pop(slot, None)
            i = done.find(0, i + 1, hi)

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
