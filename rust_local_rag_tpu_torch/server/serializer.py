"""The native JSON response serializer of the /search hot lanes (port of
rust_local_rag_tpu/server/serializer.py over the port's own copy of the
C++ source, csrc/serializer.cpp, built with g++ at first use by
kernels/build.py).

One pre-escaped meta fragment is registered per ChunkStore slot (lazily,
keyed by chunk id, so a slot reused after a document replacement is
registered again); per batch the C side writes each query's
`{"results": [...]}` body straight from the engine's columnar arrays in
one ctypes crossing. The library is built or the constructor raises: the
JAX package's batcher falls back to objects when its prebuilt library is
missing, the port builds from its own sources, so a failed build is a
fault to show.
"""

from __future__ import annotations

import ctypes
import json
import threading
import weakref
from typing import Dict, List

import numpy as np

from rust_local_rag_tpu_torch.kernels import build


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class ResponseSerializer:
    """Serializes columnar results to response-body bytes."""

    def __init__(self, store_getter):
        """store_getter: zero-argument callable returning the CURRENT
        ChunkStore (the engine replaces its store on reload; fragments are
        checked against the live store by chunk id)."""
        self._lib = build.load("serializer")
        self._store_getter = store_getter
        self._h = self._lib.resp_create()
        # slot -> chunk id whose fragment is registered
        self._frag_ids: Dict[int, str] = {}
        # (weak reference to the store, its mutation count) for which every
        # live slot is known registered: while it holds, the per-row check
        # is skipped. A weak reference, not id(store): a new store may get
        # a freed store's id.
        self._complete_for = None
        # the C registry is shared_mutex-guarded, so one serializer serves
        # every pipeline thread; only the output buffer is per thread
        self._tls = threading.local()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.resp_destroy(h)
            self._h = None

    @staticmethod
    def meta_fragment(meta) -> bytes:
        """The static result fields, escaped once, without the enclosing
        braces: the field content of SearchResult.to_dict."""
        return json.dumps(
            {
                "text": meta.text,
                "document": meta.document_name,
                "chunk_id": meta.id,
                "chunk_index": meta.chunk_index,
                "page_number": meta.page_number,
                "section": meta.section,
            },
            ensure_ascii=False,
            separators=(",", ":"),
        )[1:-1].encode()

    def count(self) -> int:
        """Fragments registered in the C registry."""
        return int(self._lib.resp_count(self._h))

    def _is_complete(self, store) -> bool:
        c = self._complete_for
        return c is not None and c[0]() is store and c[1] == store.mutations

    def preregister_all(self) -> int:
        """Register every live chunk's fragment in one bulk call (at index
        load), so serving never builds a fragment. Returns the count."""
        store = self._store_getter()
        slots, ids, parts, offsets = [], [], [], [0]
        for slot, meta in store.iter_meta():
            frag = self.meta_fragment(meta)
            slots.append(slot)
            ids.append(meta.id)
            parts.append(frag)
            offsets.append(offsets[-1] + len(frag))
        if not slots:
            return 0
        slots_a = np.asarray(slots, dtype=np.int64)
        offs_a = np.asarray(offsets, dtype=np.int64)
        self._lib.resp_register_bulk(self._h, _ptr(slots_a), b"".join(parts), _ptr(offs_a), len(slots))
        self._frag_ids.update(zip(slots, ids))
        self._complete_for = (weakref.ref(store), store.mutations)
        return len(slots)

    def _ensure_fragments(self, store, slots_row: np.ndarray) -> None:
        frag_ids = self._frag_ids
        for slot in slots_row.tolist():
            if slot < 0:
                continue
            try:
                meta = store.meta_for_slot(slot)
            except KeyError:
                if frag_ids.pop(slot, None) is not None:
                    self._lib.resp_clear_slot(self._h, slot)
                continue
            if frag_ids.get(slot) == meta.id:
                continue
            frag = self.meta_fragment(meta)
            self._lib.resp_register(self._h, slot, frag, len(frag))
            frag_ids[slot] = meta.id

    def _prepare(self, slots: np.ndarray) -> None:
        store = self._store_getter()
        if not self._is_complete(store):
            for row in np.atleast_2d(slots):
                self._ensure_fragments(store, row)

    def _run(self, call, need: int) -> bytes:
        """`call(buf, cap)` with a per-thread buffer of at least `need`
        bytes, doubled until the output fits; the bytes written."""
        if getattr(self._tls, "cap", 0) < need:
            self._tls.cap = 1 << max(need - 1, 1).bit_length()
            self._tls.buf = ctypes.create_string_buffer(self._tls.cap)
        while True:
            wrote = call(ctypes.addressof(self._tls.buf), self._tls.cap)
            if wrote >= 0:
                return ctypes.string_at(self._tls.buf, wrote)
            self._tls.cap *= 2
            self._tls.buf = ctypes.create_string_buffer(self._tls.cap)

    @staticmethod
    def _split(blob: bytes, lens: np.ndarray) -> List[bytes]:
        out, off = [], 0
        for ln in lens.tolist():
            out.append(blob[off:off + ln])
            off += ln
        return out

    def serialize_batch(
        self,
        slots: np.ndarray,  # [nq, k] int32
        score: np.ndarray,  # [nq, k] f32 combined
        emb: np.ndarray,    # [nq, k] f32 embedding score
        lex: np.ndarray,    # [nq, k] f32 normalised lexical
        floor: float = 0.0,
    ) -> List[bytes]:
        """One response body per query, in one ctypes crossing; rows below
        the dense-cosine floor (when > 0) are dropped."""
        self._prepare(slots)
        arrs = [np.ascontiguousarray(slots, dtype=np.int32)] + [
            np.ascontiguousarray(a, dtype=np.float32) for a in (score, emb, lex)
        ]
        nq, k = arrs[0].shape
        lens = np.empty(nq, dtype=np.int64)
        blob = self._run(
            lambda buf, cap: self._lib.resp_serialize_batch(
                self._h, *(_ptr(a) for a in arrs), nq, k, floor, buf, cap, _ptr(lens)
            ),
            nq * (k * 512 + 64),
        )
        return self._split(blob, lens)

    def serialize_batch_rr(
        self,
        slots: np.ndarray,    # [nq, k] int32
        score: np.ndarray,    # [nq, k] f32 weight-0 blend score
        emb: np.ndarray,      # [nq, k] f32 embedding score
        lex: np.ndarray,      # [nq, k] f32 normalised lexical
        initial: np.ndarray,  # [nq, k] f32 first-stage combined score
        rr: np.ndarray,       # [nq, k] f32 judge yes-probability
        yes_lp: np.ndarray,   # [nq, k] f32 yes logprob
        no_lp: np.ndarray,    # [nq, k] f32 no logprob
        emb_floor: float = 0.0,
        rr_floor: float = 0.0,
    ) -> List[bytes]:
        """Judged-lane bodies, one crossing for the batch: rows gated on the
        judge floor and the dense-cosine floor (the joint gate of
        results_from_judged)."""
        self._prepare(slots)
        arrs = [np.ascontiguousarray(slots, dtype=np.int32)] + [
            np.ascontiguousarray(a, dtype=np.float32)
            for a in (score, emb, lex, initial, rr, yes_lp, no_lp)
        ]
        nq, k = arrs[0].shape
        lens = np.empty(nq, dtype=np.int64)
        blob = self._run(
            lambda buf, cap: self._lib.resp_serialize_batch_rr(
                self._h, *(_ptr(a) for a in arrs), nq, k, emb_floor, rr_floor, buf, cap, _ptr(lens)
            ),
            nq * (k * 768 + 64),
        )
        return self._split(blob, lens)

    def serialize_query(
        self,
        slots: np.ndarray,  # [k] int32
        score: np.ndarray,  # [k] f32 combined
        emb: np.ndarray,    # [k] f32 embedding score
        lex: np.ndarray,    # [k] f32 normalised lexical
        floor: float = 0.0,
    ) -> bytes:
        """One query's body (resp_serialize)."""
        self._prepare(slots)
        arrs = [np.ascontiguousarray(slots, dtype=np.int32)] + [
            np.ascontiguousarray(a, dtype=np.float32) for a in (score, emb, lex)
        ]
        n = arrs[0].shape[0]
        return self._run(
            lambda buf, cap: self._lib.resp_serialize(self._h, *(_ptr(a) for a in arrs), n, floor, buf, cap),
            n * 512 + 64,
        )
