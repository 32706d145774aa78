"""RagEngine of the port: ingest and the rerank-off search lane (port of
rust_local_rag_tpu/engine/rag_engine.py, plain lane).

Ingest: hash skip, PDF text, sentence chunks, batched embeddings,
replace-document, index sync, persist. Search: query embeddings stay on
the device, BM25 hits are shipped sparse, and ops/hybrid.hybrid_topk_packed
does the dense scoring (the score + segment-max kernel on large slabs),
exact top-k and the lexical blend in one call whose packed [Q, 4, k] int32
result comes back in one copy.

This port has no reranker, MMR, judged, int8 or mesh lanes yet; with no
reranker, search_batch behaves as the JAX engine does without one.
"""

from __future__ import annotations

import hashlib
import logging
import os
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from rust_local_rag_tpu_torch.config import QueryWeights, ResolvedWeights, env_float
from rust_local_rag_tpu_torch.device import resolve_device
from rust_local_rag_tpu_torch.engine import persistence
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta, ChunkStore
from rust_local_rag_tpu_torch.ingest import chunk_text as chunk_text_fn
from rust_local_rag_tpu_torch.ingest.pdf import extract_pdf_text
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService
from rust_local_rag_tpu_torch.models.encoder import TransformerEncoderModel
from rust_local_rag_tpu_torch.ops.bm25 import LexicalIndex
from rust_local_rag_tpu_torch.ops.hybrid import (
    hybrid_topk_packed,
    lex_width_for,
    unpack_topk,
)

logger = logging.getLogger(__name__)

F32_EPSILON = 1.1920929e-07
MIN_CHUNK_CHARS = 10  # rag_engine.rs:248-258
CHUNK_TOKEN_BUDGET = 200  # rag_engine.rs:245

# top-k and query-batch sizes are bucketed as in the JAX engine; computing
# a slightly larger exact k and trimming gives the same result set
_K_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def _bucket_k(k: int) -> int:
    for b in _K_BUCKETS:
        if k <= b:
            return b
    return k


def _bucket_batch(n: int) -> int:
    """Query batches pad to a power of two; padded rows are dropped."""
    b = 1
    while b < n:
        b *= 2
    return b


@dataclass
class SearchResult:
    """Mirror of rag_engine.rs:72-100 (serde skips None fields)."""

    text: str
    score: float
    document: str
    chunk_id: str
    chunk_index: int
    page_number: int
    section: Optional[str] = None
    embedding_score: Optional[float] = None
    lexical_score: Optional[float] = None
    initial_score: Optional[float] = None


@dataclass
class PendingSearch:
    """Dispatched hot-lane search whose result is not fetched yet."""

    out: torch.Tensor  # packed [nq_pad, 4, kb] int32 on the device
    nq: int
    k: int
    floor: float
    q_emb: torch.Tensor
    lex_slots: np.ndarray
    lex_vals: np.ndarray
    resolved: ResolvedWeights
    kb: int
    # joint unseen-term gate: per-query unseen mass and its thresholds;
    # None = gate off
    unseen: Optional[np.ndarray] = None
    unseen_mass: float = 0.0
    unseen_cos: float = 1.0


@dataclass
class ColumnarResults:
    """Fetched hot-lane results as parallel [nq, k] arrays."""

    vals: np.ndarray   # combined scores (sorted desc per row)
    emb: np.ndarray    # embedding scores
    lex: np.ndarray    # normalised lexical scores
    slots: np.ndarray  # int32 store slots (-1 = invalid)
    floor: float       # rejection floor (0 = off)


def _normalize_vec(v: np.ndarray) -> np.ndarray:
    """rag_engine.rs:1763-1771"""
    v = np.asarray(v, dtype=np.float32)
    norm_sq = float(np.sum(v * v))
    if norm_sq > 1e-20:
        return v / np.float32(np.sqrt(norm_sq))
    return v


class RagEngine:
    def __init__(
        self,
        data_dir: str,
        embedding_service: EmbeddingService,
        corpus_dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ):
        """The slab is f32 unless RAG_TPU_CORPUS_DTYPE=bf16 (or corpus_dtype)
        says otherwise. Loads any saved index of the model from data_dir."""
        self.data_dir = data_dir
        self.embedding_service = embedding_service
        self.device = resolve_device(device)
        dtype_env = os.environ.get("RAG_TPU_CORPUS_DTYPE")
        if dtype_env == "bf16":
            corpus_dtype = torch.bfloat16
        elif dtype_env == "f32":
            corpus_dtype = torch.float32
        self.store = ChunkStore(embedding_service.dim, corpus_dtype, device=self.device)
        self.lexical_index = LexicalIndex()
        self.document_hashes: Dict[str, str] = {}
        self._needs_reindex = False
        # engine-level rejection (see the JAX engine's __init__ notes):
        # absolute dense-cosine floors, and the joint unseen-term gate
        self._rejection_threshold = env_float("RAG_TPU_REJECTION_THRESHOLD", 0.0)
        self._rejection_cosine_floor = env_float("RAG_TPU_REJECTION_COSINE_FLOOR", 0.0)
        self._rejection_unseen_mass = env_float("RAG_TPU_REJECTION_UNSEEN_MASS", 0.0)
        self._rejection_unseen_cos = env_float("RAG_TPU_REJECTION_UNSEEN_COS", 1.0)
        self.load_from_disk()

    # ----- lifecycle -------------------------------------------------------

    @classmethod
    def create(
        cls,
        data_dir: str,
        device: str | torch.device = "cuda",
        model_name: str = "nomic-embed-text",
    ) -> "RagEngine":
        """Engine over the committed encoder and tokenizer."""
        svc = EmbeddingService(
            TransformerEncoderModel.from_assets(model_name=model_name, device=device)
        )
        svc.verify()
        return cls(data_dir, svc, device=device)

    def embedding_model(self) -> str:
        return self.embedding_service.model_name

    # ----- ingest -----------------------------------------------------------

    @staticmethod
    def compute_document_hash(data: bytes) -> str:
        """SHA-256 hex fingerprint (rag_engine.rs:1711-1714)."""
        return hashlib.sha256(data).hexdigest()

    def add_document(self, filename: str, data: bytes, batch_callback=None) -> int:
        """Extract, chunk, embed and index one document. Returns the number
        of chunks created, 0 when unchanged (rag_engine.rs:219-402)."""
        document_hash = self.compute_document_hash(data)
        if self.document_hashes.get(filename) == document_hash:
            logger.info("Document %s unchanged since last index. Skipping.", filename)
            return 0

        text = extract_pdf_text(data)
        if not text.strip():
            raise ValueError("No text extracted from PDF")
        fragments = chunk_text_fn(text, CHUNK_TOKEN_BUDGET)
        kept = [
            (i, frag)
            for i, frag in enumerate(fragments)
            if len(frag.text.strip()) >= MIN_CHUNK_CHARS
        ]
        if not kept:
            logger.warning("Document %s produced no sizeable chunks.", filename)
            self._remove_document_chunks(filename)
            self.document_hashes[filename] = document_hash
            self.save_to_disk()
            return 0

        embeddings = self.embedding_service.embed_in_batches(
            [frag.text for _, frag in kept], batch_callback=batch_callback
        )
        if embeddings.shape[0] != len(kept):
            raise RuntimeError(
                f"Total embeddings mismatch: received {embeddings.shape[0]} "
                f"embeddings for {len(kept)} chunks in {filename}"
            )

        # replace-document semantics (rag_engine.rs:347-348)
        self._remove_document_chunks(filename)
        metas = [
            ChunkMeta(
                id=str(uuid.uuid4()),
                document_name=filename,
                text=frag.text,
                chunk_index=i,
                page_number=frag.page_number,
                section=frag.section,
                metadata=frag.metadata,
            )
            for i, frag in kept
        ]
        self.add_chunks(metas, embeddings)
        self.document_hashes[filename] = document_hash
        self.validate_index_sync()
        self.save_to_disk()
        logger.info("Successfully processed %d chunks for %s", len(metas), filename)
        return len(metas)

    def add_chunks(self, metas: List[ChunkMeta], embeddings: np.ndarray) -> List[int]:
        """Back half of add_document: normalised rows into the slab, texts
        into the lexical index at their slots."""
        rows = np.stack([_normalize_vec(e) for e in embeddings])
        slots = self.store.add_chunks(metas, rows)
        for m, slot in zip(metas, slots):
            self.lexical_index.add_chunk(m.id, m.text, slot)
        return slots

    def _remove_document_chunks(self, filename: str) -> None:
        removed = [m.id for _, m in self.store.iter_meta() if m.document_name == filename]
        self.store.remove_ids(removed)
        for cid in removed:
            self.lexical_index.remove_chunk(cid)

    def validate_index_sync(self) -> None:
        """Keep the lexical index and document hashes consistent with the
        store (rag_engine.rs:1375-1425)."""
        self.lexical_index.drop_stale(set(self.store.chunk_ids()))
        for slot, meta in self.store.iter_meta():
            if not self.lexical_index.contains(meta.id):
                self.lexical_index.add_chunk(meta.id, meta.text, slot)
        valid_docs = {m.document_name for _, m in self.store.iter_meta()}
        for doc in [d for d in self.document_hashes if d not in valid_docs]:
            del self.document_hashes[doc]

    # ----- search -----------------------------------------------------------

    def search(self, query: str, top_k: int, weights: Optional[QueryWeights] = None, **kw):
        """One query through search_batch."""
        return self.search_batch([query], top_k, weights, **kw)[0]

    def _unseen_gate(self, queries: List[str], mass: Optional[float], cos: Optional[float]):
        """(per-query unseen mass | None, mass threshold, cosine ceiling);
        None when the gate is off."""
        a = mass if mass is not None else self._rejection_unseen_mass
        b = cos if cos is not None else self._rejection_unseen_cos
        if a <= 0.0:
            return None, 0.0, 1.0
        um = self.lexical_index.unseen_mass
        return np.asarray([um(q) for q in queries], dtype=np.float32), float(a), float(b)

    def _prep_queries(self, queries: List[str], nq_pad: int) -> torch.Tensor:
        """[nq_pad, D] f32 query embeddings on the device: straight from the
        encoder when it can leave them there, else from the host path
        (normalised, zero rows as padding)."""
        dev = self.embedding_service.get_query_embeddings_device(queries)
        if dev is not None and dev.shape[0] == nq_pad:
            return dev
        host = self.embedding_service.get_query_embeddings(queries)
        q_emb_p = np.zeros((nq_pad, host.shape[1]), dtype=np.float32)
        for i in range(len(queries)):
            q_emb_p[i] = _normalize_vec(host[i])
        return torch.as_tensor(q_emb_p, device=self.device)

    def _prep_lexical(self, queries: List[str], top_k: int, nq_pad: int):
        """Top (top_k * 5) BM25 hits per query as (slot, score) rows."""
        lex_request = top_k * 5
        lex_width = lex_width_for(lex_request)
        lex_slots = np.full((nq_pad, lex_width), -1, dtype=np.int32)
        lex_vals = np.zeros((nq_pad, lex_width), dtype=np.float32)
        limit = min(lex_request, lex_width)
        for qi, query in enumerate(queries):
            self.lexical_index.score_slots_into(query, limit, lex_slots[qi], lex_vals[qi])
        return lex_slots, lex_vals

    def _dispatch(self, queries: List[str], top_k: int, k: int, resolved: ResolvedWeights):
        nq_pad = _bucket_batch(len(queries))
        q_emb = self._prep_queries(queries, nq_pad)
        lex_slots, lex_vals = self._prep_lexical(queries, top_k, nq_pad)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=self.device)  # noqa: E731
        out = hybrid_topk_packed(
            q_emb,
            self.store.corpus(),
            self.store.valid_mask(),
            torch.as_tensor(lex_slots, device=self.device),
            torch.as_tensor(lex_vals, device=self.device),
            f32(resolved.embedding),
            f32(resolved.lexical),
            _bucket_k(k),
        )
        return out, q_emb, lex_slots, lex_vals

    def search_batch(
        self,
        queries: List[str],
        top_k: int,
        weights: Optional[QueryWeights] = None,
        rejection_threshold: Optional[float] = None,
        use_reranker: bool = True,
        rejection_cosine_floor: Optional[float] = None,
        rejection_unseen_mass: Optional[float] = None,
        rejection_unseen_cos: Optional[float] = None,
    ) -> List[List[SearchResult]]:
        """Batched first-stage retrieval. The port has no reranker, so
        use_reranker changes nothing (as in the JAX engine without one):
        the device selects initial_k = 3 * top_k exactly and the top_k
        head is materialised."""
        del use_reranker
        if len(self.store) == 0 or not queries:
            return [[] for _ in queries]
        resolved = ResolvedWeights.from_query_weights(weights)
        top_k = max(top_k, 1)
        nq = len(queries)
        initial_k = min(len(self.store), max(top_k * 3, top_k))
        out, _, _, _ = self._dispatch(queries, top_k, initial_k, resolved)
        vals_b, emb_b, lex_b, idx_b = unpack_topk(out.cpu().numpy(), nq, initial_k)
        need_rows = min(top_k, initial_k)
        vals_l = vals_b[:, :need_rows].tolist()
        emb_l = emb_b[:, :need_rows].tolist()
        lex_l = lex_b[:, :need_rows].tolist()
        idx_l = idx_b[:, :need_rows].tolist()
        finite_l = np.isfinite(vals_b[:, :need_rows]).tolist()

        thr = rejection_threshold if rejection_threshold is not None else self._rejection_threshold
        cosf = (
            rejection_cosine_floor
            if rejection_cosine_floor is not None
            else self._rejection_cosine_floor
        )
        eff_floor = max(thr, cosf)
        unseen, um_a, um_b = self._unseen_gate(queries, rejection_unseen_mass, rejection_unseen_cos)
        um_rejected = None
        if unseen is not None:
            fin = np.isfinite(vals_b[:, :need_rows]) & (idx_b[:, :need_rows] >= 0)
            best_e = np.max(
                np.where(fin, emb_b[:, :need_rows], -np.inf), axis=1, initial=-np.inf
            )
            um_rejected = (unseen >= um_a) & (best_e <= um_b)

        outputs: List[List[SearchResult]] = []
        for qi in range(nq):
            if um_rejected is not None and um_rejected[qi]:
                outputs.append([])
                continue
            res: List[SearchResult] = []
            for rank in range(need_rows):
                slot = idx_l[qi][rank]
                if slot < 0 or not finite_l[qi][rank]:
                    continue
                if eff_floor > 0.0 and emb_l[qi][rank] < eff_floor:
                    continue
                res.append(self._result(slot, vals_l[qi][rank], emb_l[qi][rank], lex_l[qi][rank]))
            outputs.append(res)
        return outputs

    def _result(self, slot: int, score: float, emb: float, lex: float) -> SearchResult:
        m = self.store.meta_for_slot(slot)
        return SearchResult(
            text=m.text,
            score=score,
            document=m.document_name,
            chunk_id=m.id,
            chunk_index=m.chunk_index,
            page_number=m.page_number,
            section=m.section,
            embedding_score=emb,
            lexical_score=lex,
            initial_score=score,
        )

    # ----- hot-lane dispatch/fetch split -------------------------------------

    def dispatch_search(
        self,
        queries: List[str],
        top_k: int,
        weights: Optional[QueryWeights] = None,
        rejection_threshold: Optional[float] = None,
        rejection_cosine_floor: Optional[float] = None,
        rejection_unseen_mass: Optional[float] = None,
        rejection_unseen_cos: Optional[float] = None,
    ) -> Optional[PendingSearch]:
        """First half of the rerank-off hot lane: host prep and the device
        work, queued without waiting for it. Selects k = top_k directly
        (search_batch selects 3 * top_k and trims): both are exact, so
        result sets and scores agree; only the order of exactly tied
        scores may differ. None for an empty store or no queries."""
        if len(self.store) == 0 or not queries:
            return None
        resolved = ResolvedWeights.from_query_weights(weights)
        top_k = max(top_k, 1)
        k = min(len(self.store), top_k)
        out, q_emb, lex_slots, lex_vals = self._dispatch(queries, top_k, k, resolved)
        thr = rejection_threshold if rejection_threshold is not None else self._rejection_threshold
        cosf = (
            rejection_cosine_floor
            if rejection_cosine_floor is not None
            else self._rejection_cosine_floor
        )
        unseen, um_a, um_b = self._unseen_gate(queries, rejection_unseen_mass, rejection_unseen_cos)
        return PendingSearch(
            out=out, nq=len(queries), k=k, floor=max(thr, cosf, 0.0),
            q_emb=q_emb, lex_slots=lex_slots, lex_vals=lex_vals,
            resolved=resolved, kb=_bucket_k(k),
            unseen=unseen, unseen_mass=um_a, unseen_cos=um_b,
        )

    def fetch_columnar(self, pending: PendingSearch) -> ColumnarResults:
        """Second half: one device->host copy of the packed result; the
        joint unseen-term gate invalidates rejected rows."""
        vals, emb, lex, idx = unpack_topk(pending.out.cpu().numpy(), pending.nq, pending.k)
        if pending.unseen is not None:
            nq = pending.nq
            finite = np.isfinite(vals[:nq]) & (idx[:nq] >= 0)
            best_e = np.max(np.where(finite, emb[:nq], -np.inf), axis=1, initial=-np.inf)
            rejected = (pending.unseen[:nq] >= pending.unseen_mass) & (
                best_e <= pending.unseen_cos
            )
            if rejected.any():
                idx = np.array(idx)
                idx[:nq][rejected] = -1
        return ColumnarResults(vals=vals, emb=emb, lex=lex, slots=idx, floor=pending.floor)

    def results_from_columnar(self, col: ColumnarResults, qi: int) -> List[SearchResult]:
        """One query's SearchResult list from the columnar arrays."""
        row_v = col.vals[qi].tolist()
        row_e = col.emb[qi].tolist()
        row_l = col.lex[qi].tolist()
        row_i = col.slots[qi].tolist()
        out: List[SearchResult] = []
        for rank, slot in enumerate(row_i):
            v = row_v[rank]
            if slot < 0 or v != v or v in (float("inf"), float("-inf")):
                continue
            if col.floor > 0.0 and row_e[rank] < col.floor:
                continue
            out.append(self._result(slot, v, row_e[rank], row_l[rank]))
        return out

    # ----- stats / listing ---------------------------------------------------

    def list_documents(self) -> List[str]:
        return self.store.document_names()

    def get_stats(self) -> dict:
        return {
            "documents": len(self.list_documents()),
            "chunks": len(self.store),
            "status": "reindexing" if self._needs_reindex else "ready",
            "embedding_model": self.embedding_model(),
            "reranker_model": None,
            "search_mode": "exact",
        }

    # ----- persistence --------------------------------------------------------

    def save_to_disk(self) -> None:
        emb, metas = self.store.snapshot_host()
        persistence.save_index(
            self.data_dir,
            persistence.IndexState(
                model=self.embedding_model(),
                embeddings=emb,
                metas=metas,
                needs_reindex=self._needs_reindex,
                document_hashes=dict(self.document_hashes),
            ),
        )

    def load_from_disk(self) -> None:
        """Replace the resident index with the saved one of this model."""
        res = persistence.load_index(self.data_dir, self.embedding_model())
        if res.state is None:
            self._needs_reindex = res.needs_reindex
            return
        st = res.state
        if st.embeddings.shape[0]:
            if st.embeddings.shape[1] != self.store.dim:
                logger.warning(
                    "Index dim %d != encoder dim %d; marking for reindex",
                    st.embeddings.shape[1], self.store.dim,
                )
                self._needs_reindex = True
                return
            if len(self.store):
                self.store = ChunkStore(self.store.dim, self.store.dtype, device=self.device)
                self.lexical_index.clear()
            slots = self.store.add_chunks(st.metas, st.embeddings)
            for m, slot in zip(st.metas, slots):
                self.lexical_index.add_chunk(m.id, m.text, slot)
        self.document_hashes = dict(st.document_hashes)
        self._needs_reindex = st.needs_reindex or res.needs_reindex
        self.validate_index_sync()
        logger.info("Loaded %d chunks from disk", len(self.store))
