"""RagEngine of the port: ingest, the rerank-off hot lane, the MMR lanes
and the two rerank-on lanes (port of rust_local_rag_tpu/engine/rag_engine.py).

Ingest: hash skip, PDF text, sentence chunks, batched embeddings,
replace-document, index sync, persist. First stage: query embeddings stay
on the device, BM25 hits are shipped sparse, and
ops/hybrid.hybrid_topk_packed does the dense scoring (the score +
segment-max kernel on large slabs), exact top-k and the lexical blend in
one call whose packed [Q, 4, k] int32 result comes back in one copy. BM25
is the native index (ops/native_bm25.py) unless RAG_TPU_NATIVE_BM25=0.

Lanes:
  * hot lane (rerank off): dispatch_search -> fetch_columnar ->
    results_from_columnar;
  * object lane (search_batch with the reranker): the initial_k pool (or
    its top_k head at reranker weight 0) is judged in one batched forward
    and blended with the initial scores (_blend_and_fill); a failed judge
    pass falls back to initial scores and adds one to rerank_fallbacks;
  * judge-gated lane (reranker weight 0, the shipped quality
    configuration): dispatch_search -> judge_columnar -> fetch_judged ->
    results_from_judged, columnar end to end;
  * MMR hot lane (diversity > 0, rerank off): dispatch_search_mmr (pool
    select, floor gate, greedy MMR in ops/hybrid.hybrid_topk_packed_mmr)
    -> fetch_columnar -> results_from_columnar;
  * MMR object lane (search_with_diversity_batch, diversity > 0): the pool
    through search_batch, then greedy MMR on the device (_mmr_one with
    RAG_TPU_DEVICE_MMR, _mmr_many for batches of 8 or more or with
    RAG_TPU_BATCH_DEVICE_MMR) or on the host over the pool's similarities.
Rejection: the dense-cosine floor, the judge floor, the query floor on the
best judged yes-probability, and the joint unseen-term gate (2-way, or
3-way with the judge-rescue term).

Int8 capacity mode (RAG_TPU_INT8_CORPUS): an int8 slab, and every lane's
first stage is ops/hybrid.hybrid_topk_quantized(_packed), exact with
respect to the dequantised corpus and certified per query; a query whose
certificate fails is run again through hybrid_topk_dequant_full
(_int8_escalate, counted in int8_escalations). MMR takes the object lane
there, on dequantised rows.

Corpus sharding (RAG_TPU_SHARD_CORPUS=N, with RAG_TPU_DATA_PARALLEL=M
query replicas and RAG_TPU_SLICES=S slices; _build_mesh, as the JAX
engine reads them): the store is row-sharded over a parallel/mesh.Mesh,
and every first stage goes through parallel/sharded_search (f32 / bf16,
int8 and its escalation). A sharded engine serves every request on the
object lane, as the JAX engine does: supports_columnar is False, and
dispatch_search, the MMR hot lane and the judged lane decline.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
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
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService, build_default_service
from rust_local_rag_tpu_torch.models.reranker_service import (
    RerankedResult,
    RerankerCandidate,
    RerankerService,
    build_default_reranker,
)
from rust_local_rag_tpu_torch.ops.hybrid import (
    hybrid_topk,
    hybrid_topk_dequant_full,
    hybrid_topk_packed,
    hybrid_topk_packed_mmr,
    hybrid_topk_quantized,
    hybrid_topk_quantized_packed,
    lex_width_for,
    pack_topk,
    unpack_topk,
)
from rust_local_rag_tpu_torch.ops.mmr import (
    mmr_select,
    mmr_select_batch,
    mmr_select_host,
    similarity_matrix,
)
from rust_local_rag_tpu_torch.ops.native_bm25 import make_lexical_index
from rust_local_rag_tpu_torch.parallel import mesh as mesh_mod
from rust_local_rag_tpu_torch.parallel import sharded_search
from rust_local_rag_tpu_torch.utils import profiling

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
    reranker_score: Optional[float] = None
    yes_logprob: Optional[float] = None
    no_logprob: Optional[float] = None

    def to_dict(self) -> dict:
        """The JSON object of one result: the seven fixed fields, then each
        optional score that is set (rag_engine.rs serde order)."""
        d = {
            "text": self.text,
            "score": self.score,
            "document": self.document,
            "chunk_id": self.chunk_id,
            "chunk_index": self.chunk_index,
            "page_number": self.page_number,
            "section": self.section,
        }
        for k in ("embedding_score", "lexical_score", "initial_score", "reranker_score",
                  "yes_logprob", "no_logprob"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d


@dataclass
class PendingSearch:
    """Dispatched hot-lane search whose result is not fetched yet."""

    out: torch.Tensor  # packed [nq_pad, 4, kb] int32 on the device (5: int8 certificate)
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


@dataclass
class PendingJudged:
    """Judge-gated search: first stage fetched, judge forward dispatched
    but not fetched."""

    col: ColumnarResults
    handle: object              # reranker dispatch handle
    flat_qi: np.ndarray         # [M] query index of each scored prompt
    flat_rank: np.ndarray       # [M] row rank of each scored prompt
    nq: int
    thr: float                  # judge yes-probability floor
    cos_floor: float            # dense-cosine floor (joint gate)
    q_floor: float              # query floor on the best judged yes-p
    init_w: float               # resolved initial-score blend weight
    # the 3-way unseen gate, applied in fetch_judged once the judged yes-p
    # of every row is known; None = off
    unseen: Optional[np.ndarray] = None
    unseen_mass: float = 0.0
    unseen_cos: float = 1.0
    unseen_judge: float = 0.0


@dataclass
class JudgedColumnar:
    """Judge-gated results: the first-stage columnar arrays plus the judge
    outputs of each row and the score the object lane's blend gives at
    reranker weight 0."""

    col: ColumnarResults
    score: np.ndarray    # [nq, k] init_w * initial / max(initial) per row
    rr: np.ndarray       # [nq, k] judge yes-probability (-inf = unjudged)
    yes: np.ndarray      # [nq, k] yes logprob
    no: np.ndarray       # [nq, k] no logprob
    thr: float
    cos_floor: float


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
        reranker: Optional[RerankerService] = None,
        corpus_dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ):
        """The slab is f32 unless RAG_TPU_CORPUS_DTYPE=bf16 (or corpus_dtype)
        says otherwise, and int8 when RAG_TPU_INT8_CORPUS is set. Loads any
        saved index of the model from data_dir."""
        self.data_dir = data_dir
        self.embedding_service = embedding_service
        self.reranker = reranker
        # object-lane judge passes answered with initial scores instead
        self.rerank_fallbacks = 0
        # queries whose int8 certificate failed, run on the full-f32 lane
        self.int8_escalations = 0
        self._counts_lock = threading.Lock()
        self.device = resolve_device(device)
        dtype_env = os.environ.get("RAG_TPU_CORPUS_DTYPE")
        if dtype_env == "bf16":
            corpus_dtype = torch.bfloat16
        elif dtype_env == "f32":
            corpus_dtype = torch.float32
        self._build_mesh()
        self.store = ChunkStore(
            embedding_service.dim, corpus_dtype, device=self.device,
            quantized=bool(os.environ.get("RAG_TPU_INT8_CORPUS")),
            mesh=self._mesh, corpus_axis=self._corpus_axes,
        )
        self.lexical_index = make_lexical_index()
        self.document_hashes: Dict[str, str] = {}
        self._needs_reindex = False
        self._device_mmr = bool(os.environ.get("RAG_TPU_DEVICE_MMR"))
        # engine-level rejection (see the JAX engine's __init__ notes): the
        # judge / dense-cosine floors, the query floor on the best judged
        # yes-probability, and the joint unseen-term gate with its
        # judge-rescue term (0 = the 2-way gate)
        self._rejection_threshold = env_float("RAG_TPU_REJECTION_THRESHOLD", 0.0)
        self._rejection_cosine_floor = env_float("RAG_TPU_REJECTION_COSINE_FLOOR", 0.0)
        self._rejection_query_floor = env_float("RAG_TPU_REJECTION_QUERY_FLOOR", 0.0)
        self._rejection_unseen_mass = env_float("RAG_TPU_REJECTION_UNSEEN_MASS", 0.0)
        self._rejection_unseen_cos = env_float("RAG_TPU_REJECTION_UNSEEN_COS", 1.0)
        self._rejection_unseen_judge = env_float("RAG_TPU_REJECTION_UNSEEN_JUDGE", 0.0)
        self.load_from_disk()

    def _build_mesh(self) -> None:
        """The corpus mesh from RAG_TPU_SHARD_CORPUS (shards),
        RAG_TPU_DATA_PARALLEL (query replicas) and RAG_TPU_SLICES (shards =
        slices x chips a slice, merged slice-innermost first), with the JAX
        engine's warnings and fallbacks (JAX rag_engine.py:234-320): slices
        that do not divide the shards are ignored, replicas without shards
        are ignored, replicas x shards beyond the devices fall back to
        corpus sharding alone, and fewer devices than shards run unsharded.
        Devices: parallel/mesh.available_devices."""
        self._mesh = None
        self._data_axis = None
        self._data_parallel = 1
        self._corpus_axes = "corpus"
        shards = int(os.environ.get("RAG_TPU_SHARD_CORPUS", "0") or 0)
        dp = int(os.environ.get("RAG_TPU_DATA_PARALLEL", "1") or 1)
        slices = int(os.environ.get("RAG_TPU_SLICES", "0") or 0)
        if slices > 1 and (shards <= 1 or shards % slices):
            logger.warning("RAG_TPU_SLICES=%d must divide RAG_TPU_SHARD_CORPUS=%d; ignoring slices", slices, shards)
            slices = 0
        if shards <= 1:
            if dp > 1:
                logger.warning("RAG_TPU_DATA_PARALLEL=%d requires RAG_TPU_SHARD_CORPUS>1 (query replicas ride "
                               "the composed mesh); ignoring", dp)
            return
        devices = mesh_mod.available_devices(self.device)
        corpus_shape = (slices, shards // slices) if slices > 1 else (shards,)
        corpus_axes = ("slice", "corpus") if slices > 1 else ("corpus",)
        if dp > 1 and len(devices) >= dp * shards:
            self._mesh = mesh_mod.build_mesh((dp, *corpus_shape), ("data", *corpus_axes), devices[:dp * shards])
            self._data_axis = "data"
            self._data_parallel = dp
            logger.info("Composed mesh: %d query replicas x %s corpus shards (%s)",
                        dp, "x".join(str(s) for s in corpus_shape), devices[0].type)
        elif len(devices) >= shards:
            if dp > 1:
                logger.warning("RAG_TPU_DATA_PARALLEL=%d x RAG_TPU_SHARD_CORPUS=%d needs %d devices but only %d "
                               "exist; running with corpus sharding only", dp, shards, dp * shards, len(devices))
            self._mesh = mesh_mod.build_mesh(corpus_shape, corpus_axes, devices[:shards])
            logger.info("Corpus sharded over %s devices (%s)", "x".join(str(s) for s in corpus_shape),
                        devices[0].type)
        else:
            logger.warning("RAG_TPU_SHARD_CORPUS=%d but only %d devices; running unsharded", shards, len(devices))
        if self._mesh is not None and slices > 1:
            self._corpus_axes = ("slice", "corpus")

    # ----- lifecycle -------------------------------------------------------

    @classmethod
    def create(
        cls,
        data_dir: str,
        device: str | torch.device = "cuda",
        model_name: Optional[str] = None,
        reranker: Optional[RerankerService] = None,
    ) -> "RagEngine":
        """Engine over the configured encoder (build_default_service: the
        committed encoder and tokenizer, or the hash encoder in hermetic
        mode) named `model_name` or get_embedding_model(), with `reranker`
        or else the configured one (build_default_reranker: none unless
        RAG_TPU_RERANK_MODEL names one)."""
        svc = build_default_service(device, model_name)
        svc.verify()
        if reranker is None:
            reranker = build_default_reranker(device)
        return cls(data_dir, svc, reranker, device=device)

    def _empty_store(self, dim: int) -> ChunkStore:
        """An empty store of the resident one's kind (dtype, int8 mode,
        mesh)."""
        return ChunkStore(dim, self.store.dtype, device=self.device, quantized=self.store.quantized,
                          mesh=self._mesh, corpus_axis=self._corpus_axes)

    def needs_reindex(self) -> bool:
        return self._needs_reindex

    def embedding_model(self) -> str:
        return self.embedding_service.model_name

    def has_reranker(self) -> bool:
        return self.reranker is not None

    def get_reranker(self) -> Optional[RerankerService]:
        return self.reranker

    def switch_embedding_model(self, new_service: EmbeddingService) -> None:
        """Swap the embedding model in process without losing either model's
        index (JAX rag_engine.py:449-483): save the current model's index,
        rebuild the slab at the new encoder's dim, and load the new model's
        index from disk (empty, with needs_reindex, when it has hashes but
        no chunks)."""
        if new_service.model_name == self.embedding_model():
            return
        if len(self.store):
            self.save_to_disk()
        self.embedding_service = new_service
        self.store = self._empty_store(new_service.dim)
        self.lexical_index.clear()
        self.document_hashes = {}
        self._needs_reindex = False
        self.load_from_disk()
        if len(self.store) == 0 and self.document_hashes:
            self._needs_reindex = True
        logger.info("Switched embedding model to '%s' (%d chunks resident)",
                    new_service.model_name, len(self.store))

    def finalize_reindex(self) -> None:
        """End of a reindex job (rag_engine.rs:204-215): clear
        needs_reindex and save."""
        if self._needs_reindex:
            self._needs_reindex = False
            self.save_to_disk()
            logger.info("Reindexing complete. Indexed %d chunks across %d documents.",
                        len(self.store), len(self.list_documents()))

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
        n = len(metas)
        with profiling.span("store.add", n):
            with profiling.span("store.normalize", n):
                rows = np.stack([_normalize_vec(e) for e in embeddings])
            with profiling.span("store.slab", n):
                slots = self.store.add_chunks(metas, rows)
            with profiling.span("store.bm25", n):
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
        """One query through search_batch (same keyword options)."""
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
        (normalised, zero rows as padding), which a sharded engine always
        takes, as the JAX engine does."""
        with profiling.span("engine.prep_queries", len(queries)):
            if self._mesh is None:
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
        with profiling.span("engine.prep_lexical", len(queries)):
            for qi, query in enumerate(queries):
                self.lexical_index.score_slots_into(query, limit, lex_slots[qi], lex_vals[qi])
        return lex_slots, lex_vals

    def _f32(self, x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=self.device)

    def _dispatch(
        self, queries: List[str], top_k: int, k: int, resolved: ResolvedWeights, with_sims: bool = False
    ):
        """First stage of a batch: the packed [Q, 4, kb] result ([Q, 5, kb]
        on an int8 store, channel 4 the certificate), or with with_sims the
        unpacked outputs of hybrid_topk (hybrid_topk_quantized: the
        certificate fifth), the last the [Q, kb, kb] candidate
        similarities. A sharded engine runs the sharded functions, its
        padded batch a multiple of the query replicas."""
        dp = self._data_parallel
        nq_pad = -(-max(_bucket_batch(len(queries)), dp) // dp) * dp
        q_emb = self._prep_queries(queries, nq_pad)
        lex_slots, lex_vals = self._prep_lexical(queries, top_k, nq_pad)
        with profiling.span("engine.dispatch", len(queries)):
            store = self.store
            args = (
                q_emb,
                store.corpus(),
                *((store.scales(), store.l1()) if store.quantized else ()),
                store.valid_mask(),
                torch.as_tensor(lex_slots, device=self.device),
                torch.as_tensor(lex_vals, device=self.device),
                self._f32(resolved.embedding),
                self._f32(resolved.lexical),
                _bucket_k(k),
            )
            if self._mesh is not None:
                fn = (sharded_search.sharded_hybrid_topk_quantized if store.quantized
                      else sharded_search.sharded_hybrid_topk)
                out = fn(*args, mesh=self._mesh, corpus_axis=self._corpus_axes, with_sims=with_sims,
                         data_axis=self._data_axis)
                if not with_sims:
                    out = pack_topk(*out)
            elif store.quantized:
                out = (hybrid_topk_quantized(*args, with_sims=True) if with_sims
                       else hybrid_topk_quantized_packed(*args))
            else:
                out = hybrid_topk(*args, with_sims=True) if with_sims else hybrid_topk_packed(*args)
        return out, q_emb, lex_slots, lex_vals

    def search_batch(
        self,
        queries: List[str],
        top_k: int,
        weights: Optional[QueryWeights] = None,
        rejection_threshold: Optional[float] = None,
        use_reranker: bool = True,
        rejection_cosine_floor: Optional[float] = None,
        rejection_query_floor: Optional[float] = None,
        rejection_unseen_mass: Optional[float] = None,
        rejection_unseen_cos: Optional[float] = None,
        rejection_unseen_judge: Optional[float] = None,
        collect_sims: bool = False,
    ):
        """Two-stage retrieval for a batch (the object lane): one first-stage
        pass selects initial_k = 3 * top_k exactly; with a reranker and
        use_reranker, every query's candidates go through one batched judge
        forward and are blended with their initial scores. Without a
        reranker (or with use_reranker False) the top_k head is
        materialised directly (rag_engine.py:716-1105 there).

        collect_sims (the MMR object lane): -> (results, (sims [nq, kb, kb],
        [{chunk_id: candidate row}] per query)), the similarities of the
        first stage's candidates from the same call; (results, None) on an
        empty store."""
        if len(self.store) == 0 or not queries:
            empty = [[] for _ in queries]
            return (empty, None) if collect_sims else empty
        resolved = ResolvedWeights.from_query_weights(weights)
        top_k = max(top_k, 1)
        nq = len(queries)
        initial_k = min(len(self.store), max(top_k * 3, top_k))
        out, q_emb, lex_slots, lex_vals = self._dispatch(queries, top_k, initial_k, resolved, with_sims=collect_sims)
        # Only rows that can be emitted are materialised: the whole pool
        # when the judge's score enters the blend, else the top_k head
        # (device rows are sorted by combined score, and at reranker weight
        # 0 the blend keeps that order; with both weights 0 the blend falls
        # back to judge order over the pool, so the head is not enough).
        reranking = self.reranker is not None and use_reranker
        head_only = not reranking or (resolved.reranker == 0.0 and resolved.initial > 0.0)
        need_rows = min(top_k, initial_k) if head_only else initial_k
        sims_b = flags = None
        if collect_sims:
            with profiling.span("engine.fetch", nq):
                host = [x[:nq].cpu().numpy() for x in out]
            sims_b = host.pop()
            vals_b, emb_b, lex_b, idx_b = (x[:, :initial_k] for x in host[:4])
            if len(host) > 4:
                flags = host[4]
        else:
            with profiling.span("engine.fetch", nq):
                arr = out.cpu().numpy()
            vals_b, emb_b, lex_b, idx_b = unpack_topk(arr, nq, initial_k)
            if arr.shape[1] > 4:
                flags = arr[:nq, 4, 0] > 0
        if flags is not None and not flags.all():
            vals_b, emb_b, lex_b, idx_b, sims_b = self._int8_escalate(
                q_emb, lex_slots, lex_vals, resolved, _bucket_k(initial_k), np.flatnonzero(~flags),
                (vals_b, emb_b, lex_b, idx_b), initial_k, sims_b=sims_b,
            )
        vals_l = vals_b[:, :need_rows].tolist()
        emb_l = emb_b[:, :need_rows].tolist()
        lex_l = lex_b[:, :need_rows].tolist()
        idx_l = idx_b[:, :need_rows].tolist()
        finite_l = np.isfinite(vals_b[:, :need_rows]).tolist()

        thr = rejection_threshold if rejection_threshold is not None else self._rejection_threshold
        cos_floor = (
            rejection_cosine_floor
            if rejection_cosine_floor is not None
            else self._rejection_cosine_floor
        )
        unseen, um_a, um_b = self._unseen_gate(queries, rejection_unseen_mass, rejection_unseen_cos)
        um_rejected = None
        if unseen is not None:
            fin = np.isfinite(vals_b[:, :need_rows]) & (idx_b[:, :need_rows] >= 0)
            best_e = np.max(
                np.where(fin, emb_b[:, :need_rows], -np.inf), axis=1, initial=-np.inf
            )
            um_rejected = (unseen >= um_a) & (best_e <= um_b)

        if not reranking and not collect_sims:
            # rows arrive sorted by combined score, the fallback-fill order;
            # without a judge the rejection confidence is the dense cosine
            eff_floor = max(thr, cos_floor)
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

        per_query_candidates: List[List[dict]] = []
        for qi in range(nq):
            candidates: List[dict] = []
            for rank in range(need_rows):
                slot = idx_l[qi][rank]
                if slot < 0 or not finite_l[qi][rank]:
                    continue
                candidates.append({
                    "slot": slot,
                    "rank": rank,  # the row in the first stage's candidate order
                    "meta": self.store.meta_for_slot(slot),
                    "initial_score": vals_l[qi][rank],
                    "embedding_score": emb_l[qi][rank],
                    "lexical_score": lex_l[qi][rank],
                })
            per_query_candidates.append(candidates)

        # every query's candidates in one batched judge forward
        flat_inputs = [
            (qi, RerankerCandidate(
                chunk_id=c["meta"].id,
                document=c["meta"].document_name,
                text=c["meta"].text,
                page_number=c["meta"].page_number,
                section=c["meta"].section,
                initial_score=c["initial_score"],
            ))
            for qi, candidates in enumerate(per_query_candidates)
            for c in candidates
        ] if reranking else []
        per_query_reranked: List[List[RerankedResult]] = [[] for _ in range(nq)]
        if flat_inputs:
            try:
                per_query_reranked = self._rerank_flat(queries, flat_inputs, nq)
            except Exception:  # noqa: BLE001 - the reference degrades to initial scores (rag_engine.rs:586-597)
                logger.warning("Reranker failed, falling back to initial scores", exc_info=True)
                with self._counts_lock:
                    self.rerank_fallbacks += 1

        outputs = [
            self._blend_and_fill(per_query_candidates[qi], per_query_reranked[qi], resolved, top_k)
            for qi in range(nq)
        ]
        if um_rejected is not None:
            um_judge = (
                rejection_unseen_judge
                if rejection_unseen_judge is not None
                else self._rejection_unseen_judge
            )
            if um_judge > 0.0 and any(per_query_reranked):
                # 3-way rule: a confident judged yes anywhere in the pool
                # vetoes the unseen-term rejection
                for qi in range(nq):
                    judged = [r.relevance for r in per_query_reranked[qi]]
                    if judged and max(judged) > um_judge:
                        um_rejected[qi] = False
            outputs = [[] if um_rejected[qi] else outputs[qi] for qi in range(nq)]
        q_floor = (
            rejection_query_floor
            if rejection_query_floor is not None
            else self._rejection_query_floor
        )
        if q_floor > 0.0 and reranking:
            # query-level rejection: the best judged yes-probability over
            # the whole judged pool decides whether the query is answerable
            for qi in range(nq):
                judged = [r.relevance for r in per_query_reranked[qi]]
                if judged and max(judged) < q_floor:
                    outputs[qi] = []
        if thr > 0.0 or cos_floor > 0.0:
            # confidence: the judge's yes-probability where the row was
            # judged, and then the cosine floor must pass too (the joint
            # gate); else the absolute dense cosine
            def _keep(r: SearchResult) -> bool:
                if r.reranker_score is not None:
                    if thr > 0.0 and r.reranker_score < thr:
                        return False
                    return not (cos_floor > 0.0 and (r.embedding_score or 0.0) < cos_floor)
                return (r.embedding_score or 0.0) >= max(thr, cos_floor)

            outputs = [[r for r in out if _keep(r)] for out in outputs]
        if not collect_sims:
            return outputs
        rank_maps = [{c["meta"].id: c["rank"] for c in per_query_candidates[qi]} for qi in range(nq)]
        return outputs, (sims_b, rank_maps)

    def _int8_escalate(
        self, q_emb: torch.Tensor, lex_slots: np.ndarray, lex_vals: np.ndarray, resolved: ResolvedWeights,
        k: int, fail_rows: np.ndarray, arrays, trim_k: int, sims_b: Optional[np.ndarray] = None,
    ):
        """Run the queries whose int8 certificate failed (near-ties at the
        quantisation boundary) again through the unconditionally exact
        full-f32 lane (hybrid_topk_dequant_full; its sharded twin on a
        mesh, the batch replicated) and patch their rows, and with sims_b
        their candidate similarities over dequantised rows, into the
        batch's arrays -> (vals, emb, lex, idx, sims_b). The failing rows
        pad to a power of two, as a batch does."""
        nf = len(fail_rows)
        logger.info("int8 exactness certificate failed for %d/%d queries; "
                    "escalating to the full-f32 dequantized lane", nf, arrays[0].shape[0])
        with self._counts_lock:
            self.int8_escalations += nf
        rows_idx = np.zeros(_bucket_batch(nf), dtype=np.int64)
        rows_idx[:nf] = fail_rows
        args = (
            q_emb[torch.as_tensor(rows_idx, device=q_emb.device)],
            self.store.corpus(),
            self.store.scales(),
            self.store.valid_mask(),
            torch.as_tensor(lex_slots[rows_idx], device=self.device),
            torch.as_tensor(lex_vals[rows_idx], device=self.device),
            self._f32(resolved.embedding),
            self._f32(resolved.lexical),
            k,
        )
        if self._mesh is not None:
            out = sharded_search.sharded_hybrid_topk_dequant_full(
                *args, mesh=self._mesh, corpus_axis=self._corpus_axes)
            if sims_b is not None:
                rows = self.store.gather_rows(out[3].clamp(min=0))  # [Q, k, D] f32, dequantised
                out = (*out, torch.bmm(rows, rows.transpose(1, 2)))
        else:
            out = hybrid_topk_dequant_full(*args, with_sims=sims_b is not None)
        fixed = [x.cpu().numpy() for x in out]
        planes = [np.array(a) for a in arrays]
        for plane, f in zip(planes, fixed):
            plane[fail_rows] = f[:nf, :trim_k]
        if sims_b is not None:
            sims_b = np.array(sims_b)
            sims_b[fail_rows] = fixed[4][:nf]
        return (*planes, sims_b)

    def _rerank_flat(self, queries: List[str], flat_inputs, nq: int) -> List[List[RerankedResult]]:
        """Score every (query, candidate) pair in one forward; regroup and
        sort each query's results by relevance (reranker.rs:261-266)."""
        prompts = self.reranker.build_prompts(queries, flat_inputs)
        scored = self.reranker.score_prompts(prompts)
        grouped: List[List[RerankedResult]] = [[] for _ in range(nq)]
        for (qi, cand), (s, y, n) in zip(flat_inputs, scored):
            grouped[qi].append(
                RerankedResult(chunk_id=cand.chunk_id, relevance=float(s), yes_logprob=y, no_logprob=n)
            )
        for g in grouped:
            g.sort(key=lambda r: -r.relevance)
        return grouped

    def _blend_and_fill(
        self, candidates: List[dict], reranked: List[RerankedResult], resolved: ResolvedWeights, top_k: int
    ) -> List[SearchResult]:
        """Per-query max normalisation and blend of judge and initial scores
        (rag_engine.rs:602-665), then a fill from initial scores up to top_k
        (rag_engine.rs:667-698)."""
        if not candidates:
            return []
        by_id = {c["meta"].id: c for c in candidates}
        ordered: List[SearchResult] = []
        seen: set = set()
        if reranked:
            max_rr = max(max((r.relevance for r in reranked), default=0.0), F32_EPSILON)
            max_init = max(max((c["initial_score"] for c in candidates), default=0.0), F32_EPSILON)
            for r in reranked:
                c = by_id.get(r.chunk_id)
                if c is None or r.chunk_id in seen:
                    continue
                seen.add(r.chunk_id)
                blended = (
                    resolved.reranker * (r.relevance / max_rr)
                    + resolved.initial * (c["initial_score"] / max_init)
                )
                res = self._candidate_result(c, blended)
                res.reranker_score = r.relevance
                res.yes_logprob = r.yes_logprob
                res.no_logprob = r.no_logprob
                ordered.append(res)
            ordered.sort(key=lambda r: -r.score)
            ordered = ordered[:top_k]
        if len(ordered) < top_k:
            for c in sorted(candidates, key=lambda c: -c["initial_score"]):
                if len(ordered) == top_k:
                    break
                if c["meta"].id in seen:
                    continue
                seen.add(c["meta"].id)
                ordered.append(self._candidate_result(c, c["initial_score"]))
        return ordered

    def _candidate_result(self, c: dict, score: float) -> SearchResult:
        return self._result(
            c["slot"], score, c["embedding_score"], c["lexical_score"], initial=c["initial_score"]
        )

    def search_with_diversity(
        self, query: str, top_k: int, diversity_factor: float, weights: Optional[QueryWeights] = None, **kw
    ) -> List[SearchResult]:
        """MMR-diversified search of one query (rag_engine.rs:717-759)."""
        return self.search_with_diversity_batch([query], top_k, diversity_factor, weights, **kw)[0]

    def search_with_diversity_batch(
        self,
        queries: List[str],
        top_k: int,
        diversity_factor: float,
        weights: Optional[QueryWeights] = None,
        **kw,
    ) -> List[List[SearchResult]]:
        """The object lane with MMR: diversity 0 is search_batch (same
        keyword options); otherwise a pool of max(3 top_k, top_k + 10)
        candidates through search_batch, then greedy MMR, on the device for
        RAG_TPU_DEVICE_MMR (_mmr_one) or for batches of 8 or more
        (RAG_TPU_BATCH_DEVICE_MMR forces either way; _mmr_many), else on
        the host over the pool's similarities from the same first-stage
        call."""
        diversity_factor = min(max(diversity_factor, 0.0), 1.0)
        if diversity_factor == 0.0:
            return self.search_batch(queries, top_k, weights, **kw)
        pool = max(top_k * 3, top_k + 10)
        nq = len(queries)
        if self._device_mmr:
            pooled = self.search_batch(queries, pool, weights, **kw)
            with profiling.span("engine.mmr", nq):
                return [self._mmr_one(results, top_k, diversity_factor) for results in pooled]
        env = os.environ.get("RAG_TPU_BATCH_DEVICE_MMR")
        if env is not None:
            batch_device = env not in ("", "0", "false")
        else:
            batch_device = nq >= 8
        if batch_device:
            pooled = self.search_batch(queries, pool, weights, **kw)
            with profiling.span("engine.mmr", nq):
                return self._mmr_many(pooled, top_k, diversity_factor)
        pooled, sims_info = self.search_batch(queries, pool, weights, collect_sims=True, **kw)
        if sims_info is None:
            return pooled
        sims_b, rank_maps = sims_info
        out: List[List[SearchResult]] = []
        with profiling.span("engine.mmr", nq):
            for qi, results in enumerate(pooled):
                results = [r for r in results if r.chunk_id in rank_maps[qi]]
                if not results:
                    out.append([])
                    continue
                ranks = np.asarray([rank_maps[qi][r.chunk_id] for r in results], dtype=np.int64)
                rel = np.asarray([r.score for r in results], dtype=np.float32)
                selected = mmr_select_host(sims_b[qi][np.ix_(ranks, ranks)], rel, top_k, diversity_factor)
                out.append([results[i] for i in selected])
        return out

    def _mmr_many(
        self, pooled: List[List[SearchResult]], top_k: int, diversity_factor: float
    ) -> List[List[SearchResult]]:
        """Greedy MMR of a batch of pools on the device: one gather and one
        batched selection (ops/mmr.mmr_select_batch); only [Q, k] indices
        come back. Both padded axes are bucketed, as in the JAX engine."""
        per = [[r for r in results if self.store.contains(r.chunk_id)] for results in pooled]
        nq = len(per)
        if nq == 0 or all(not r for r in per):
            return [[] for _ in per]
        nq_pad = _bucket_batch(nq)
        p_pad = _bucket_k(max(len(r) for r in per))
        slots = np.zeros((nq_pad, p_pad), dtype=np.int32)
        rel = np.full((nq_pad, p_pad), -np.inf, dtype=np.float32)
        counts = np.zeros(nq_pad, dtype=np.int32)
        for qi, results in enumerate(per):
            n = len(results)
            counts[qi] = n
            if n:
                slots[qi, :n] = [self.store.slot_for_id(r.chunk_id) for r in results]
                rel[qi, :n] = [r.score for r in results]
        sel = mmr_select_batch(
            self.store.gather_rows(slots),
            torch.as_tensor(rel, device=self.device),
            _bucket_k(top_k),
            diversity_factor,
            torch.as_tensor(counts, device=self.device),
        ).cpu().numpy()[:, :top_k]
        return [[per[qi][int(i)] for i in sel[qi] if i >= 0] for qi in range(nq)]

    def _mmr_one(self, results: List[SearchResult], top_k: int, diversity_factor: float) -> List[SearchResult]:
        """Greedy MMR of one pool: on the device with RAG_TPU_DEVICE_MMR
        (ops/mmr.mmr_select), else the pool's [P, P] similarities on the
        device and the greedy scan on the host."""
        results = [r for r in results if self.store.contains(r.chunk_id)]
        if not results:
            return []
        n = len(results)
        rel = np.asarray([r.score for r in results], dtype=np.float32)
        p_pad = _bucket_k(n)
        slots = np.zeros(p_pad, dtype=np.int32)
        slots[:n] = [self.store.slot_for_id(r.chunk_id) for r in results]
        emb = self.store.gather_rows(slots)
        if self._device_mmr:
            rel_pad = np.full(p_pad, -np.inf, dtype=np.float32)
            rel_pad[:n] = rel
            sel = mmr_select(
                emb, torch.as_tensor(rel_pad, device=self.device), _bucket_k(top_k), diversity_factor, valid_count=n
            ).cpu().numpy()[:top_k]
            return [results[int(i)] for i in sel if i >= 0]
        sims = similarity_matrix(emb).cpu().numpy()[:n, :n]
        return [results[i] for i in mmr_select_host(sims, rel, top_k, diversity_factor)]

    def _result(
        self, slot: int, score: float, emb: float, lex: float, initial: Optional[float] = None
    ) -> SearchResult:
        """SearchResult of a store slot; the initial score is `score`
        unless given."""
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
            initial_score=score if initial is None else initial,
        )

    # ----- hot-lane dispatch/fetch split -------------------------------------

    def supports_columnar(self) -> bool:
        """The columnar lanes (hot, MMR hot, judged) serve an unsharded
        store; a sharded engine keeps every request on the object lane, as
        the JAX engine does (its hot lane selects k rows where the object
        lane selects 3k, so the two may order exact ties differently)."""
        return self._mesh is None

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
        scores may differ. None for an empty store, no queries or a
        sharded engine."""
        if not self.supports_columnar() or len(self.store) == 0 or not queries:
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

    def supports_columnar_mmr(self) -> bool:
        """The MMR hot lane serves unsharded f32 and bf16 slabs. An int8
        store keeps the object lane, as in the JAX package: its escalation
        gives score-ordered planes, which cannot patch an MMR-ordered
        fetch."""
        return self.supports_columnar() and not self.store.quantized

    def dispatch_search_mmr(
        self,
        queries: List[str],
        top_k: int,
        diversity_factor: float,
        weights: Optional[QueryWeights] = None,
        rejection_threshold: Optional[float] = None,
        rejection_cosine_floor: Optional[float] = None,
        rejection_unseen_mass: Optional[float] = None,
        rejection_unseen_cos: Optional[float] = None,
    ) -> Optional[PendingSearch]:
        """First half of the MMR hot lane: host prep, then pool selection,
        floor gate, candidate gather and greedy MMR in one call
        (ops/hybrid.hybrid_topk_packed_mmr), queued without waiting;
        fetch_columnar returns the planes already in MMR order. The pool is
        max(3 top_k, top_k + 10) candidates and the lexical request is sized
        by it, as the object lane's search_batch call sizes them. (The JAX
        engine selects MMR from the pool's bucket, 32 or 512 candidates for
        30 or 300, which the object lane and the reference do not consider;
        the port takes the pool itself.) None for an empty store or no
        queries (reference rag_engine.rs:717-759)."""
        if not self.supports_columnar_mmr() or len(self.store) == 0 or not queries:
            return None
        resolved = ResolvedWeights.from_query_weights(weights)
        top_k = max(top_k, 1)
        diversity_factor = min(max(diversity_factor, 0.0), 1.0)
        nq_pad = _bucket_batch(len(queries))
        pool = min(len(self.store), max(top_k * 3, top_k + 10))
        q_emb = self._prep_queries(queries, nq_pad)
        lex_slots, lex_vals = self._prep_lexical(queries, pool, nq_pad)
        k = min(len(self.store), top_k)
        thr = rejection_threshold if rejection_threshold is not None else self._rejection_threshold
        cosf = (
            rejection_cosine_floor
            if rejection_cosine_floor is not None
            else self._rejection_cosine_floor
        )
        floor = max(thr, cosf, 0.0)
        with profiling.span("engine.dispatch", len(queries)):
            out = hybrid_topk_packed_mmr(
                q_emb,
                self.store.corpus(),
                self.store.valid_mask(),
                torch.as_tensor(lex_slots, device=self.device),
                torch.as_tensor(lex_vals, device=self.device),
                self._f32(resolved.embedding),
                self._f32(resolved.lexical),
                diversity_factor,
                floor,
                pool,
                _bucket_k(k),
            )
        unseen, um_a, um_b = self._unseen_gate(queries, rejection_unseen_mass, rejection_unseen_cos)
        return PendingSearch(
            out=out, nq=len(queries), k=k, floor=floor,
            q_emb=q_emb, lex_slots=lex_slots, lex_vals=lex_vals,
            resolved=resolved, kb=_bucket_k(k),
            unseen=unseen, unseen_mass=um_a, unseen_cos=um_b,
        )

    def fetch_columnar(self, pending: PendingSearch) -> ColumnarResults:
        """Second half: one device->host copy of the packed result. An int8
        lane's certificate plane is read here and failing queries
        escalate (_int8_escalate); the joint unseen-term gate invalidates
        rejected rows."""
        with profiling.span("engine.fetch", pending.nq):
            arr = pending.out.cpu().numpy()
        vals, emb, lex, idx = unpack_topk(arr, pending.nq, pending.k)
        if arr.shape[1] > 4:
            flags = arr[: pending.nq, 4, 0] > 0
            if not flags.all():
                vals, emb, lex, idx, _ = self._int8_escalate(
                    pending.q_emb, pending.lex_slots, pending.lex_vals, pending.resolved, pending.kb,
                    np.flatnonzero(~flags), (vals, emb, lex, idx), pending.k,
                )
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

    # ----- judge-gated lane (the quality configuration, columnar) -------------

    def supports_judged_columnar(self, weights: Optional[QueryWeights], use_reranker: bool) -> bool:
        """The judge-gated lane serves reranking at blend weight 0 (the judge
        as a rejection gate over the initial order): the blend is then a
        monotonic transform of the first-stage order, so only the top_k
        head is emitted and the lane stays columnar. Not on a sharded
        engine."""
        if not self.supports_columnar() or self.reranker is None or not use_reranker:
            return False
        resolved = ResolvedWeights.from_query_weights(weights)
        return resolved.reranker == 0.0 and resolved.initial > 0.0

    def judge_columnar(
        self,
        pending: PendingSearch,
        queries: List[str],
        weights: Optional[QueryWeights] = None,
        rejection_threshold: Optional[float] = None,
        rejection_cosine_floor: Optional[float] = None,
        rejection_query_floor: Optional[float] = None,
        rejection_unseen_mass: Optional[float] = None,
        rejection_unseen_cos: Optional[float] = None,
        rejection_unseen_judge: Optional[float] = None,
    ) -> PendingJudged:
        """Fetch the first stage, build a judge prompt for every valid head
        row and dispatch one batched judge forward without fetching it.
        With the judge-rescue term off, the 2-way unseen gate applies here
        (a rejected query gets no prompts); with it on, the gate waits for
        the judged yes-probabilities in fetch_judged."""
        um_judge = (
            rejection_unseen_judge
            if rejection_unseen_judge is not None
            else self._rejection_unseen_judge
        )
        unseen, um_a, um_b = self._unseen_gate(queries, rejection_unseen_mass, rejection_unseen_cos)
        if unseen is not None and um_judge <= 0.0 and pending.unseen is None:
            pending.unseen = unseen
            pending.unseen_mass = um_a
            pending.unseen_cos = um_b
        col = self.fetch_columnar(pending)
        nq = pending.nq
        resolved = ResolvedWeights.from_query_weights(weights)
        thr = rejection_threshold if rejection_threshold is not None else self._rejection_threshold
        cos_floor = (
            rejection_cosine_floor
            if rejection_cosine_floor is not None
            else self._rejection_cosine_floor
        )
        q_floor = (
            rejection_query_floor
            if rejection_query_floor is not None
            else self._rejection_query_floor
        )
        flat_rank: List[int] = []
        pairs: List[tuple] = []
        finite = np.isfinite(col.vals[:nq])
        for qi in range(nq):
            for rank in range(col.slots.shape[1]):
                slot = int(col.slots[qi, rank])
                if slot < 0 or not finite[qi, rank]:
                    continue
                m = self.store.meta_for_slot(slot)
                pairs.append((qi, RerankerCandidate(
                    chunk_id=m.id,
                    document=m.document_name,
                    text=m.text,
                    page_number=m.page_number,
                    section=m.section,
                    initial_score=float(col.vals[qi, rank]),
                )))
                flat_rank.append(rank)
        prompts = self.reranker.build_prompts(queries, pairs)
        return PendingJudged(
            col=col,
            handle=self.reranker.dispatch_prompts(prompts),
            flat_qi=np.asarray([qi for qi, _ in pairs], dtype=np.int64),
            flat_rank=np.asarray(flat_rank, dtype=np.int64),
            nq=nq,
            thr=max(thr, 0.0),
            cos_floor=max(cos_floor, 0.0),
            q_floor=max(q_floor, 0.0),
            init_w=resolved.initial,
            unseen=unseen if um_judge > 0.0 else None,
            unseen_mass=um_a,
            unseen_cos=um_b,
            unseen_judge=um_judge,
        )

    def fetch_judged(self, pj: PendingJudged) -> JudgedColumnar:
        """Fetch the judge's logprobs, apply the 3-way unseen gate and the
        query floor by invalidating slot rows, and compute the object
        lane's weight-0 blend: init_w * initial / max(initial), the max
        floored at F32_EPSILON."""
        scored = self.reranker.fetch_prompts(pj.handle)
        col = pj.col
        nq = pj.nq
        kk = col.slots.shape[1]
        rr = np.full((nq, kk), -np.inf, dtype=np.float32)
        yes = np.zeros((nq, kk), dtype=np.float32)
        no = np.zeros((nq, kk), dtype=np.float32)
        if scored:
            arr = np.asarray(scored, dtype=np.float64)  # [M, 3]
            rr[pj.flat_qi, pj.flat_rank] = arr[:, 0]
            yes[pj.flat_qi, pj.flat_rank] = arr[:, 1]
            no[pj.flat_qi, pj.flat_rank] = arr[:, 2]
        vals = col.vals[:nq]
        valid = (col.slots[:nq] >= 0) & np.isfinite(vals)
        rejected = np.zeros(nq, dtype=bool)
        if pj.unseen is not None:
            judged_max = np.max(np.where(valid, rr, -np.inf), axis=1, initial=-np.inf)
            best_e = np.max(np.where(valid, col.emb[:nq], -np.inf), axis=1, initial=-np.inf)
            rejected |= (
                (pj.unseen[:nq] >= pj.unseen_mass)
                & (best_e <= pj.unseen_cos)
                & (judged_max <= pj.unseen_judge)
            )
            valid &= ~rejected[:, None]
        if pj.q_floor > 0.0:
            judged_max = np.max(np.where(valid, rr, -np.inf), axis=1, initial=-np.inf)
            rejected |= np.isfinite(judged_max) & (judged_max < pj.q_floor)
            valid &= ~rejected[:, None]
        if rejected.any():
            col.slots = np.array(col.slots)
            col.slots[:nq][rejected] = -1
        vmax = np.maximum(np.max(np.where(valid, vals, -np.inf), axis=1, initial=-np.inf), F32_EPSILON)
        score = (pj.init_w * vals / vmax[:, None]).astype(np.float32)
        return JudgedColumnar(
            col=col, score=score, rr=rr, yes=yes, no=no, thr=pj.thr, cos_floor=pj.cos_floor
        )

    def results_from_judged(self, jc: JudgedColumnar, qi: int) -> List[SearchResult]:
        """One query's judged results as objects, through the judge floor
        and the cosine floor (the joint gate)."""
        col = jc.col
        row_i = col.slots[qi].tolist()
        row_v = col.vals[qi].tolist()
        row_e = col.emb[qi].tolist()
        row_l = col.lex[qi].tolist()
        out: List[SearchResult] = []
        for rank, slot in enumerate(row_i):
            v = row_v[rank]
            if slot < 0 or v != v or v in (float("inf"), float("-inf")):
                continue
            rr_v = float(jc.rr[qi, rank])
            if jc.thr > 0.0 and rr_v < jc.thr:
                continue
            if jc.cos_floor > 0.0 and row_e[rank] < jc.cos_floor:
                continue
            res = self._result(slot, float(jc.score[qi, rank]), row_e[rank], row_l[rank], initial=v)
            res.reranker_score = rr_v
            res.yes_logprob = float(jc.yes[qi, rank])
            res.no_logprob = float(jc.no[qi, rank])
            out.append(res)
        return out

    def get_embedding_candidates(self, query: str, count: int) -> List[RerankerCandidate]:
        """The `count` nearest chunks by dense score alone, as reranker
        candidates (calibrate_reranker; rag_engine.rs:415-460): hybrid_topk
        (hybrid_topk_quantized on an int8 store, escalating a failed
        certificate; their sharded twins on a mesh) with no lexical hits at
        weights 1 / 0."""
        if len(self.store) == 0:
            return []
        q = _normalize_vec(self.embedding_service.get_query_embeddings([query])[0])
        k = min(count, len(self.store))
        kb = _bucket_k(k)
        width = lex_width_for(0)
        lex_slots = np.full((1, width), -1, dtype=np.int32)
        lex_vals = np.zeros((1, width), dtype=np.float32)
        q_t = torch.as_tensor(q[None, :], device=self.device)
        store = self.store
        if self._mesh is not None:
            fn = (sharded_search.sharded_hybrid_topk_quantized if store.quantized
                  else sharded_search.sharded_hybrid_topk)
            kw = {"mesh": self._mesh, "corpus_axis": self._corpus_axes}
        else:
            fn = hybrid_topk_quantized if store.quantized else hybrid_topk
            kw = {}
        res = fn(
            q_t,
            store.corpus(),
            *((store.scales(), store.l1()) if store.quantized else ()),
            store.valid_mask(),
            torch.as_tensor(lex_slots, device=self.device),
            torch.as_tensor(lex_vals, device=self.device),
            self._f32(1.0),
            self._f32(0.0),
            kb,
            **kw,
        )
        vals, emb, lex, idx = (x.cpu().numpy() for x in res[:4])
        if store.quantized and not bool(res[4][0]):
            vals, _, _, idx, _ = self._int8_escalate(
                q_t, lex_slots, lex_vals, ResolvedWeights(embedding=1.0, lexical=0.0, reranker=0.0, initial=1.0),
                kb, np.array([0]), (vals, emb, lex, idx), kb,
            )
        out = []
        for v, slot in zip(vals[0, :k].tolist(), idx[0, :k].tolist()):
            if slot < 0 or not np.isfinite(v):
                continue
            m = self.store.meta_for_slot(int(slot))
            out.append(RerankerCandidate(chunk_id=m.id, document=m.document_name, text=m.text,
                                         page_number=m.page_number, section=m.section,
                                         initial_score=float(v)))
        return out

    def warmup(self) -> None:
        """Compile every BM25 posting snapshot (native index), then run one
        search on each lane, MMR included, so no later query pays a
        first-touch cost (JAX rag_engine.py:2018-2045). Unlike the JAX
        engine's, a failure here raises."""
        if len(self.store) == 0:
            return
        t0 = time.monotonic()
        compiled = self.lexical_index.compile_all()
        self.search_with_diversity("warmup query", 5, 0.3)
        self.search("warmup query", 5)
        self.search_with_diversity_batch([f"warmup query {i}" for i in range(8)], 5, 0.3)
        for pending in (self.dispatch_search(["warmup query"], 5),
                        self.dispatch_search_mmr(["warmup query"], 5, 0.3)):
            if pending is not None:  # no MMR hot lane on an int8 store
                self.fetch_columnar(pending)
        logger.info("compiled %d BM25 posting snapshots; search lanes warmed up in %.2f s",
                    compiled, time.monotonic() - t0)

    # ----- stats / listing ---------------------------------------------------

    def list_documents(self) -> List[str]:
        return self.store.document_names()

    def get_stats(self) -> dict:
        """rag_engine.rs:862-881 (+ search_mode): "exact" on every store,
        the int8 one included (exact with respect to its dequantised rows,
        by the certificate and its escalation)."""
        return {
            "documents": len(self.list_documents()),
            "chunks": len(self.store),
            "status": "reindexing" if self._needs_reindex else "ready",
            "embedding_model": self.embedding_model(),
            "reranker_model": self.reranker.model_name if self.reranker else None,
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
        """Replace the resident index with the saved one of this model (the
        npz, else the reference's JSON or a model-matched legacy
        chunks.json, migrated to npz)."""
        try:
            res = persistence.load_index(self.data_dir, self.embedding_model())
        except OSError as e:  # the migration's npz write failed
            logger.warning("Could not load existing data: %s", e)
            return
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
                self.store = self._empty_store(self.store.dim)
                self.lexical_index.clear()
            slots = self.store.add_chunks(st.metas, st.embeddings)
            for m, slot in zip(st.metas, slots):
                self.lexical_index.add_chunk(m.id, m.text, slot)
        self.document_hashes = dict(st.document_hashes)
        self._needs_reindex = st.needs_reindex or res.needs_reindex
        self.validate_index_sync()
        logger.info("Loaded %d chunks from disk", len(self.store))
