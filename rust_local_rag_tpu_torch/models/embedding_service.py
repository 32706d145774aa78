"""Embedding service: the engine-facing wrapper around an encoder model
(port of rust_local_rag_tpu/models/embedding_service.py, the parts the
search and ingest path use).

  * a 1000-entry LRU cache of query embeddings (utils/lru.LruCache, locked,
    so the batcher's concurrent batches can share it);
  * get_embedding, get_query_embedding (through the query cache) and
    embed_texts: one batch, encoded again one text at a time when the
    batch raises or returns the wrong row count (embeddings.rs:169-176);
  * embed_in_batches: length-sorted batches of EMBEDDING_BATCH_SIZE, each
    through embed_texts, with the original order restored, a cooldown
    between batches, a per-batch progress callback and a per-batch
    timeout;
  * get_query_embeddings_device: query embeddings left on the device for
    the search dispatch;
  * build_default_service: the committed encoder, or the hash encoder when
    RAG_TPU_FAKE_ENCODER is set (hermetic mode).
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from rust_local_rag_tpu_torch.config import (
    get_batch_cooldown_ms,
    get_batch_size,
    get_batch_timeout_s,
    get_embedding_model,
)
from rust_local_rag_tpu_torch.utils import profiling
from rust_local_rag_tpu_torch.utils.lru import LruCache

logger = logging.getLogger(__name__)

QUERY_CACHE_SIZE = 1000


class EmbeddingService:
    def __init__(self, model, query_cache_size: int = QUERY_CACHE_SIZE):
        """`model` provides .encode(texts) -> [n, d] f32, .model_name and
        .dim, and optionally .encode_queries and .encode_queries_device."""
        self._model = model
        self._cache: LruCache[str, np.ndarray] = LruCache(query_cache_size)
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None

    @property
    def model_name(self) -> str:
        return self._model.model_name

    @property
    def dim(self) -> int:
        return int(self._model.dim)

    def verify(self) -> None:
        """Fail fast at start-up when the encoder gives the wrong shape."""
        probe = self._model.encode(["startup verification probe"])
        if probe.shape != (1, self.dim):
            raise RuntimeError(
                f"Encoder verification failed: got shape {probe.shape}, "
                f"expected (1, {self.dim})"
            )

    def _encode_with_timeout(self, fn, timeout_s: float):
        """Run one embed call under a hard timeout; on timeout the worker
        thread is abandoned and a fresh executor serves later batches."""
        if timeout_s <= 0:
            return fn()
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="embed-batch"
            )
        tracer = profiling.TRACER
        parent = tracer.current()
        marks: List[int] = []

        def traced():
            # the worker's spans are the caller's children; the hand-off
            # (submit -> the worker starts, the worker ends -> the caller
            # resumes) is the caller's wait less the worker's run
            marks.append(tracer.clock())
            try:
                with tracer.adopt(parent):
                    return fn()
            finally:
                marks.append(tracer.clock())

        if parent is not None:
            t0 = tracer.clock()
        fut = self._executor.submit(fn if parent is None else traced)
        try:
            out = fut.result(timeout=timeout_s)
        except concurrent.futures.TimeoutError:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None
            raise RuntimeError(
                f"Embedding batch timed out after {timeout_s:.0f}s"
            ) from None
        if parent is not None:
            tracer.interval("embed.handoff", t0, tracer.clock() - (marks[1] - marks[0]))
        return out

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def get_embedding(self, text: str) -> np.ndarray:
        return self._model.encode([text])[0]

    def _encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        fn = getattr(self._model, "encode_queries", None)
        if fn is not None:
            return fn(list(texts))
        return self._model.encode(list(texts))

    def get_query_embedding(self, text: str) -> np.ndarray:
        cached = self._cache.get(text)
        if cached is not None:
            return cached
        emb = self._encode_queries([text])[0]
        self._cache.put(text, emb)
        return emb

    def get_query_embeddings(self, texts: Sequence[str]) -> np.ndarray:
        """All cache misses are embedded in ONE model call; every result
        enters the LRU."""
        out: List[Optional[np.ndarray]] = [self._cache.get(t) for t in texts]
        missing = [i for i, e in enumerate(out) if e is None]
        if missing:
            embs = self._encode_queries([texts[i] for i in missing])
            for j, i in enumerate(missing):
                out[i] = embs[j]
                self._cache.put(texts[i], embs[j])
        if not out:
            return np.zeros((0, self.dim), dtype=np.float32)
        return np.stack(out)  # type: ignore[arg-type]

    def get_query_embeddings_device(self, texts: Sequence[str]):
        """[bucket(n), dim] unit-normalised tensor on the device, or None
        when the model cannot encode there. Bypasses the LRU cache."""
        fn = getattr(self._model, "encode_queries_device", None)
        if fn is None:
            return None
        return fn(list(texts))

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """[n] texts -> [n, dim] f32 in one model call; when it raises or
        returns another row count than n, each text is encoded on its own
        (a text that still fails raises)."""
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        if len(texts) == 1:
            return self._model.encode([texts[0]])
        try:
            out = self._model.encode(list(texts))
            if out.shape[0] == len(texts):
                return out
            logger.warning(
                "Batch embedding returned %d embeddings for %d texts, falling back to sequential",
                out.shape[0], len(texts),
            )
        except Exception as e:  # noqa: BLE001 - retried one text at a time below
            logger.warning("Batch embedding failed (%s), falling back to sequential", e)
        return np.stack([self.get_embedding(t) for t in texts])

    def embed_in_batches(
        self,
        texts: Sequence[str],
        batch_callback=None,
        batch_size: Optional[int] = None,
        cooldown_ms: Optional[int] = None,
    ) -> np.ndarray:
        """[n] texts -> [n, dim] f32. Batches group similar lengths (a batch
        pads to its longest member's bucket); the callback gets
        (batch_idx1, total_batches, total_chunks, chunks_in_batch)."""
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        with profiling.span("embed.batches", len(texts)):
            bs = batch_size if batch_size is not None else get_batch_size()
            cooldown = cooldown_ms if cooldown_ms is not None else get_batch_cooldown_ms()
            timeout_s = get_batch_timeout_s()
            total = len(texts)
            total_batches = -(-total // bs)
            order = sorted(range(total), key=lambda i: len(texts[i]))

            out = np.zeros((total, self.dim), dtype=np.float32)
            for bi in range(total_batches):
                lo, hi = bi * bs, min((bi + 1) * bs, total)
                idxs = order[lo:hi]
                batch_texts = [texts[i] for i in idxs]
                batch = self._encode_with_timeout(
                    lambda bt=batch_texts: self.embed_texts(bt), timeout_s
                )
                if batch.shape[0] != hi - lo:
                    raise RuntimeError(
                        f"Batch {bi + 1}/{total_batches}: received "
                        f"{batch.shape[0]} embeddings for {hi - lo} chunks"
                    )
                out[np.asarray(idxs, dtype=np.int64)] = batch
                if batch_callback is not None:
                    batch_callback(bi + 1, total_batches, total, hi - lo)
                if bi + 1 < total_batches and cooldown > 0:
                    time.sleep(cooldown / 1000.0)
            return out


def build_default_service(device="cuda", model_name: Optional[str] = None) -> EmbeddingService:
    """The configured encoder under `model_name` (default
    get_embedding_model()): the transformer at ENCODER_WEIGHTS or the
    committed one (TransformerEncoderModel.from_assets) on `device`, or the
    hash encoder at RAG_TPU_FAKE_ENCODER_DIM (768) when RAG_TPU_FAKE_ENCODER
    is set, as the JAX package's build_default_service."""
    name = model_name or get_embedding_model()
    if os.environ.get("RAG_TPU_FAKE_ENCODER"):
        from rust_local_rag_tpu_torch.models.fake_encoder import HashEncoder

        dim = int(os.environ.get("RAG_TPU_FAKE_ENCODER_DIM", "768"))
        return EmbeddingService(HashEncoder(dim=dim, model_name=name))
    from rust_local_rag_tpu_torch.models.encoder import TransformerEncoderModel

    return EmbeddingService(TransformerEncoderModel.from_assets(model_name=name, device=device))
