"""Embedding service: the engine-facing wrapper around an encoder model
(port of rust_local_rag_tpu/models/embedding_service.py, the parts the
search and ingest path use).

  * a 1000-entry LRU cache of query embeddings;
  * embed_in_batches: length-sorted batches of EMBEDDING_BATCH_SIZE with
    the original order restored, a cooldown between batches, a per-batch
    progress callback and a per-batch timeout;
  * get_query_embeddings_device: query embeddings left on the device for
    the search dispatch.
"""

from __future__ import annotations

import concurrent.futures
import logging
import time
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np

from rust_local_rag_tpu_torch.config import (
    get_batch_cooldown_ms,
    get_batch_size,
    get_batch_timeout_s,
)

logger = logging.getLogger(__name__)

QUERY_CACHE_SIZE = 1000


class EmbeddingService:
    def __init__(self, model, query_cache_size: int = QUERY_CACHE_SIZE):
        """`model` provides .encode(texts) -> [n, d] f32, .model_name and
        .dim, and optionally .encode_queries and .encode_queries_device."""
        self._model = model
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._cache_size = query_cache_size
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
        fut = self._executor.submit(fn)
        try:
            return fut.result(timeout=timeout_s)
        except concurrent.futures.TimeoutError:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None
            raise RuntimeError(
                f"Embedding batch timed out after {timeout_s:.0f}s"
            ) from None

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def _encode_queries(self, texts: Sequence[str]) -> np.ndarray:
        fn = getattr(self._model, "encode_queries", None)
        if fn is not None:
            return fn(list(texts))
        return self._model.encode(list(texts))

    def get_query_embeddings(self, texts: Sequence[str]) -> np.ndarray:
        """All cache misses are embedded in ONE model call; every result
        enters the LRU."""
        out: List[Optional[np.ndarray]] = []
        for t in texts:
            hit = self._cache.get(t)
            if hit is not None:
                self._cache.move_to_end(t)
            out.append(hit)
        missing = [i for i, e in enumerate(out) if e is None]
        if missing:
            embs = self._encode_queries([texts[i] for i in missing])
            for j, i in enumerate(missing):
                out[i] = embs[j]
                self._cache[texts[i]] = embs[j]
                self._cache.move_to_end(texts[i])
                while len(self._cache) > self._cache_size:
                    self._cache.popitem(last=False)
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
                lambda bt=batch_texts: self._model.encode(bt), timeout_s
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
