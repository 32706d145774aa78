"""Search micro-batcher (port of rust_local_rag_tpu/server/batcher.py,
hot lane): concurrent requests with identical parameters inside a small
window become ONE engine pass, and consecutive batches run on a small pool
so one batch's host work overlaps the previous batch's device work.

Only the rerank-off, diversity-0 hot lane exists in this port
(engine.dispatch_search + engine.fetch_columnar). A batch that needs
another lane resolves to NotImplementedError naming that lane.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

from rust_local_rag_tpu_torch.config import QueryWeights


def _weights_key(w: Optional[QueryWeights]) -> Tuple:
    if w is None:
        return (None, None, None, None)
    return (w.embedding, w.lexical, w.reranker, w.initial)


@dataclass
class _Item:
    key: Tuple
    query: str
    weights: Optional[QueryWeights]
    future: Future
    diversity: float
    use_reranker: bool
    rejection_threshold: Optional[float]
    rejection_cosine_floor: Optional[float]
    rejection_unseen_mass: Optional[float]
    rejection_unseen_cos: Optional[float]


class SearchBatcher:
    def __init__(
        self,
        engine,
        engine_lock,
        window_ms: Optional[float] = None,
        max_batch: Optional[int] = None,
        pipeline_depth: Optional[int] = None,
    ):
        """Defaults from RAG_TPU_BATCH_WINDOW_MS (3), RAG_TPU_BATCH_MAX (16)
        and RAG_TPU_PIPELINE_DEPTH (2), as in the JAX package."""
        self.engine = engine
        self.engine_lock = engine_lock
        if window_ms is None:
            window_ms = float(os.environ.get("RAG_TPU_BATCH_WINDOW_MS", "3"))
        self.window_s = max(window_ms, 0.0) / 1000.0
        if max_batch is None:
            max_batch = int(os.environ.get("RAG_TPU_BATCH_MAX", "16"))
        self.max_batch = max_batch
        if pipeline_depth is None:
            pipeline_depth = int(os.environ.get("RAG_TPU_PIPELINE_DEPTH", "2"))
        self.pipeline_depth = max(pipeline_depth, 1)
        self._buf: List[_Item] = []
        self._buf_cv = threading.Condition()
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._pool = ThreadPoolExecutor(
            max_workers=self.pipeline_depth, thread_name_prefix="search-exec"
        )
        self._stopping = threading.Event()
        self._thread = threading.Thread(target=self._run, name="search-batcher", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopping.set()
        with self._buf_cv:
            self._buf_cv.notify_all()
        self._thread.join(timeout=5)
        self._pool.shutdown(wait=True)
        with self._buf_cv:
            leftovers, self._buf = self._buf, []
        for it in leftovers:
            it.future.set_exception(RuntimeError("server shutting down"))

    def submit(
        self,
        query: str,
        top_k: int,
        diversity: float,
        weights: Optional[QueryWeights],
        rejection_threshold: Optional[float] = None,
        use_reranker: bool = True,
        rejection_cosine_floor: Optional[float] = None,
        rejection_unseen_mass: Optional[float] = None,
        rejection_unseen_cos: Optional[float] = None,
    ) -> Future:
        """Enqueue one search; the Future resolves to a List[SearchResult]."""
        diversity = round(float(diversity), 6)
        key = (
            top_k,
            diversity,
            _weights_key(weights),
            rejection_threshold,
            bool(use_reranker),
            rejection_cosine_floor,
            rejection_unseen_mass,
            rejection_unseen_cos,
        )
        item = _Item(
            key=key,
            query=query,
            weights=weights,
            future=Future(),
            diversity=diversity,
            use_reranker=bool(use_reranker),
            rejection_threshold=rejection_threshold,
            rejection_cosine_floor=rejection_cosine_floor,
            rejection_unseen_mass=rejection_unseen_mass,
            rejection_unseen_cos=rejection_unseen_cos,
        )
        with self._buf_cv:
            self._buf.append(item)
            self._buf_cv.notify()
        return item.future

    def search(self, query: str, top_k: int, diversity: float, weights: Optional[QueryWeights], **kw):
        """Blocking search."""
        return self.submit(query, top_k, diversity, weights, **kw).result()

    # ----- collector -----

    def _drain(self, timeout: Optional[float]) -> List[_Item]:
        """Everything queued, in one lock round trip; [] on timeout."""
        with self._buf_cv:
            if not self._buf:
                if self._stopping.is_set():
                    return []
                self._buf_cv.wait(timeout)
            out, self._buf = self._buf, []
            return out

    @staticmethod
    def _split(items: List[_Item], key: Tuple, room: int) -> Tuple[List[_Item], List[_Item]]:
        batch: List[_Item] = []
        rest: List[_Item] = []
        for it in items:
            if it.key == key and len(batch) < room:
                batch.append(it)
            else:
                rest.append(it)
        return batch, rest

    def _run(self) -> None:
        pending: List[_Item] = []
        while not self._stopping.is_set():
            if not pending:
                pending = self._drain(None)
                if not pending:
                    continue
            # collect same-key items inside the window; while every
            # pipeline slot is busy, keep collecting past it
            leader_key = pending[0].key
            batch, pending = self._split(pending, leader_key, self.max_batch)
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.max_batch and not self._stopping.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    with self._inflight_cv:
                        saturated = self._inflight >= self.pipeline_depth
                    if not saturated:
                        break
                    remaining = 0.002
                got = self._drain(max(remaining, 0.0005))
                if got:
                    more, rest = self._split(got, leader_key, self.max_batch - len(batch))
                    batch.extend(more)
                    pending.extend(rest)
            if batch:
                with self._inflight_cv:
                    self._inflight += 1
                self._pool.submit(self._run_one, batch)
        for it in pending:
            it.future.set_exception(RuntimeError("server shutting down"))

    # ----- execution -----

    def _run_one(self, batch: List[_Item]) -> None:
        try:
            self._execute(batch)
        except Exception as e:  # noqa: BLE001 - delivered to every caller
            for it in batch:
                if not it.future.done():
                    it.future.set_exception(e)
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    @staticmethod
    def _hot_lane(batch: List[_Item]) -> bool:
        return batch[0].diversity == 0.0 and not batch[0].use_reranker

    def _execute(self, batch: List[_Item]) -> None:
        if self._hot_lane(batch):
            self._execute_hot(batch, batch[0].key[0])
        elif batch[0].diversity != 0.0:
            raise NotImplementedError("MMR lane (diversity > 0) is not ported yet")
        else:
            raise NotImplementedError("reranker/judged lane (use_reranker=True) is not ported yet")

    def _execute_hot(self, batch: List[_Item], top_k: int) -> None:
        it0 = batch[0]
        with self.engine_lock.read():
            pending = self.engine.dispatch_search(
                [it.query for it in batch],
                top_k,
                it0.weights,
                rejection_threshold=it0.rejection_threshold,
                rejection_cosine_floor=it0.rejection_cosine_floor,
                rejection_unseen_mass=it0.rejection_unseen_mass,
                rejection_unseen_cos=it0.rejection_unseen_cos,
            )
            if pending is None:  # empty store
                results = [[] for _ in batch]
            else:
                col = self.engine.fetch_columnar(pending)
                results = [self.engine.results_from_columnar(col, qi) for qi in range(len(batch))]
        for it, res in zip(batch, results):
            it.future.set_result(res)
