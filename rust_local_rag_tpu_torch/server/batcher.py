"""Search micro-batcher (port of rust_local_rag_tpu/server/batcher.py):
concurrent requests with identical parameters inside a small window become
ONE engine pass, and consecutive batches run on a small pool so one
batch's host work overlaps the previous batch's device work.

Lanes, chosen per batch as in the JAX batcher:
  * hot lane (rerank off, diversity 0): engine.dispatch_search ->
    fetch_columnar -> results_from_columnar;
  * MMR hot lane (rerank off, diversity > 0): engine.dispatch_search_mmr
    (pool select, floor gate and greedy MMR in one call) -> fetch_columnar
    -> results_from_columnar; an empty store goes to the general lane;
  * judge-gated lane (rerank on at reranker weight 0, diversity 0):
    dispatch_search -> judge_columnar -> fetch_judged ->
    results_from_judged; any failure there falls back to the general lane
    and adds one to ``judged_fallbacks``;
  * general lane (everything else, MMR with the reranker included, and
    every request to a sharded engine, whose supports_columnar is False):
    engine.search_with_diversity_batch, the object lane.
A lane that declines falls to the general lane after releasing the read
lock: the lock prefers writers, so a nested read could wait forever
behind a queued writer.

Results resolve to SearchResult lists, or, for a request submitted with
want_payload (the HTTP /search route), to response-body bytes from the
native serializer (server/serializer.py) in the hot, MMR hot and judged
lanes: serialize_batch / serialize_batch_rr write the whole batch in one
call. The general lane answers objects either way. Event-loop callers pass
an asyncio future and its loop; each batch then wakes each loop once
(one call_soon_threadsafe a batch a loop, not one a request).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

from rust_local_rag_tpu_torch.config import QueryWeights

logger = logging.getLogger(__name__)


def _weights_key(w: Optional[QueryWeights]) -> Tuple:
    if w is None:
        return (None, None, None, None)
    return (w.embedding, w.lexical, w.reranker, w.initial)


def _deliver(pairs: List[Tuple[object, object]]) -> None:
    """On the event loop: resolve a batch's asyncio futures."""
    for fut, res in pairs:
        if not fut.done():
            fut.set_result(res)


def _deliver_exc(pairs: List[Tuple[object, BaseException]]) -> None:
    for fut, exc in pairs:
        if not fut.done():
            fut.set_exception(exc)


@dataclass
class _Item:
    key: Tuple
    query: str
    weights: Optional[QueryWeights]
    future: object  # concurrent Future, or an asyncio future of `loop`
    loop: Optional[object]
    want_payload: bool
    diversity: float
    use_reranker: bool
    rejection_threshold: Optional[float]
    rejection_cosine_floor: Optional[float]
    rejection_query_floor: Optional[float]
    rejection_unseen_mass: Optional[float]
    rejection_unseen_cos: Optional[float]
    rejection_unseen_judge: Optional[float]


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
        # judged-lane batches that fell back to the general lane
        self.judged_fallbacks = 0
        self._fallback_lock = threading.Lock()
        # one serializer for every pipeline thread (its registry is locked
        # in C++); built on first use or by preregister_fragments
        self._ser = None
        self._ser_lock = threading.Lock()
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
        self._complete_exc([(it, RuntimeError("server shutting down")) for it in leftovers])

    def submit(
        self,
        query: str,
        top_k: int,
        diversity: float,
        weights: Optional[QueryWeights],
        rejection_threshold: Optional[float] = None,
        use_reranker: bool = True,
        rejection_cosine_floor: Optional[float] = None,
        rejection_query_floor: Optional[float] = None,
        rejection_unseen_mass: Optional[float] = None,
        rejection_unseen_cos: Optional[float] = None,
        rejection_unseen_judge: Optional[float] = None,
        want_payload: bool = False,
        afuture: Optional[object] = None,
        loop: Optional[object] = None,
    ) -> object:
        """Enqueue one search; it resolves to a List[SearchResult], or to
        response-body bytes when want_payload and the batch takes the hot,
        MMR hot or judged lane. Returns a new concurrent Future, or, for an
        event-loop caller, `afuture` (an asyncio future of `loop`), which
        the batcher resolves with one call_soon_threadsafe per batch."""
        diversity = round(float(diversity), 6)
        key = (
            top_k,
            diversity,
            _weights_key(weights),
            rejection_threshold,
            bool(use_reranker),
            rejection_cosine_floor,
            rejection_query_floor,
            rejection_unseen_mass,
            rejection_unseen_cos,
            rejection_unseen_judge,
        )
        item = _Item(
            key=key,
            query=query,
            weights=weights,
            future=afuture if afuture is not None else Future(),
            loop=loop if afuture is not None else None,
            want_payload=want_payload,
            diversity=diversity,
            use_reranker=bool(use_reranker),
            rejection_threshold=rejection_threshold,
            rejection_cosine_floor=rejection_cosine_floor,
            rejection_query_floor=rejection_query_floor,
            rejection_unseen_mass=rejection_unseen_mass,
            rejection_unseen_cos=rejection_unseen_cos,
            rejection_unseen_judge=rejection_unseen_judge,
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
        self._complete_exc([(it, RuntimeError("server shutting down")) for it in pending])

    # ----- completion -----

    @staticmethod
    def _complete(done: List[Tuple[_Item, object]]) -> None:
        """Resolve a batch: concurrent futures directly, asyncio futures
        with one call_soon_threadsafe per loop."""
        by_loop: dict = {}
        for it, res in done:
            if it.loop is None:
                if not it.future.done():
                    it.future.set_result(res)
            else:
                by_loop.setdefault(it.loop, []).append((it.future, res))
        for loop, pairs in by_loop.items():
            try:
                loop.call_soon_threadsafe(_deliver, pairs)
            except RuntimeError:
                pass  # the loop is closed (shutdown): nobody waits

    @staticmethod
    def _complete_exc(failed: List[Tuple[_Item, BaseException]]) -> None:
        by_loop: dict = {}
        for it, exc in failed:
            if it.loop is None:
                if not it.future.done():
                    it.future.set_exception(exc)
            else:
                by_loop.setdefault(it.loop, []).append((it.future, exc))
        for loop, pairs in by_loop.items():
            try:
                loop.call_soon_threadsafe(_deliver_exc, pairs)
            except RuntimeError:
                pass

    # ----- the native serializer -----

    def _serializer(self):
        """The batcher's ResponseSerializer, built on first use; raises when
        its library does not build or load."""
        if self._ser is None:
            with self._ser_lock:
                if self._ser is None:
                    from rust_local_rag_tpu_torch.server.serializer import ResponseSerializer

                    self._ser = ResponseSerializer(lambda: self.engine.store)
        return self._ser

    def preregister_fragments(self) -> int:
        """Register every live chunk's response fragment (after the index is
        loaded), so serving builds none. Returns the count."""
        return self._serializer().preregister_all()

    def _payloads(self, batch: List[_Item], serialize) -> Optional[list]:
        """serialize() -> one body per query when a request asked for bytes."""
        return serialize() if any(it.want_payload for it in batch) else None

    def _answer(self, batch: List[_Item], payloads: Optional[list], result) -> None:
        """Complete the batch: bytes where asked for and serialized, else
        result(qi) objects."""
        self._complete([
            (it, payloads[qi] if it.want_payload and payloads is not None else result(qi))
            for qi, it in enumerate(batch)
        ])

    # ----- execution -----

    def _run_one(self, batch: List[_Item]) -> None:
        try:
            self._execute(batch)
        except Exception as e:  # noqa: BLE001 - delivered to every caller
            self._complete_exc([(it, e) for it in batch])
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def _hot_lane(self, batch: List[_Item]) -> bool:
        """Rerank off, diversity 0, on an engine that serves the columnar
        lanes (not a sharded one)."""
        return batch[0].diversity == 0.0 and not batch[0].use_reranker and self.engine.supports_columnar()

    def _mmr_hot_lane(self, batch: List[_Item]) -> bool:
        """Diversity search with the reranker off (supports_columnar_mmr
        declines for a sharded engine and an int8 store)."""
        return batch[0].diversity > 0.0 and not batch[0].use_reranker and self.engine.supports_columnar_mmr()

    def _judge_lane(self, batch: List[_Item]) -> bool:
        """Reranking on at blend weight 0 (the shipped quality
        configuration: the judge as a rejection gate over the initial
        order), diversity 0."""
        it = batch[0]
        return (
            it.diversity == 0.0
            and it.use_reranker
            and self.engine.supports_judged_columnar(it.weights, it.use_reranker)
        )

    def _execute(self, batch: List[_Item]) -> None:
        top_k = batch[0].key[0]
        if self._hot_lane(batch):
            self._execute_hot(batch, top_k)
        elif self._mmr_hot_lane(batch):
            self._execute_mmr_hot(batch, top_k)
        elif self._judge_lane(batch):
            self._execute_judged(batch, top_k)
        else:
            self._execute_general(batch, top_k)

    def _execute_hot(self, batch: List[_Item], top_k: int) -> None:
        it0 = batch[0]
        nq = len(batch)
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
                self._complete([(it, []) for it in batch])
                return
            col = self.engine.fetch_columnar(pending)
            payloads = self._payloads(batch, lambda: self._serializer().serialize_batch(
                col.slots[:nq], col.vals[:nq], col.emb[:nq], col.lex[:nq], floor=col.floor))
            self._answer(batch, payloads, lambda qi: self.engine.results_from_columnar(col, qi))

    def _execute_mmr_hot(self, batch: List[_Item], top_k: int) -> None:
        """One MMR dispatch and one packed fetch; the planes come back in
        MMR order, so the rest is the hot lane's."""
        it0 = batch[0]
        nq = len(batch)
        with self.engine_lock.read():
            pending = self.engine.dispatch_search_mmr(
                [it.query for it in batch],
                top_k,
                it0.diversity,
                it0.weights,
                rejection_threshold=it0.rejection_threshold,
                rejection_cosine_floor=it0.rejection_cosine_floor,
                rejection_unseen_mass=it0.rejection_unseen_mass,
                rejection_unseen_cos=it0.rejection_unseen_cos,
            )
            if pending is not None:
                col = self.engine.fetch_columnar(pending)
                payloads = self._payloads(batch, lambda: self._serializer().serialize_batch(
                    col.slots[:nq], col.vals[:nq], col.emb[:nq], col.lex[:nq], floor=col.floor))
                self._answer(batch, payloads, lambda qi: self.engine.results_from_columnar(col, qi))
                return
        # the lane declined: after the read lock is released
        self._execute_general(batch, top_k)

    def _execute_judged(self, batch: List[_Item], top_k: int) -> None:
        """First-stage dispatch -> columnar fetch -> one batched judge
        dispatch -> logprob fetch -> gate. Any failure falls back to the
        general lane, which carries the reference's judge-failure
        semantics (rag_engine.rs:586-597), and is counted."""
        queries = [it.query for it in batch]
        it0 = batch[0]
        nq = len(batch)
        with self.engine_lock.read():
            try:
                pending = self.engine.dispatch_search(
                    queries, top_k, it0.weights,
                    rejection_threshold=0.0, rejection_cosine_floor=0.0,
                )
                jc = None
                if pending is not None:
                    # the unseen gate rides judge_columnar: the 2-way rule
                    # before the judge, or the 3-way rule in fetch_judged
                    jc = self.engine.fetch_judged(self.engine.judge_columnar(
                        pending,
                        queries,
                        weights=it0.weights,
                        rejection_threshold=it0.rejection_threshold,
                        rejection_cosine_floor=it0.rejection_cosine_floor,
                        rejection_query_floor=it0.rejection_query_floor,
                        rejection_unseen_mass=it0.rejection_unseen_mass,
                        rejection_unseen_cos=it0.rejection_unseen_cos,
                        rejection_unseen_judge=it0.rejection_unseen_judge,
                    ))
            except Exception:  # noqa: BLE001 - the judged lane degrades to the object lane
                logger.warning("judged lane failed; falling back to the object lane", exc_info=True)
                with self._fallback_lock:
                    self.judged_fallbacks += 1
                jc = None
            if jc is not None:
                col = jc.col
                payloads = self._payloads(batch, lambda: self._serializer().serialize_batch_rr(
                    col.slots[:nq], jc.score[:nq], col.emb[:nq], col.lex[:nq], col.vals[:nq],
                    jc.rr[:nq], jc.yes[:nq], jc.no[:nq], emb_floor=jc.cos_floor, rr_floor=jc.thr))
                self._answer(batch, payloads, lambda qi: self.engine.results_from_judged(jc, qi))
                return
        # empty store, or the judged lane failed: after the read lock is
        # released (the lock prefers writers, so a nested read could wait
        # forever behind a queued writer)
        self._execute_general(batch, top_k)

    def _execute_general(self, batch: List[_Item], top_k: int) -> None:
        it0 = batch[0]
        with self.engine_lock.read():
            results = self.engine.search_with_diversity_batch(
                [it.query for it in batch],
                top_k,
                it0.diversity,
                it0.weights,
                rejection_threshold=it0.rejection_threshold,
                use_reranker=it0.use_reranker,
                rejection_cosine_floor=it0.rejection_cosine_floor,
                rejection_query_floor=it0.rejection_query_floor,
                rejection_unseen_mass=it0.rejection_unseen_mass,
                rejection_unseen_cos=it0.rejection_unseen_cos,
                rejection_unseen_judge=it0.rejection_unseen_judge,
            )
        # objects even under want_payload; the HTTP layer dumps them
        self._complete(list(zip(batch, results)))
