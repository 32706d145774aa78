"""The system under test, built through its public API: the engine with
its committed encoder and the judge its configuration names, and the
server of `python -m rust_local_rag_tpu_torch` (AppContext,
WorkerSupervisor, the hand-written HTTP/1.1 server) on a thread of this
process, bound to a free loopback port. This is the one module of the
benchmark that imports the program.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


def apply_settings(env: dict) -> None:
    """The configuration's deployment settings, set before the program
    reads them."""
    for k, v in env.items():
        os.environ[k] = str(v)


# the program's settings that choose its judge (config.get_rerank_model,
# models/reranker.TransformerReranker.from_assets)
JUDGE_SETTINGS = ("RAG_TPU_RERANK_MODEL", "OLLAMA_RERANK_MODEL", "RERANKER_WEIGHTS")


def build_engine(cfg: dict, data_dir: str, device: torch.device):
    """An empty engine of the configuration, built as RagEngine.create
    builds it: the committed encoder, and the judge that the program's
    start-up path (build_default_reranker) builds when told to serve the
    configuration's judge: RAG_TPU_RERANK_MODEL its "model", and
    RERANKER_WEIGHTS its "weights" file (a path from the checkout's root)
    where it names one. A configuration that names a judge the program
    does not build is an error of the run."""
    from harness.runner import ROOT
    from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine
    from rust_local_rag_tpu_torch.models.embedding_service import build_default_service
    from rust_local_rag_tpu_torch.models.reranker_service import build_default_reranker

    for k in JUDGE_SETTINGS:
        os.environ.pop(k, None)
    named = cfg.get("judge")
    if named:
        os.environ["RAG_TPU_RERANK_MODEL"] = named["model"]
        if named.get("weights"):
            path = os.path.join(ROOT, named["weights"])
            if not os.path.isfile(path):
                raise FileNotFoundError(f"the configuration's judge weights {path} do not exist")
            os.environ["RERANKER_WEIGHTS"] = path
    svc = build_default_service(device)
    judge = build_default_reranker(device)
    if named and judge is None:
        raise RuntimeError(f"the configuration names the judge {named} and the program built none")
    return RagEngine(data_dir, svc, judge, device=device)


def embed_batch_size() -> int:
    """The rows EmbeddingService.embed_in_batches puts in one batch."""
    from rust_local_rag_tpu_torch.config import get_batch_size

    return get_batch_size()


def add_chunks(engine, ids: List[str], documents: List[str], texts: List[str], pages: List[int],
               rows: np.ndarray) -> None:
    """Chunks with their rows through RagEngine.add_chunks (slab and BM25)."""
    from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta

    metas = [ChunkMeta(id=i, document_name=d, text=t, chunk_index=0, page_number=p)
             for i, d, t, p in zip(ids, documents, texts, pages)]
    engine.add_chunks(metas, rows)


@dataclass
class Server:
    port: int
    ctx: object
    _server: object
    _thread: threading.Thread
    _supervisor: object

    def stop(self) -> None:
        self._supervisor.stop(timeout=10)
        self._server.stop()
        self._thread.join(timeout=30)
        self.ctx.batcher.stop()


def serve(engine, data_dir: str) -> Server:
    """The server over `engine` on 127.0.0.1, port 0."""
    from rust_local_rag_tpu_torch.jobs.job_manager import JobManager
    from rust_local_rag_tpu_torch.jobs.worker import WorkerSupervisor
    from rust_local_rag_tpu_torch.server.fastpath import HttpServer
    from rust_local_rag_tpu_torch.server.http_api import App, AppContext
    from rust_local_rag_tpu_torch.utils.rwlock import RwLock

    lock = RwLock()
    jobs = JobManager(os.path.join(data_dir, "jobs.db"))
    sup = WorkerSupervisor(jobs, engine, lock, log_dir=data_dir)
    sup.start()
    ctx = AppContext(engine, lock, jobs, sup, data_dir)
    server = HttpServer(App(ctx), "127.0.0.1", 0)
    ready = threading.Event()
    thread = threading.Thread(target=server.run, kwargs={"ready": ready.set}, daemon=True)
    thread.start()
    if not ready.wait(60):
        raise RuntimeError("the server did not start")
    return Server(server.port, ctx, server, thread, sup)


def counters(engine, server: Optional[Server]) -> dict:
    """The program's own counters: kernel launches and fallbacks."""
    from rust_local_rag_tpu_torch.ops.attention import fused_attention
    from rust_local_rag_tpu_torch.ops.score_segmax import score_segmax

    out = {"score_segmax_launches": score_segmax.launches, "attention_launches": fused_attention.launches,
           "rerank_fallbacks": engine.rerank_fallbacks}
    if server is not None:
        out["judged_fallbacks"] = server.ctx.batcher.judged_fallbacks
    return out


def slab_rows(engine, ids: List[str]) -> torch.Tensor:
    """The stored rows of chunks `ids`, widened to f32; NaN rows for ids
    the store does not hold."""
    store = engine.store
    held = [store.contains(i) for i in ids]
    slots = torch.as_tensor([store.slot_for_id(i) if h else 0 for i, h in zip(ids, held)],
                            device=store.corpus().device)
    rows = store.corpus()[slots].float()
    rows[torch.as_tensor(held, device=rows.device).logical_not()] = float("nan")
    return rows


def lexical_hits(engine, query: str, limit: int) -> List[tuple]:
    """[(chunk id, BM25 score)] of the engine's lexical index."""
    slots = np.full(limit, -1, np.int32)
    vals = np.zeros(limit, np.float32)
    n = engine.lexical_index.score_slots_into(query, limit, slots, vals)
    return [(engine.store.meta_for_slot(int(s)).id, float(v)) for s, v in zip(slots[:n], vals[:n])]


def run_lane(engine, body: dict, queries: List[str]) -> None:
    """One batch of `queries` through the engine calls of the batcher's lane
    for `body` (the hot lane, the MMR hot lane, or the object lane)."""
    from rust_local_rag_tpu_torch.server.http_api import parse_search_params

    p, err = parse_search_params({"query": "", **body})
    if err is not None:
        raise ValueError(err)
    if not p["use_reranker"] and p["diversity"] == 0.0:
        engine.fetch_columnar(engine.dispatch_search(queries, p["top_k"], p["weights"]))
    elif not p["use_reranker"]:
        engine.fetch_columnar(engine.dispatch_search_mmr(queries, p["top_k"], p["diversity"], p["weights"]))
    else:
        engine.search_with_diversity_batch(queries, p["top_k"], p["diversity"], p["weights"], use_reranker=True)


def plant_fault(engine, fault: str) -> None:
    """Break the timed path underneath (the harness's tests): "answer"
    reverses every answer where the engine produces it; "row" gives each
    chunk of an add_chunks call its neighbour's row (rows out of step with
    their chunks); "half" indexes half of each call's chunks (rounded up)."""
    if fault == "answer":
        search, fetch = engine.search_with_diversity_batch, engine.fetch_columnar

        def reversed_search(*a, **kw):
            return [list(reversed(r)) for r in search(*a, **kw)]

        def reversed_fetch(pending):
            col = fetch(pending)
            col.vals, col.emb, col.lex, col.slots = (x[:, ::-1].copy() for x in (col.vals, col.emb, col.lex,
                                                                                 col.slots))
            return col

        engine.search_with_diversity_batch, engine.fetch_columnar = reversed_search, reversed_fetch
    elif fault in ("row", "half"):
        add = engine.add_chunks

        def broken_add(metas, embeddings):
            if fault == "row":
                return add(metas, np.roll(embeddings, 1, axis=0))
            keep = (len(metas) + 1) // 2  # the program refuses an empty call
            return add(metas[:keep], embeddings[:keep])

        engine.add_chunks = broken_add
    else:
        raise ValueError(f"unknown fault {fault!r}")
