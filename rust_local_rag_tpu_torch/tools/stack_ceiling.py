"""The serving stack's ceiling (port of scripts/exp_stack_ceiling.py): the
full HTTP path of the port's server (server/fastpath.HttpProtocol, POST
/search inline, server/batcher.SearchBatcher with its futures, and the
native serializer, server/serializer.py over csrc/serializer.cpp) over a
fake engine whose device work is free. It isolates the host's serving
stack from the card:

  null  dispatch / fetch give canned top-100 rows at once: the protocol,
        the batcher's queue and futures, and the serializer;
  bm25  adds the native BM25 index (ops/native_bm25) over Zipf texts
        (bench_server.zipf_texts), scored for every query as the engine's
        _prep_lexical scores it: the host path without the card.

The fake engine has what the port's batcher and serializer touch on the
hot lane (supports_columnar, dispatch_search, fetch_columnar,
results_from_columnar, and a store with iter_meta, meta_for_slot and
mutations), not the JAX FakeEngine's attributes. The load is the port's
load generator (bench_server.run_client, a raw-socket asyncio client
process, in place of the script's aiohttp client) on the client's cores;
the server and the threads it starts run on the server's cores.

    python -m rust_local_rag_tpu_torch.tools.stack_ceiling [null|bm25] [clients] [duration_s] [chunks]

clients defaults to 128, duration_s to 10, chunks to 1,250,000 in bm25
mode (the script's) and 4,096 in null mode. The script's aiohttp switch
(STACK_FASTPATH) has no counterpart: the port has one protocol.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from rust_local_rag_tpu_torch import bench_server
from rust_local_rag_tpu_torch.engine.rag_engine import ColumnarResults
from rust_local_rag_tpu_torch.tools import ceiling_common as cc

K = 100
LEX_WIDTH = 500  # the script's BM25 hits a query (top_k 100 x 5)
STORE_CAP = 4096  # fragments the fake store registers


@dataclass
class FakeMeta:
    id: str
    document_name: str
    text: str
    chunk_index: int
    page_number: int
    section: Optional[str] = None


class FakeStore:
    """What the serializer reads of a ChunkStore."""

    def __init__(self, n: int, texts: List[str]):
        self._metas = [FakeMeta(id=f"c{i}", document_name=f"doc{i % 977}.pdf", text=texts[i], chunk_index=i,
                                page_number=1 + i % 40) for i in range(n)]
        self.mutations = 0

    def __len__(self):
        return len(self._metas)

    def iter_meta(self):
        return enumerate(self._metas)

    def meta_for_slot(self, slot: int):
        return self._metas[slot]


class FakePending:
    __slots__ = ("nq",)

    def __init__(self, nq: int):
        self.nq = nq


class FakeEngine:
    """The hot lane's engine with free device work: canned top-K rows on
    registered slots; in bm25 mode each query is scored by the native BM25
    index first."""

    def __init__(self, n_chunks: int, mode: str, texts: List[str], log=print):
        from rust_local_rag_tpu_torch.ops.native_bm25 import make_lexical_index

        self.store = FakeStore(min(n_chunks, STORE_CAP), texts)
        self.lexical_index = None
        if mode == "bm25":
            self.lexical_index = make_lexical_index()
            t0 = time.monotonic()
            self.lexical_index.add_chunks([f"c{i}" for i in range(len(texts))], texts, list(range(len(texts))))
            log(f"BM25 indexed {len(texts)} ({time.monotonic() - t0:.0f}s)")
            t0 = time.monotonic()
            log(f"{self.lexical_index.compile_all()} snapshots compiled ({time.monotonic() - t0:.0f}s)")
        self._slots = np.arange(K, dtype=np.int32)
        self._vals = np.linspace(0.9, 0.5, K).astype(np.float32)
        self._out_s = np.full(LEX_WIDTH, -1, np.int32)
        self._out_v = np.zeros(LEX_WIDTH, np.float32)

    def supports_columnar(self) -> bool:
        return True

    def dispatch_search(self, queries, top_k, weights=None, rejection_threshold=None, rejection_cosine_floor=None,
                        rejection_unseen_mass=None, rejection_unseen_cos=None):
        if self.lexical_index is not None:
            for q in queries:
                self.lexical_index.score_slots_into(q, LEX_WIDTH, self._out_s, self._out_v)
        return FakePending(len(queries))

    def fetch_columnar(self, pending) -> ColumnarResults:
        nq = pending.nq
        return ColumnarResults(vals=np.tile(self._vals, (nq, 1)), emb=np.tile(self._vals, (nq, 1)),
                               lex=np.zeros((nq, K), np.float32), slots=np.tile(self._slots, (nq, 1)), floor=0.0)

    def results_from_columnar(self, col, qi):
        raise RuntimeError("object lane unexpected in this experiment")

    def search_with_diversity_batch(self, *a, **k):
        raise RuntimeError("general lane unexpected in this experiment")


def run(mode: str = "null", clients: int = 128, duration: float = 10.0, n_chunks: Optional[int] = None,
        log=print) -> dict:
    from rust_local_rag_tpu_torch.jobs.job_manager import JobManager
    from rust_local_rag_tpu_torch.jobs.worker import WorkerSupervisor
    from rust_local_rag_tpu_torch.server.http_api import App, AppContext
    from rust_local_rag_tpu_torch.utils.rwlock import RwLock

    if mode not in ("null", "bm25"):
        raise ValueError(f"mode must be null or bm25, not {mode!r}")
    n_chunks = n_chunks or (1_250_000 if mode == "bm25" else STORE_CAP)
    split = cc.cores_line()
    log(json.dumps(split))
    env = {k: os.environ.get(k, v) for k, v in (("RAG_TPU_BATCH_MAX", max(clients, 128)),
                                                 ("RAG_TPU_BATCH_WINDOW_MS", 5))}
    old_affinity = os.sched_getaffinity(0)
    os.sched_setaffinity(0, split["server_cores"])  # this thread and the ones it starts
    try:
        eng = FakeEngine(n_chunks, mode, bench_server.zipf_texts(n_chunks), log)
        with tempfile.TemporaryDirectory() as tmp, bench_server._env(**env):
            lock = RwLock()
            jm = JobManager(os.path.join(tmp, "jobs.db"))
            sup = WorkerSupervisor(jm, eng, lock, log_dir=tmp)
            sup.start()
            ctx = AppContext(eng, lock, jm, sup, tmp)
            server = thread = None
            try:
                server, thread = cc.serve(App(ctx))
                log(f"{ctx.batcher.preregister_fragments()} fragments preregistered")
                d = bench_server.run_client(server.port, clients, duration, K,
                                            {"diversity_factor": 0.0, "use_reranker": False}, split["client_cores"])
            finally:
                if server is not None:
                    cc.stop(server, thread)
                ctx.batcher.stop()
                sup.stop(timeout=5.0)
    finally:
        os.sched_setaffinity(0, old_affinity)
    lats = d["lats"]
    out = {**split, "mode": mode, "clients": clients, "chunks": n_chunks, "qps": d["n"] / d["elapsed"],
           "responses": d["n"], "errors": d["bad"], "p50_ms": bench_server.pct(lats, 0.5),
           "p99_ms": bench_server.pct(lats, 0.99), "port": server.port, "children_left": len(cc.children())}
    log(f"stack ceiling [{mode}] clients={clients}: {out['qps']:.0f} qps (p50 {out['p50_ms'] or -1:.0f} ms, "
        f"n={d['n']}, errors {d['bad']})")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="null", choices=("null", "bm25"))
    ap.add_argument("clients", nargs="?", type=int, default=128)
    ap.add_argument("duration", nargs="?", type=float, default=10.0)
    ap.add_argument("chunks", nargs="?", type=int, default=None)
    args = ap.parse_args(argv)
    out = run(args.mode, args.clients, args.duration, args.chunks, log=lambda m: print(m, flush=True))
    print(json.dumps({"stack_ceiling": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
