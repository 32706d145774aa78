"""Server-level QPS over loopback HTTP (port of scripts/bench_server.py).

    python -m rust_local_rag_tpu_torch.bench_server [--n 1245184] [--seconds 15] [--device cuda]
        [--pipelined 128 512]

The engine is built as the JAX bench builds it: Zipf texts (8 content
terms from a 30k vocabulary and a unique id term) indexed in the native
BM25 index, random unit rows in the slab (bf16, the high-QPS serving
mode), the committed query encoder, and the committed judge for the rerank
lane. It is served by the port's own server (server/fastpath.HttpServer
over http_api.App, the serving path of `python -m rust_local_rag_tpu_torch`)
on a thread of this process. The load generator is a raw-socket
keep-alive client in a subprocess pinned to cores of its own (the server
keeps the others), closed loop, each connection one request at a time.

Lanes, in the order they run, each printed with its QPS and latency
percentiles:

  * the engine-pipelined ceiling: dispatch batch N+1 before fetching
    batch N, then serialize (no HTTP, no batcher) at 128 and 512 queries
    (--pipelined): engine_pipelined{N}_top{k}_qps;
  * hot (rerank off, diversity 0, top_k 100) over HTTP at each client
    count of the sweep; the best point is the headline;
  * the judged quality body (eval_harness/configs/baseline.yaml's judge
    gate, top_k 5, diversity 0): its engine-pipelined ceiling at the
    first --pipelined size, then over HTTP;
  * after every HTTP lane, so that those run as they ran before these
    lines existed: the object lane in process (search_batch, rerank off,
    no HTTP, no batcher) at each --pipelined size:
    engine_batch{N}_top{k}_qps; the MMR hot lane pipelined as above
    (dispatch_search_mmr at diversity 0.3, fetch_columnar,
    serialize_batch; top_k 5) at MMR_PIPELINED's 64 and 512 queries:
    engine_mmr_pipelined{N}_top5_qps; and the object lane with the judge
    (search_batch, top_k 5, reranker weight 0, threshold 0.06) at the
    first --pipelined size: engine_rerank_on_top5_qps.

The in-process lines are computed as scripts/bench_server.py computes
them: one warm call, then reps x queries over the wall time of the reps
(3 reps for the object lanes, 6 for the pipelined ones). Each one's
launches of the masked score + segment-max kernel and of the attention
kernel, its warm call included, are under "engine_launches".

Each HTTP lane also reports where a request's time goes on the server,
per request: parse (the protocol's data_received, which parses the
request and submits it to the batcher), wait (submit until the batcher
starts the batch), search (the batch's execution: encoder, BM25, first
stage, fetch, judge, serialization) and write (the response handed to the
socket on the event loop). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

import numpy as np

VOCAB = 30_000
QUERY_MIN_RANK = 64
MMR_DIVERSITY = 0.3
MMR_PIPELINED = (64, 512)  # scripts/bench_server.py's MMR batch sizes
# scripts/bench_server.py's rerank-on line: the judge gate of the shipped
# quality config, top_k 5
RERANK_ON_WEIGHTS = {"reranker": 0.0, "initial": 1.0}
RERANK_ON_THRESHOLD = 0.06
# eval_harness/configs/baseline.yaml's search_params, diversity 0: the judged lane
JUDGED_BODY = {"diversity_factor": 0.0, "use_reranker": True, "rejection_threshold": 0.0,
               "rejection_unseen_mass": 0.35, "rejection_unseen_cos": 0.6, "rejection_unseen_judge": 0.2,
               "weights": {"reranker": 0.0, "initial": 1.0}}


def zipf_texts(n: int, seed: int = 0) -> List[str]:
    """Chunk texts with Zipfian term frequencies: 8 content terms from a
    30k vocabulary (s = 1.1) and a unique id term."""
    rng = np.random.default_rng(seed)
    probs = np.arange(1, VOCAB + 1, dtype=np.float64) ** -1.1
    draws = rng.choice(VOCAB, size=(n, 8), p=probs / probs.sum())
    return ["chunk" + str(i) + " " + " ".join("term" + str(t) for t in row) for i, row in enumerate(draws)]


def zipf_queries(n: int, seed: int = 1) -> List[str]:
    """Queries of 3 Zipf-drawn content terms (ranks >= 64) and a unique probe."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(QUERY_MIN_RANK, VOCAB + 1)
    probs = ranks.astype(np.float64) ** -1.1
    draws = rng.choice(ranks, size=(n, 3), p=probs / probs.sum())
    return ["find passage " + " ".join("term" + str(t) for t in row) + " probe" + str(i) for i, row in enumerate(draws)]


def build_engine(n_chunks: int, data_dir: str, device, with_reranker: bool, corpus_dtype, log=print):
    """The engine over n_chunks Zipf texts (native BM25) and random unit
    rows, with the committed encoder (and judge)."""
    import torch

    from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta
    from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine
    from rust_local_rag_tpu_torch.models.embedding_service import build_default_service
    from rust_local_rag_tpu_torch.models.reranker import TransformerReranker
    from rust_local_rag_tpu_torch.models.reranker_service import RerankerService

    svc = build_default_service(device)
    reranker = RerankerService(TransformerReranker.from_assets(device=device)) if with_reranker else None
    eng = RagEngine(data_dir, svc, reranker, corpus_dtype=corpus_dtype, device=device)
    t0 = time.monotonic()
    texts = zipf_texts(n_chunks)
    rng = np.random.default_rng(0)
    total = 0
    while total < n_chunks:
        m = min(65536, n_chunks - total)
        emb = rng.standard_normal((m, svc.dim)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        metas = [ChunkMeta(id=f"c{total + i}", document_name=f"doc{(total + i) % 977}.pdf", text=texts[total + i],
                           chunk_index=total + i, page_number=1 + (total + i) % 40) for i in range(m)]
        eng.add_chunks(metas, emb)
        total += m
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    log(f"slab + BM25 indexed: {len(eng.store)} chunks, capacity {eng.store.capacity} "
        f"({time.monotonic() - t0:.0f} s)")
    return eng


# ----- raw-socket load generator (runs as a subprocess) ---------------------

CLIENT_SRC = r'''
import asyncio, json, sys, time
port, conns, dur, top_k, extra = int(sys.argv[1]), int(sys.argv[2]), float(sys.argv[3]), int(sys.argv[4]), json.loads(sys.argv[5])
import numpy as np
rng = np.random.default_rng(1)
ranks = np.arange(64, 30_001)
probs = ranks.astype(np.float64) ** -1.1
draws = rng.choice(ranks, size=(4096, 3), p=probs / probs.sum())
BODIES = []
for i, row in enumerate(draws):
    q = "find passage " + " ".join("term" + str(t) for t in row) + " probe" + str(i)
    b = json.dumps({"query": q, "top_k": top_k, **extra}).encode()
    BODIES.append(b"POST /search HTTP/1.1\r\nHost: l\r\nContent-Type: application/json\r\nContent-Length: "
                  + str(len(b)).encode() + b"\r\n\r\n" + b)

async def worker(wid, stop, out):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    n, bad, lats, i = 0, 0, [], wid
    while time.monotonic() < stop:
        t0 = time.perf_counter()
        w.write(BODIES[i % 4096]); i += conns
        await w.drain()
        hdr = await r.readuntil(b"\r\n\r\n")
        j = hdr.lower().find(b"content-length:")
        await r.readexactly(int(hdr[j + 15:hdr.find(b"\r", j)]))
        if hdr.startswith(b"HTTP/1.1 200"):
            n += 1
            lats.append((time.perf_counter() - t0) * 1e3)
        else:
            bad += 1
    w.close()
    out.append((n, bad, lats))

async def main():
    out = []
    stop = time.monotonic() + dur
    t0 = time.monotonic()
    await asyncio.gather(*[worker(t, stop, out) for t in range(conns)])
    el = time.monotonic() - t0
    lats = sorted(l for x in out for l in x[2])
    print(json.dumps({"n": sum(x[0] for x in out), "bad": sum(x[1] for x in out), "elapsed": el, "lats": lats}))

asyncio.run(main())
'''


def core_split():
    """(server cores, client cores): a quarter of the cores (at least one)
    for the load generator, the rest for the server."""
    cores = sorted(os.sched_getaffinity(0))
    n_client = max(1, len(cores) // 4) if len(cores) > 1 else 0
    return cores[: len(cores) - n_client] or cores, cores[len(cores) - n_client:] or cores


def run_client(port: int, conns: int, seconds: float, top_k: int, extra: dict, cores) -> dict:
    proc = subprocess.Popen([sys.executable, "-c", CLIENT_SRC, str(port), str(conns), str(seconds), str(top_k),
                             json.dumps(extra)], stdout=subprocess.PIPE, text=True,
                            preexec_fn=lambda: os.sched_setaffinity(0, cores))
    try:
        out, _ = proc.communicate(timeout=seconds + 300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"the load generator exited {proc.returncode}")
    return json.loads(out.strip().splitlines()[-1])


def pct(xs: list, p: float) -> Optional[float]:
    """Nearest rank at round(p * (N-1)), as utils/profiling.StepTimer."""
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(round(p * (len(xs) - 1)), len(xs) - 1)]


class ServerSpans:
    """Per-request server spans over one HTTP lane, recorded by wrapping
    the protocol's data_received, the batcher's submit and _execute, and
    the response's hand-off to the socket (see the module docstring)."""

    def __init__(self, batcher):
        from rust_local_rag_tpu_torch.server import fastpath

        self.parse_s = 0.0
        self.submitted = 0
        self.wait: list = []
        self.search: list = []
        self.write: list = []
        self._t_submit: dict = {}
        self._lock = threading.Lock()
        self._undo = []
        spans = self
        proto, fut = fastpath.HttpProtocol, fastpath._SlotFuture
        data_received, set_result = proto.data_received, fut.set_result
        submit, execute = batcher.submit, batcher._execute

        def timed_data_received(self, data):
            t0 = time.perf_counter()
            data_received(self, data)
            spans.parse_s += time.perf_counter() - t0

        def timed_set_result(self, res):
            t0 = time.perf_counter()
            set_result(self, res)
            spans.write.append(time.perf_counter() - t0)

        def timed_submit(*a, **kw):
            t = time.perf_counter()
            f = submit(*a, **kw)
            with spans._lock:
                spans.submitted += 1
                spans._t_submit[id(kw.get("afuture") or f)] = t
            return f

        def timed_execute(batch):
            t0 = time.perf_counter()
            with spans._lock:
                for it in batch:
                    t = spans._t_submit.pop(id(it.future), None)
                    if t is not None:
                        spans.wait.append(t0 - t)
            try:
                return execute(batch)
            finally:
                dt = time.perf_counter() - t0
                with spans._lock:
                    spans.search.extend([dt] * len(batch))

        proto.data_received, fut.set_result = timed_data_received, timed_set_result
        batcher.submit, batcher._execute = timed_submit, timed_execute
        self._undo = [lambda: setattr(proto, "data_received", data_received),
                      lambda: setattr(fut, "set_result", set_result),
                      lambda: delattr(batcher, "submit"), lambda: delattr(batcher, "_execute")]

    def close(self) -> dict:
        for undo in self._undo:
            undo()
        ms = lambda xs, p: None if not xs else pct(xs, p) * 1e3  # noqa: E731
        return {"requests_submitted": self.submitted,
                "parse_ms_per_request": self.parse_s / max(self.submitted, 1) * 1e3,
                **{f"{name}_{tag}_ms": ms(xs, p) for name, xs in (("wait", self.wait), ("search", self.search),
                                                                   ("write", self.write))
                   for tag, p in (("p50", 0.5), ("p99", 0.99))}}


def http_lane(port: int, conns: int, seconds: float, top_k: int, extra: dict, batcher, cores) -> dict:
    spans = ServerSpans(batcher)
    try:
        d = run_client(port, conns, seconds, top_k, extra, cores)
    finally:
        split = spans.close()
    lats = d["lats"]
    return {"clients": conns, "qps": d["n"] / d["elapsed"], "requests": d["n"], "non_200": d["bad"],
            "latency_p50_ms": pct(lats, 0.5), "latency_p99_ms": pct(lats, 0.99), "server_split": split}


def pipelined_qps(eng, queries: List[str], top_k: int, reps: int = 6, judged: bool = False,
                  mmr: bool = False) -> float:
    """Queries a second through the engine with batch i+1 dispatched before
    batch i is fetched (and, for the hot and MMR lanes, serialized)."""
    from rust_local_rag_tpu_torch.config import QueryWeights
    from rust_local_rag_tpu_torch.server.serializer import ResponseSerializer

    ser = ResponseSerializer(lambda: eng.store)
    qb = len(queries)
    if judged:
        # as the batcher's judged lane calls them (server/batcher._execute_judged)
        w = QueryWeights(**JUDGED_BODY["weights"])
        gate = {k: v for k, v in JUDGED_BODY.items() if k.startswith("rejection_")}

        def start():
            pend = eng.dispatch_search(queries, top_k, w, rejection_threshold=0.0, rejection_cosine_floor=0.0)
            return eng.judge_columnar(pend, queries, weights=w, rejection_cosine_floor=None,
                                      rejection_query_floor=None, **gate)

        finish = eng.fetch_judged
    else:
        def start():
            if mmr:
                return eng.dispatch_search_mmr(queries, top_k, MMR_DIVERSITY)
            return eng.dispatch_search(queries, top_k)

        def finish(pend):
            col = eng.fetch_columnar(pend)
            ser.serialize_batch(col.slots[:qb], col.vals[:qb], col.emb[:qb], col.lex[:qb], floor=col.floor)

    finish(start())  # warm
    t0 = time.perf_counter()
    pend = start()
    for _ in range(reps - 1):
        nxt = start()
        finish(pend)
        pend = nxt
    finish(pend)
    return reps * qb / (time.perf_counter() - t0)


def object_qps(eng, queries: List[str], top_k: int, reps: int = 3, rerank: bool = False) -> float:
    """Queries a second through the object lane (search_batch) after one
    warm call: rerank off, or the judge under RERANK_ON_WEIGHTS."""
    from rust_local_rag_tpu_torch.config import QueryWeights

    if rerank:
        def call():
            return eng.search_batch(queries, top_k, QueryWeights(**RERANK_ON_WEIGHTS), use_reranker=True,
                                    rejection_threshold=RERANK_ON_THRESHOLD)
    else:
        def call():
            return eng.search_batch(queries, top_k, use_reranker=False)
    call()  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    return reps * len(queries) / (time.perf_counter() - t0)


class LaunchCounts:
    """Launches of the masked score + segment-max kernel and of the
    attention kernel over each engine line (the wrappers' counters, read
    before and after, never reset)."""

    def __init__(self):
        from rust_local_rag_tpu_torch.ops.attention import fused_attention
        from rust_local_rag_tpu_torch.ops.score_segmax import score_segmax

        self._counters = {"score_segmax_masked": score_segmax, "fused_attention": fused_attention}
        self.lines: dict = {}

    @contextlib.contextmanager
    def line(self, key: str):
        before = {k: c.launches for k, c in self._counters.items()}
        try:
            yield
        finally:
            self.lines[key] = {k: c.launches - before[k] for k, c in self._counters.items()}


@contextlib.contextmanager
def _env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def measure_server_qps(n_chunks: int = 1_245_184, top_k: int = 100, clients=(64, 256), seconds: float = 15.0,
                       device: str = "cuda", with_rerank_lane: bool = True, max_batch: int = 512, window_ms: float = 5.0,
                       pipelined=(128, 512), quiet: bool = False) -> dict:
    import torch

    from rust_local_rag_tpu_torch.device import resolve_device
    from rust_local_rag_tpu_torch.jobs.job_manager import JobManager
    from rust_local_rag_tpu_torch.jobs.worker import WorkerSupervisor
    from rust_local_rag_tpu_torch.server.fastpath import HttpServer
    from rust_local_rag_tpu_torch.server.http_api import App, AppContext
    from rust_local_rag_tpu_torch.utils.rwlock import RwLock

    def log(msg: str) -> None:
        if not quiet:
            print(msg, file=sys.stderr, flush=True)

    dev = resolve_device(device)
    server_cores, client_cores = core_split()
    old_affinity = os.sched_getaffinity(0)
    os.sched_setaffinity(0, server_cores)  # this thread, and every thread it starts from here
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        eng = build_engine(n_chunks, tmp, dev, with_rerank_lane, torch.bfloat16, log)
        build_s = time.monotonic() - t0
        lock = RwLock()
        jm = JobManager(os.path.join(tmp, "jobs.db"))
        sup = WorkerSupervisor(jm, eng, lock, log_dir=tmp)
        sup.start()
        with _env(RAG_TPU_BATCH_MAX=max_batch, RAG_TPU_BATCH_WINDOW_MS=window_ms):
            ctx = AppContext(eng, lock, jm, sup, tmp)
        server = HttpServer(App(ctx), "127.0.0.1", 0)
        ready = threading.Event()
        thread = threading.Thread(target=server.run, kwargs={"ready": ready.set}, daemon=True)
        thread.start()
        try:
            if not ready.wait(60):
                raise RuntimeError("the server did not start")
            t0 = time.monotonic()
            eng.warmup()
            queries = zipf_queries(max(max_batch, *pipelined, *MMR_PIPELINED))
            b = 1
            while b <= max_batch:  # every batch the coalescer can form, both lanes
                eng.fetch_columnar(eng.dispatch_search(queries[:b], top_k))
                if with_rerank_lane:
                    pipelined_qps(eng, queries[:b], 5, reps=1, judged=True)
                b *= 2
            n_frag = ctx.batcher.preregister_fragments()
            n_terms = eng.lexical_index.compile_all()
            log(f"warmed ({time.monotonic() - t0:.0f} s): {n_frag} fragments, {n_terms} BM25 snapshots")
            out_s = np.full(512, -1, np.int32)
            out_v = np.zeros(512, np.float32)
            t1 = time.perf_counter()
            for q in zipf_queries(128, seed=7):
                eng.lexical_index.score_slots_into(q, 500, out_s, out_v)
            lex_us = (time.perf_counter() - t1) / 128 * 1e6
            result = {
                "n_chunks": len(eng.store), "slab_rows": eng.store.capacity, "corpus_dtype": "bf16",
                "top_k": top_k, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "server_cores": len(server_cores), "client_cores": len(client_cores), "build_s": build_s,
                "batch_max": max_batch, "batch_window_ms": window_ms, "lexical_content_us_per_query": lex_us,
            }
            counts = LaunchCounts()
            for qb in pipelined:
                key = f"engine_pipelined{qb}_top{top_k}_qps"
                with counts.line(key):
                    result[key] = pipelined_qps(eng, queries[:qb], top_k)
            sweep = {}
            for cl in clients:
                sweep[f"clients{cl}"] = http_lane(server.port, cl, seconds, top_k, {"diversity_factor": 0.0,
                                                  "use_reranker": False}, ctx.batcher, client_cores)
                log(f"hot lane, {cl} clients: {sweep[f'clients{cl}']['qps']:.1f} qps")
            best = max(sweep.values(), key=lambda r: r["qps"])
            result.update({"server_e2e_qps": best["qps"], "clients": best["clients"],
                           "latency_p50_ms": best["latency_p50_ms"], "latency_p99_ms": best["latency_p99_ms"],
                           "client_sweep": sweep})
            if with_rerank_lane:
                key = f"engine_judged_pipelined{pipelined[0]}_top5_qps"
                with counts.line(key):
                    result[key] = pipelined_qps(eng, queries[:pipelined[0]], 5, judged=True)
                judged = http_lane(server.port, max(clients), max(seconds / 2, 2.0), 5, JUDGED_BODY, ctx.batcher,
                                   client_cores)
                result["judged_http"] = judged
                result["server_e2e_judged_top5_qps"] = judged["qps"]
                log(f"judged lane: {judged['qps']:.1f} qps")
            # the lines that the HTTP lanes did not have before them run last
            for qb in pipelined:
                key = f"engine_batch{qb}_top{top_k}_qps"
                with counts.line(key):
                    result[key] = object_qps(eng, queries[:qb], top_k)
            for qb in MMR_PIPELINED:
                key = f"engine_mmr_pipelined{qb}_top5_qps"
                with counts.line(key):
                    result[key] = pipelined_qps(eng, queries[:qb], 5, mmr=True)
            if with_rerank_lane:
                key = "engine_rerank_on_top5_qps"
                with counts.line(key):
                    result[key] = object_qps(eng, queries[:pipelined[0]], 5, rerank=True)
            log(f"engine lines: {counts.lines}")
            result["engine_launches"] = counts.lines
            if ctx.batcher.judged_fallbacks or eng.rerank_fallbacks:
                raise RuntimeError(f"fallbacks: judged {ctx.batcher.judged_fallbacks}, rerank {eng.rerank_fallbacks}")
            return result
        finally:
            sup.stop(timeout=10)
            server.stop()
            thread.join(timeout=30)
            ctx.batcher.stop()
            eng.embedding_service.close()
            os.sched_setaffinity(0, old_affinity)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_245_184)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--clients", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--no-rerank-lane", action="store_true")
    ap.add_argument("--batch-max", type=int, default=512)
    ap.add_argument("--pipelined", type=int, nargs="+", default=[128, 512],
                    help="batch sizes of the object-lane and engine-pipelined lines (the judged and rerank-on "
                         "ones take the first)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(measure_server_qps(args.n, args.k, tuple(args.clients), args.seconds, args.device,
                                        not args.no_rerank_lane, args.batch_max,
                                        pipelined=tuple(args.pipelined))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
