"""Where engine.search_batch's time goes at the 1.25M-chunk server shape
(port of scripts/exp_server_profile.py): query encoding, BM25, the first
stage on the card (the masked score + segment-max kernel,
csrc/score_segmax.cu), and building the result objects on the host.

The engine is bench_server.build_engine's (Zipf texts in the native BM25
index, seeded unit rows in an f32 slab as the script's engine had, the
committed query encoder, no reranker). After a warm-up call, one
search_batch of 128 queries at top_k 100 with the reranker off is timed,
then one more runs under cProfile (the top 22 functions by cumulative
time, as the script prints them).

    python -m rust_local_rag_tpu_torch.tools.server_profile [--device cpu]
"""

from __future__ import annotations

import cProfile
import io
import pstats
import tempfile
import time

import torch

from rust_local_rag_tpu_torch import bench_server
from rust_local_rag_tpu_torch.experiments.common import card, parse_device

N_CHUNKS = 1_250_000
TOP_K = 100
QUERIES = 128


def queries(n: int = QUERIES) -> list:
    return [f"client {i} probe {i} synthetic retrieval" for i in range(n)]


def build(n_chunks: int, data_dir: str, dev: torch.device, log=print):
    """The script's engine: bench_server.build_engine with an f32 slab
    (RAG_TPU_CORPUS_DTYPE overrides it, as in the JAX engine)."""
    return bench_server.build_engine(n_chunks, data_dir, dev, False, torch.float32, log)


def profile(eng, qs: list, top_k: int = TOP_K, log=print) -> dict:
    """Warm, time one search_batch, then profile one. -> its numbers."""
    def call():
        res = eng.search_batch(qs, top_k, use_reranker=False)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        return res

    call()
    log("warmed")
    t0 = time.perf_counter()
    res = call()
    dt = time.perf_counter() - t0
    log(f"search_batch({len(qs)}, k={top_k}): {dt:.3f}s")
    pr = cProfile.Profile()
    pr.enable()
    call()
    pr.disable()
    s = io.StringIO()
    stats = pstats.Stats(pr, stream=s)
    stats.sort_stats("cumulative").print_stats(22)
    log(s.getvalue()[:4000])
    return {"search_batch_s": dt, "profiled_s": stats.total_tt, "answers": len(res),
            "results_per_query": [len(r) for r in res]}


def main(argv=None) -> dict:
    dev = parse_device(argv, __doc__.split("\n\n")[0])
    log = lambda m: print(m, flush=True)  # noqa: E731
    log(card(dev))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        eng = build(N_CHUNKS, tmp, dev, log)
        log(f"engine built ({time.monotonic() - t0:.0f}s)")
        try:
            return profile(eng, queries(), log=log)
        finally:
            eng.embedding_service.close()


if __name__ == "__main__":
    main()
