"""Where a hot-lane batch's time goes at the 1.25M-chunk server shape
(port of scripts/exp_dispatch_profile.py): query tokenising and encoding,
BM25, the first stage on the card (the masked score + segment-max kernel,
csrc/score_segmax.cu), the blocking fetch, and the native serializer
(server/serializer.py over csrc/serializer.cpp). The engine is
server_profile's (bench_server.build_engine, an f32 slab).

Each stage is called once to warm it, then `reps` times, in ms a call,
with the script's labels. JAX's "no fetch" stages measured asynchronous
dispatch; in eager PyTorch the host returns once the work is queued, but
queueing can wait on the card (a pageable copy to the device waits for
the work queued before it). So each stage that leaves work on the card is
given twice: the host's time to return, and the time to
torch.cuda.synchronize, each under a label of its own ("... + sync");
without the second, a stage that follows would be charged the card's
work. The card is idle at the start of every stage. Last, the one-thread
pipelined loop of the hot lane: batch i+1 dispatched before batch i is
fetched and serialized.

    python -m rust_local_rag_tpu_torch.tools.dispatch_profile [QB] [--device cpu]

QB, the batch, defaults to 512.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import torch

from rust_local_rag_tpu_torch import bench_server
from rust_local_rag_tpu_torch.device import resolve_device
from rust_local_rag_tpu_torch.experiments.common import card
from rust_local_rag_tpu_torch.server.serializer import ResponseSerializer
from rust_local_rag_tpu_torch.tools.server_profile import N_CHUNKS, build

K = 100
LABEL_WIDTH = 28


def serialize_all(ser: ResponseSerializer, col, nq: int) -> list:
    """One body a query, as the script serializes them."""
    return [ser.serialize_query(col.slots[qi], col.vals[qi], col.emb[qi], col.lex[qi], floor=col.floor)
            for qi in range(nq)]


def stages(eng, qs: list, k: int, ser: ResponseSerializer, col) -> list:
    """(label, fn, synchronised) in the script's order; the "+ sync" rows
    wait for the card inside the timing. `col` is a fetched batch of qs,
    the one "serialize batch" serializes."""
    nq_pad = len(qs)
    return [
        ("prep_queries (tok+enc disp)", lambda: eng._prep_queries(qs, nq_pad), False),
        ("prep_queries + sync", lambda: eng._prep_queries(qs, nq_pad), True),
        ("prep_queries + block", lambda: eng._prep_queries(qs, nq_pad).cpu(), False),
        ("prep_lexical", lambda: eng._prep_lexical(qs, k, nq_pad), False),
        ("dispatch_search (no fetch)", lambda: eng.dispatch_search(qs, k), False),
        ("dispatch_search + sync", lambda: eng.dispatch_search(qs, k), True),
        ("dispatch+fetch", lambda: eng.fetch_columnar(eng.dispatch_search(qs, k)), False),
        ("serialize batch", lambda: serialize_all(ser, col, len(qs)), False),
    ]


def decompose(eng, qs: list, k: int = K, reps: int = 3, pipelined_reps: int = 8, log=print) -> dict:
    """Time every stage and the pipelined loop; -> {label: ms, ...}."""
    dev = eng.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    eng.fetch_columnar(eng.dispatch_search(qs, k))  # warm
    ser = ResponseSerializer(lambda: eng.store)
    ser.preregister_all()
    col = eng.fetch_columnar(eng.dispatch_search(qs, k))
    out = {}
    for label, fn, synced in stages(eng, qs, k, ser, col):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            if synced:
                sync()
        out[label] = (time.perf_counter() - t0) / reps * 1000
        sync()
        log(f"{label:<{LABEL_WIDTH}} {out[label]:8.1f} ms")

    pend = eng.dispatch_search(qs, k)
    t0 = time.perf_counter()
    for _ in range(pipelined_reps - 1):
        nxt = eng.dispatch_search(qs, k)
        serialize_all(ser, eng.fetch_columnar(pend), len(qs))
        pend = nxt
    eng.fetch_columnar(pend)
    dt = (time.perf_counter() - t0) / (pipelined_reps - 1) * 1000
    out["pipelined iter (1 thread)"], out["pipelined_qps"] = dt, len(qs) / dt * 1000
    log(f"{'pipelined iter (1 thread)':<{LABEL_WIDTH}} {dt:8.1f} ms -> {out['pipelined_qps']:.0f} qps")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("qb", type=int, nargs="?", default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    log = lambda m: print(m, flush=True)  # noqa: E731
    log(card(dev))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        eng = build(N_CHUNKS, tmp, dev, log)
        log(f"engine built ({time.monotonic() - t0:.0f}s)")
        try:
            t0 = time.monotonic()
            log(f"snapshots: {eng.lexical_index.compile_all()} ({time.monotonic() - t0:.0f}s)")
            return decompose(eng, bench_server.zipf_queries(args.qb), log=log)
        finally:
            eng.embedding_service.close()


if __name__ == "__main__":
    main()
