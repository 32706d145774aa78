"""The host's HTTP ceiling (port of scripts/exp_http_ceiling.py): a null
POST /search handler, no engine, answering the script's canned body of
100 results, on the port's own protocol (server/fastpath.HttpProtocol,
in place of the script's aiohttp), driven (a) by the port's load
generator (bench_server.run_client: a raw-socket asyncio client process,
each connection one request at a time, in place of the script's aiohttp
client) and (b) by the raw-socket keep-alive client, 8 requests
pipelined at a time, in 1 and 4 threads. It says how many requests a
second the host can serve before any engine work.

The server thread runs on the server's cores and the load on the
client's (bench_server.core_split), printed first. No card is used.

    python -m rust_local_rag_tpu_torch.tools.http_ceiling [--seconds 8] [--clients 64]
"""

from __future__ import annotations

import argparse
import json

from rust_local_rag_tpu_torch import bench_server
from rust_local_rag_tpu_torch.server.http_api import Response
from rust_local_rag_tpu_torch.tools import ceiling_common as cc

BODY = json.dumps({"results": [
    {"text": "synthetic chunk 123", "score": 0.9, "document": "doc1.pdf",
     "chunk_id": "c123", "chunk_index": 123, "page_number": 3,
     "section": None, "embedding_score": 0.8, "lexical_score": 0.1,
     "initial_score": 0.7}
] * 100}).encode()
SECONDS = 8.0
CLIENTS = 64
RAW_THREADS = (1, 4)


def search(request) -> Response:
    return Response(200, BODY, "application/json")


def run(seconds: float = SECONDS, clients: int = CLIENTS, log=print) -> dict:
    split = cc.cores_line()
    log(json.dumps(split))
    server, thread = cc.serve(cc.CannedApp(search), split["server_cores"])
    out = {**split, "port": server.port}
    try:
        d = bench_server.run_client(server.port, clients, seconds, 100,
                                    {"diversity_factor": 0.0, "use_reranker": False}, split["client_cores"])
        out["client"] = {"qps": d["n"] / d["elapsed"], "responses": d["n"], "errors": d["bad"], "clients": clients}
        log(f"load-generator null-handler: {json.dumps(out['client'])}")
        for nthreads in RAW_THREADS:
            r = out[f"raw{nthreads}"] = cc.raw_load(server.port, nthreads, seconds, split["client_cores"])
            log(f"raw-pipelined client x{nthreads}: qps={r['qps']:.0f} errors={r['errors']}")
    finally:
        cc.stop(server, thread)
    out["errors"] = out["client"]["errors"] + sum(out[f"raw{n}"]["errors"] for n in RAW_THREADS)
    out["children_left"] = len(cc.children())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=SECONDS)
    ap.add_argument("--clients", type=int, default=CLIENTS)
    args = ap.parse_args(argv)
    out = run(args.seconds, args.clients, log=lambda m: print(m, flush=True))
    print(json.dumps({"http_ceiling": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
