"""The protocol's own ceiling (port of scripts/exp_proto_ceiling.py): a
POST /search handler that parses the request's JSON, as the real route
does, and answers the script's canned 100-result payload (json_response
of results[:top_k]), served by the port's protocol
(server/fastpath.HttpProtocol, in place of aiohttp) to 128 asyncio
clients over loopback for 8 s, each a keep-alive connection with one
request at a time. Server and clients share one event loop, on one
thread, as in the script. First it prints the payload's size and the
cost of json.dumps of it. No engine, no card.

    python -m rust_local_rag_tpu_torch.tools.proto_ceiling [--seconds 8] [--clients 128]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import time

from rust_local_rag_tpu_torch.server.fastpath import HttpProtocol
from rust_local_rag_tpu_torch.server.http_api import json_response
from rust_local_rag_tpu_torch.tools import ceiling_common as cc

results = [
    {"text": "synthetic chunk text " * 10, "score": 0.5, "document": f"doc{i}.pdf",
     "chunk_id": f"c{i}", "chunk_index": i, "page_number": 1 + i % 40,
     "section": None, "embedding_score": 0.3, "lexical_score": 0.1,
     "initial_score": 0.25}
    for i in range(100)
]
payload = {"results": results}
SECONDS = 8.0
CLIENTS = 128
REQUEST_BODY = json.dumps({"query": "q", "top_k": 100}).encode()
REQUEST = (b"POST /search HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
           b"Content-Length: " + str(len(REQUEST_BODY)).encode() + b"\r\n\r\n" + REQUEST_BODY)


def search(request):
    body = json.loads(request.body)  # parse like the real route
    k = int(body.get("top_k", 100))
    return json_response({"results": results[:k]})


async def load(port: int, clients: int, seconds: float) -> dict:
    n = bad = 0
    stop_at = time.perf_counter() + seconds

    async def worker():
        nonlocal n, bad
        r, w = await asyncio.open_connection("127.0.0.1", port)
        try:
            while time.perf_counter() < stop_at:
                w.write(REQUEST)
                await w.drain()
                hdr = await r.readuntil(b"\r\n\r\n")
                j = hdr.lower().find(b"content-length:")
                await r.readexactly(int(hdr[j + 15:hdr.find(b"\r", j)]))
                n += 1
                bad += not hdr.startswith(b"HTTP/1.1 200")
        finally:
            w.close()
            await w.wait_closed()

    done = await asyncio.gather(*[worker() for _ in range(clients)], return_exceptions=True)
    failed = sum(isinstance(x, BaseException) for x in done)
    return {"qps": n / seconds, "responses": n, "errors": bad + failed}


async def serve_and_load(clients: int, seconds: float) -> dict:
    loop = asyncio.get_running_loop()
    app = cc.CannedApp(search)
    conns: set = set()
    srv = await loop.create_server(lambda: HttpProtocol(app, loop, conns), "127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    try:
        out = await load(port, clients, seconds)
    finally:
        srv.close()
        for proto in list(conns):
            proto.close()
        await srv.wait_closed()
    return {**out, "port": port}


def run(seconds: float = SECONDS, clients: int = CLIENTS, log=print) -> dict:
    canned = json.dumps(payload)
    log(f"payload {len(canned)} bytes")
    t0 = time.perf_counter()
    for _ in range(200):
        json.dumps(payload)
    dumps_ms = (time.perf_counter() - t0) / 200 * 1000
    log(f"json.dumps(100 results): {dumps_ms:.2f} ms")
    out = asyncio.run(serve_and_load(clients, seconds))
    cores = sorted(os.sched_getaffinity(0))
    log(f"protocol-only: {out['qps']:.0f} qps ({clients} clients, server+client on one event loop, one thread; "
        f"{len(cores)} usable cores) errors={out['errors']}")
    return {**out, "payload_bytes": len(canned), "dumps_ms": dumps_ms, "usable_cores": len(cores),
            "clients": clients, "children_left": len(cc.children())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=SECONDS)
    ap.add_argument("--clients", type=int, default=CLIENTS)
    args = ap.parse_args(argv)
    out = run(args.seconds, args.clients, log=lambda m: print(m, flush=True))
    print(json.dumps({"proto_ceiling": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
