"""The load generator: closed-loop keep-alive HTTP/1.1 clients over raw
sockets, in a process of its own (standard library only).

Reads one JSON object from standard input: port, conns, seconds, the
request body's fixed fields, the warm-up queries and the window's
queries.
Every connection first sends its share of the warm-up queries; then the
window opens (`t_start`, on CLOCK_MONOTONIC, which the parent shares) and
each connection sends the next unsent query as soon as its previous
answer has arrived, until `seconds` have passed. Each query is sent once.
Prints the window's start as a JSON line when it opens, then one JSON
object: the window's bounds, each window request's
(index, send time, latency or None for a failure) and every answered
request's response body, by index.
"""

import asyncio
import json
import sys
import time


def request(body: bytes) -> bytes:
    return (b"POST /search HTTP/1.1\r\nHost: l\r\nContent-Type: application/json\r\nContent-Length: "
            + str(len(body)).encode() + b"\r\n\r\n" + body)


async def exchange(r, w, data: bytes):
    """-> (status, body) of one request on an open connection."""
    w.write(data)
    await w.drain()
    head = await r.readuntil(b"\r\n\r\n")
    j = head.lower().find(b"content-length:")
    body = await r.readexactly(int(head[j + 15:head.find(b"\r", j)]))
    return int(head[9:12]), body


async def main(spec: dict) -> dict:
    fixed = spec["body"]
    encode = lambda q: request(json.dumps({"query": q, **fixed}).encode())  # noqa: E731
    queries = spec["queries"]
    conns = [await asyncio.open_connection("127.0.0.1", spec["port"]) for _ in range(spec["conns"])]
    warm = spec["warm"]

    async def warm_up(c, part):
        for q in part:
            status, _ = await exchange(*c, encode(q))
            if status != 200:
                raise RuntimeError(f"warm-up request answered {status}")

    await asyncio.gather(*[warm_up(c, warm[i::len(conns)]) for i, c in enumerate(conns)])
    state = {"next": 0}
    records, bodies = [], {}
    t_start = time.monotonic()
    stop = t_start + spec["seconds"]
    print(json.dumps({"t_start": t_start}), flush=True)

    async def worker(c):
        while time.monotonic() < stop:
            i = state["next"]
            if i >= len(queries):
                state["exhausted"] = True
                return
            state["next"] = i + 1
            t0 = time.monotonic()
            try:
                status, body = await exchange(*c, encode(queries[i]))
            except (OSError, asyncio.IncompleteReadError, ValueError):
                records.append((i, t0, None))
                return
            t1 = time.monotonic()
            records.append((i, t0, t1 - t0 if status == 200 else None))
            bodies[i] = body

    await asyncio.gather(*[worker(c) for c in conns])
    t_end = time.monotonic()
    for _, w in conns:
        w.close()
    return {"t_start": t_start, "t_stop": stop, "t_end": t_end, "records": sorted(records),
            "bodies": {i: b.decode() for i, b in bodies.items()}, "exhausted": bool(state.get("exhausted"))}


if __name__ == "__main__":
    print(json.dumps(asyncio.run(main(json.loads(sys.stdin.read())))))
