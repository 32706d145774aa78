"""Mixed-load soak against a running port server (port of scripts/soak.py on
the standard library's http.client, through utils/http_pool's keep-alive
connections): concurrent searches while a mutator reindexes in a loop,
plus stats polling and an MCP SSE listener, with the JAX soak's invariant
checks (every search answers 200 with well-formed results, every job
completes, the document count never drifts).

With --documents (the server's DOCUMENTS_DIR) the mutator also rewrites
one document (SOAK_DOC) before each reindex, so each cycle replaces its
chunks under live reads (replace-document slab churn); the soak then ends
with one more reindex and a search that must find the final revision's
word in that document.

    python -m rust_local_rag_tpu_torch.tools.soak [base_url] [seconds] [--documents DIR]
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import random
import socket
import sys
import threading
import time
from typing import Optional
from urllib.parse import urlsplit

from rust_local_rag_tpu_torch.utils.http_pool import ConnectionPool

QUERIES = ["tomato watering", "galaxies nebulae", "sicilian king pawn", "sourdough yeast",
           "random nonsense wormhole"]
SEARCHERS = 6
SOAK_DOC = "soak_revision.pdf"
JOB_POLLS = 400  # 0.5 s apart


def revision_pdf(rev: int) -> bytes:
    """SOAK_DOC's bytes at revision `rev`: two pages whose text carries the
    word soakrev<rev>."""
    from eval_harness import corpus

    word = f"soakrev{rev}"
    return corpus._make_pdf([
        f"Soak revision {word} replaces the previous text of this document.\n"
        f"Every reindex cycle rewrites it, so its chunks are replaced under live reads ({word}).",
        f"The second page of revision {word} keeps the document at two pages.",
    ])


class Client:
    """One thread's keep-alive connection to the server (a requests
    Session's part in the JAX soak)."""

    def __init__(self, base: str):
        u = urlsplit(base)
        self.host, self.port = u.hostname, u.port or 80
        self.pool = ConnectionPool(max_idle=1)

    def call(self, method: str, path: str, body=None, timeout: float = 30.0):
        """(status, parsed JSON or None)."""
        data = None if body is None else json.dumps(body).encode()
        headers = {"Content-Type": "application/json"} if data is not None else {}
        a = self.pool.request(self.host, self.port, method, path, data, headers, timeout)
        try:
            return a.status, json.loads(a.body) if a.body else None
        except ValueError:
            return a.status, None

    def wait_job(self, job_id: str, errors: list) -> None:
        for _ in range(JOB_POLLS):
            _, jr = self.call("GET", f"/jobs/{job_id}")
            if jr["status"] in ("completed", "failed"):
                if jr["status"] == "failed":
                    errors.append(f"job failed: {jr['error']}")
                return
            time.sleep(0.5)
        errors.append(f"job {job_id} did not finish")


def soak(base: str, seconds: float, documents: Optional[str] = None) -> dict:
    """Run the soak; -> {"counts", "errors", "final_revision"}."""
    stop = time.time() + seconds
    errors: list = []
    counts = {"search": 0, "reindex": 0, "stats": 0, "sse_events": 0, "rewrites": 0}
    lock = threading.Lock()
    rev = [0]

    def bump(key: str) -> None:
        with lock:
            counts[key] += 1

    def write_revision() -> None:
        path = os.path.join(documents, SOAK_DOC)
        with open(path + ".tmp", "wb") as f:
            f.write(revision_pdf(rev[0]))
        os.replace(path + ".tmp", path)

    def reindex_once(c: Client) -> None:
        status, body = c.call("POST", "/reindex")
        if status == 200:
            bump("reindex")
            c.wait_job(body["job_id"], errors)
        elif status != 409:
            errors.append(f"reindex {status}")

    if documents:  # revision 0 is indexed before the load starts
        write_revision()
        reindex_once(Client(base))

    def searcher() -> None:
        c = Client(base)
        while time.time() < stop:
            q = random.choice(QUERIES) + f" {random.randint(0, 50)}"
            try:
                status, body = c.call("POST", "/search", {"query": q, "top_k": 3}, timeout=120)
                if status != 200:
                    errors.append(f"search {status}")
                else:
                    for res in body["results"]:
                        if not (res["text"] and res["chunk_id"]):
                            errors.append("malformed result")
                bump("search")
            except Exception as e:  # noqa: BLE001
                errors.append(f"search exc {e}")

    def mutator() -> None:
        c = Client(base)
        while time.time() < stop:
            try:
                if documents:
                    rev[0] += 1
                    write_revision()
                    bump("rewrites")
                reindex_once(c)
            except Exception as e:  # noqa: BLE001
                errors.append(f"reindex exc {e}")
            time.sleep(1.0)

    def poller() -> None:
        c = Client(base)
        baseline = None
        while time.time() < stop:
            try:
                _, st = c.call("GET", "/stats")
                if baseline is None:
                    baseline = st["documents"]
                elif st["documents"] != baseline:
                    errors.append(f"doc count drift: {st}")
                bump("stats")
            except Exception as e:  # noqa: BLE001
                errors.append(f"stats exc {e}")
            time.sleep(1.0)

    sse: dict = {}

    def sse_listener() -> None:
        """Holds an MCP session and its SSE channel open for the whole soak,
        counting pushed job notifications (the streamable-HTTP transport
        under churn)."""
        c = Client(base)
        try:
            a = c.pool.request(c.host, c.port, "POST", "/mcp", json.dumps(
                {"jsonrpc": "2.0", "id": 1, "method": "initialize",
                 "params": {"protocolVersion": "2025-03-26"}}).encode(),
                {"Content-Type": "application/json"}, 30)
            sid = a.headers.get("Mcp-Session-Id")
            if not sid:
                errors.append("no MCP session id")
                return
            conn = http.client.HTTPConnection(c.host, c.port, timeout=max(seconds + 30, 60))
            sse["conn"] = conn
            conn.request("GET", "/mcp", headers={"Accept": "text/event-stream", "Mcp-Session-Id": sid})
            resp = conn.getresponse()
            if resp.status != 200:
                errors.append(f"sse open {resp.status}")
                return
            while time.time() < stop:
                line = resp.fp.readline()
                if not line:
                    break
                if line.startswith(b"data: "):
                    bump("sse_events")
        except (OSError, http.client.HTTPException, ValueError) as e:
            if time.time() < stop:
                errors.append(f"sse exc {e}")

    threads = [threading.Thread(target=searcher) for _ in range(SEARCHERS)]
    threads += [threading.Thread(target=mutator), threading.Thread(target=poller)]
    listener = threading.Thread(target=sse_listener, daemon=True)
    for t in threads + [listener]:
        t.start()
    for t in threads:
        t.join()
    conn = sse.get("conn")
    if conn is not None and conn.sock is not None:
        try:  # wakes the listener's read
            conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    listener.join(timeout=10)

    final = None
    if documents:
        c = Client(base)
        reindex_once(c)  # the last revision written is the one served
        word = f"soakrev{rev[0]}"
        _, body = c.call("POST", "/search", {"query": word, "top_k": 3, "use_reranker": False,
                                             "diversity_factor": 0.0})
        final = any(r["document"] == SOAK_DOC and word in r["text"] for r in body["results"])
        if not final:
            errors.append(f"final revision {word} not served: {body['results']}")
    return {"counts": counts, "errors": errors, "final_revision": final}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", nargs="?", default="http://127.0.0.1:3046")
    ap.add_argument("seconds", nargs="?", type=float, default=180)
    ap.add_argument("--documents", default=None, help="the server's DOCUMENTS_DIR: rewrite a document each cycle")
    args = ap.parse_args(argv)
    out = soak(args.base, args.seconds, args.documents)
    print("counts:", out["counts"])
    print("errors:", out["errors"][:10], f"(total {len(out['errors'])})")
    return 1 if out["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
