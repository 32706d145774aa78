"""What the host-ceiling tools share (stack_ceiling, http_ceiling,
proto_ceiling, reuseport): an App with one canned POST /search route on
the port's HTTP protocol (server/fastpath.HttpProtocol), a server thread,
the scripts' raw-socket pipelined client, the host's core split, and the
checks that every child process was reaped and every port freed.

The JAX scripts served with aiohttp; the port has no aiohttp, and serves
with its own protocol. None of this touches the card."""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Callable, Optional

from rust_local_rag_tpu_torch.bench_server import core_split
from rust_local_rag_tpu_torch.server.fastpath import HttpServer
from rust_local_rag_tpu_torch.server.http_api import Request, Response, text_response

# the scripts' pipelined request: 61 bytes of body
REQ = (b"POST /search HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
       b"Content-Length: 61\r\n\r\n"
       b'{"query": "probe", "top_k": 100, "diversity_factor": 0.0000}\n')
DEPTH = 8


class CannedApp:
    """Stands in for http_api.App: the one route POST /search, answered by
    handler(request) on the serving loop; every other path gets App's 404
    and every other method its 405."""

    def __init__(self, handler: Callable[[Request], Response]):
        self.handler = handler

    def resolve(self, method: str, path: str):
        if path != "/search":
            return None, text_response(404, "404: Not Found"), {}
        if method != "POST":
            return None, text_response(405, "405: Method Not Allowed", {"Allow": "POST"}), {}
        return self._search, None, {}

    async def _search(self, req: Request, info: dict) -> Response:
        return self.handler(req)

    def start(self) -> None:
        pass

    async def cleanup(self) -> None:
        pass


def serve(app, cores=None, host: str = "127.0.0.1", port: int = 0):
    """HttpServer(app) on a thread of its own, pinned to `cores` (the
    threads it starts inherit them) -> (server, thread), once it listens."""
    server = HttpServer(app, host, port)
    ready = threading.Event()

    def run():
        if cores:
            os.sched_setaffinity(0, cores)
        server.run(ready=ready.set)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    if not ready.wait(60):
        raise RuntimeError("the server did not start")
    return server, thread


def stop(server, thread) -> None:
    server.stop()
    thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("the server thread did not stop")


def raw_worker(port: int, out: list, dur: float, depth: int = DEPTH, cores=None) -> None:
    """The scripts' raw-socket keep-alive client: `depth` requests sent at
    once, then their responses read, until `dur` seconds pass. Appends
    (responses, responses that were not 200, 1 if the server closed).
    (The scripts cut each header block before its last CRLF, which loses
    the length's last digit where Content-Length is the last header, as
    the port's protocol sends it; here each line keeps its CRLF.)"""
    if cores:
        os.sched_setaffinity(0, cores)
    n = bad = 0
    with socket.create_connection(("127.0.0.1", port)) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        stop_at = time.monotonic() + dur
        buf = b""
        while time.monotonic() < stop_at:
            s.sendall(REQ * depth)
            need = depth
            while need:
                chunk = s.recv(262144)
                if not chunk:
                    out.append((n, bad, 1))
                    return
                buf += chunk
                while True:
                    i = buf.find(b"\r\n\r\n")
                    if i < 0:
                        break
                    h = buf[:i + 2]  # each header line with its CRLF
                    j = h.lower().find(b"content-length:")
                    cl = int(h[j + 15:h.find(b"\r", j)])
                    if len(buf) < i + 4 + cl:
                        break
                    bad += not h.startswith(b"HTTP/1.1 200")
                    buf = buf[i + 4 + cl:]
                    n += 1
                    need -= 1
    out.append((n, bad, 0))


def raw_load(port: int, threads: int, dur: float, cores=None) -> dict:
    """`threads` raw_workers at once -> qps, responses and errors (non-200
    responses and connections the server closed)."""
    out: list = []
    ts = [threading.Thread(target=raw_worker, args=(port, out, dur, DEPTH, cores)) for _ in range(threads)]
    t0 = time.monotonic()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    el = time.monotonic() - t0
    n = sum(x[0] for x in out)
    return {"qps": n / el, "responses": n, "errors": sum(x[1] + x[2] for x in out) + threads - len(out)}


def cores_line() -> dict:
    """The host's usable cores and their split: the server's and the load
    generator's (bench_server.core_split)."""
    server, client = core_split()
    return {"usable_cores": len(os.sched_getaffinity(0)), "server_cores": server, "client_cores": client}


def _procs(field: int, value: int) -> list:
    """Processes whose /proc/<pid>/stat field `field` (counted after the
    state: 1 the parent, 3 the session) is `value`; zombies count."""
    found = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat", "rb") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat[stat.rindex(b")") + 2:].split()[field]) == value:
            found.append(int(name))
    return found


def children(pid: Optional[int] = None) -> list:
    """Processes whose parent is `pid` (this process), reaped or not."""
    return _procs(1, os.getpid() if pid is None else pid)


def in_session(sid: int) -> list:
    """Processes of session `sid`: what a process started with
    start_new_session (it leads the session of its own pid) left behind,
    its grandchildren included."""
    return _procs(3, sid)


def port_free(port: int) -> bool:
    """True when a listening socket can bind 127.0.0.1:port again."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
