"""The port's HTTP/1.1 server: one hand-written asyncio.Protocol for every
route (port of rust_local_rag_tpu/server/fastpath.py, which serves
POST /search from the socket and hands every other request to aiohttp;
the port has no aiohttp, so the same protocol serves the rest too).

  * POST /search is served inline, as in the JAX fast path: parsed with
    the shared parse_search_params, submitted to the search batcher with a
    completion the batcher resolves on the loop (one wake-up a batch), and
    answered with the native serializer's bytes, or json.dumps of the
    objects in the lanes that answer objects. No task, no Request object.
  * Every other request runs its http_api.App handler as a task.
  * Responses on a connection leave in request order (HTTP/1.1
    pipelining): each request takes a slot, and slots are written from
    the head of the queue as they complete. A streamed response (the MCP
    SSE channel, chunked) holds the head of the queue until it ends.
  * What aiohttp did for the JAX server: keep-alive (HTTP/1.0 closes
    unless asked to keep alive), `Expect: 100-continue` (an interim
    100 Continue in the request's slot), chunked request bodies, 404 and
    405 with Allow, HEAD on GET routes, a 32 KiB header limit (400 and
    close) and a 64 MiB body limit (413 and close), and on a lost
    connection the handler tasks are cancelled and every stream closed,
    so an SSE subscription does not outlive its client.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import re
import signal
from collections import deque
from http import HTTPStatus
from typing import Callable, Optional
from urllib.parse import unquote

from rust_local_rag_tpu_torch.server.http_api import (
    App,
    Request,
    Response,
    parse_search_params,
    text_response,
)
from rust_local_rag_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

MAX_HEADER = 32 * 1024
MAX_BODY = 64 * 1024 * 1024  # the JAX server's aiohttp client_max_size

_TOKEN = re.compile(r"^[!#$%&'*+.^_`|~0-9A-Za-z-]+$")
_HEX = re.compile(rb"^[0-9A-Fa-f]+$")
_CONTINUE = b"HTTP/1.1 100 Continue\r\n\r\n"
_REQUEST_IDS = itertools.count(1)  # the request id of each request the process reads


class _BadRequest(Exception):
    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status


def _parse_chunked(buf: bytearray, pos: int):
    """(body, end) of a chunked body starting at buf[pos], or None while it
    is incomplete. Raises _BadRequest when it is malformed or too large."""
    out = bytearray()
    while True:
        eol = buf.find(b"\r\n", pos)
        if eol < 0:
            return None
        size_s = bytes(buf[pos:eol]).split(b";", 1)[0].strip()
        if not _HEX.match(size_s):
            raise _BadRequest(400, "Bad Request: invalid chunk size")
        size = int(size_s, 16)
        pos = eol + 2
        if size == 0:  # the last chunk, then trailers up to an empty line
            while True:
                eol = buf.find(b"\r\n", pos)
                if eol < 0:
                    return None
                if eol == pos:
                    return bytes(out), eol + 2
                pos = eol + 2
        if len(out) + size > MAX_BODY:
            raise _BadRequest(413, "Request Entity Too Large")
        if len(buf) < pos + size + 2:
            return None
        if buf[pos + size:pos + size + 2] != b"\r\n":
            raise _BadRequest(400, "Bad Request: invalid chunk")
        out += buf[pos:pos + size]
        pos += size + 2


def _search_params(body: bytes):
    """(params, None) of a /search body, or (None, the 400 text)."""
    try:
        payload = json.loads(body)
    except ValueError:  # JSONDecodeError and UnicodeDecodeError
        payload = None
    if not isinstance(payload, dict):
        return None, "invalid JSON"
    return parse_search_params(payload)


class _Slot:
    """One in-order response slot of a connection."""

    __slots__ = ("payload", "close_after", "version", "head_only", "stream", "chunked", "pumping", "request")

    def __init__(self, version: str = "HTTP/1.1", close_after: bool = False, head_only: bool = False,
                 request: Optional[int] = None):
        self.payload: Optional[bytes] = None  # the response head (+ body)
        self.request = request  # the request id; None for an interim or error slot
        self.close_after = close_after
        self.version = version
        self.head_only = head_only
        self.stream = None
        self.chunked = False
        self.pumping = False


class _SlotFuture:
    """Future-shaped completion of one /search slot: the batcher resolves it
    on the loop like an asyncio future."""

    __slots__ = ("proto", "slot")

    def __init__(self, proto: "HttpProtocol", slot: _Slot):
        self.proto = proto
        self.slot = slot

    def done(self) -> bool:
        return self.slot.payload is not None

    def set_result(self, res) -> None:
        if not isinstance(res, (bytes, bytearray)):
            # a lane that answers objects: the same JSON as the bytes'
            with profiling.span("http.serialize", request=self.slot.request):
                res = json.dumps({"results": [r.to_dict() for r in res]}).encode()
        self.proto._finish(self.slot, Response(200, bytes(res), "application/json"))

    def set_exception(self, exc: BaseException) -> None:
        logger.error("Search error: %s", exc)
        self.proto._finish(self.slot, Response(500))


class HttpProtocol(asyncio.Protocol):
    def __init__(self, app: App, loop: asyncio.AbstractEventLoop, conns: set):
        self._app = app
        self._loop = loop
        self._conns = conns
        self._buf = bytearray()
        self._pending: "deque[_Slot]" = deque()
        self._tasks: set = set()
        self._transport = None
        self._closed = False
        self._reading = True  # False after a request that ends the connection
        self._continued = False  # 100 Continue sent for the request being read
        self._eof = False

    # ----- asyncio.Protocol -----

    def connection_made(self, transport) -> None:
        self._transport = transport
        self._conns.add(self)

    def data_received(self, data: bytes) -> None:
        if not self._reading:
            return
        self._buf += data
        try:
            self._process()
        except _BadRequest as e:
            self._fail(e.status, str(e))

    def eof_received(self):
        """Keep the transport open until the answers already owed are
        written, unless one of them is a stream: a stream never ends on its
        own, so a client that stops sending has left it."""
        self._eof = True
        return bool(self._pending) and not any(slot.stream is not None for slot in self._pending)

    def connection_lost(self, exc) -> None:
        self._closed = True
        self._conns.discard(self)
        for slot in self._pending:
            if slot.stream is not None:
                slot.stream.close()
        self._pending.clear()
        for t in list(self._tasks):
            t.cancel()

    def close(self) -> None:
        if self._transport is not None and not self._closed:
            self._transport.abort()

    # ----- requests -----

    def _process(self) -> None:
        while self._reading and not self._closed:
            he = self._buf.find(b"\r\n\r\n")
            if he < 0:
                if len(self._buf) > MAX_HEADER:
                    raise _BadRequest(400, "Bad Request: request header too large")
                return
            if he > MAX_HEADER:
                raise _BadRequest(400, "Bad Request: request header too large")
            lines = bytes(self._buf[:he]).decode("latin-1").split("\r\n")
            parts = lines[0].split(" ")
            if len(parts) != 3 or not _TOKEN.match(parts[0]) or parts[2] not in ("HTTP/1.1", "HTTP/1.0"):
                raise _BadRequest(400, "Bad Request: invalid request line")
            method, target, version = parts
            headers = {}
            for line in lines[1:]:
                name, sep, value = line.partition(":")
                if not sep or not _TOKEN.match(name):
                    raise _BadRequest(400, "Bad Request: invalid header line")
                headers[name.lower()] = value.strip()
            start = he + 4
            if "chunked" in headers.get("transfer-encoding", "").lower():
                parsed = _parse_chunked(self._buf, start)
            else:
                raw_len = headers.get("content-length", "0")
                if not raw_len.isdigit():
                    raise _BadRequest(400, "Bad Request: invalid Content-Length")
                if int(raw_len) > MAX_BODY:
                    raise _BadRequest(413, "Request Entity Too Large")
                end = start + int(raw_len)
                parsed = (bytes(self._buf[start:end]), end) if len(self._buf) >= end else None
            if (headers.get("expect", "").lower() == "100-continue" and version == "HTTP/1.1"
                    and not self._continued):
                self._continued = True
                slot = _Slot()
                slot.payload = _CONTINUE
                self._pending.append(slot)
                self._drain()
            if parsed is None:
                return  # the body is not complete yet
            body, end = parsed
            del self._buf[:end]
            self._continued = False
            conn = headers.get("connection", "").lower()
            close_after = "close" in conn or (version == "HTTP/1.0" and "keep-alive" not in conn)
            if close_after:
                self._reading = False
            self._dispatch(method, target, version, headers, body, close_after)

    def _dispatch(self, method, target, version, headers, body: bytes, close_after: bool) -> None:
        slot = _Slot("HTTP/1.0" if version == "HTTP/1.0" else "HTTP/1.1", close_after, method == "HEAD",
                     next(_REQUEST_IDS))
        self._pending.append(slot)
        path = unquote(target.split("?", 1)[0])
        handler, err, info = self._app.resolve(method, path)
        if err is not None:
            self._finish(slot, err)
        elif handler is None:
            self._search(slot, body)
        else:
            task = self._loop.create_task(self._run(handler, Request(method, path, headers, body), info, slot))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    async def _run(self, handler, req: Request, info: dict, slot: _Slot) -> None:
        try:
            resp = await handler(req, info)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 - one failed request answers 500
            logger.exception("Error handling request %s %s", req.method, req.path)
            resp = text_response(500, "500 Internal Server Error\n\nServer got itself in trouble")
            slot.close_after = True
        self._finish(slot, resp)

    def _search(self, slot: _Slot, body: bytes) -> None:
        """POST /search, inline (the JAX fast path's _handle)."""
        with profiling.span("http.parse", request=slot.request):
            params, err = _search_params(body)
        if err is not None:
            self._finish(slot, text_response(400, err))
            return
        try:
            self._app.ctx.batcher.submit(
                params["query"],
                params["top_k"],
                params["diversity"],
                params["weights"],
                rejection_threshold=params["rejection_threshold"],
                use_reranker=params["use_reranker"],
                rejection_cosine_floor=params["rejection_cosine_floor"],
                rejection_query_floor=params["rejection_query_floor"],
                rejection_unseen_mass=params["rejection_unseen_mass"],
                rejection_unseen_cos=params["rejection_unseen_cos"],
                rejection_unseen_judge=params["rejection_unseen_judge"],
                want_payload=True,
                afuture=_SlotFuture(self, slot),
                loop=self._loop,
                request=slot.request,
            )
        except Exception as e:  # noqa: BLE001 - answered 500, as the JAX server does
            _SlotFuture(self, slot).set_exception(e)

    # ----- responses (on the loop) -----

    def _finish(self, slot: _Slot, resp: Response) -> None:
        with profiling.span("http.write", request=slot.request):
            reason = HTTPStatus(resp.status).phrase
            lines = [f"{slot.version} {resp.status} {reason}"]
            if resp.content_type:
                lines.append(f"Content-Type: {resp.content_type}")
            lines.extend(f"{k}: {v}" for k, v in resp.headers.items())
            if resp.stream is None:
                lines.append(f"Content-Length: {len(resp.body)}")
            elif slot.version == "HTTP/1.1" and not slot.head_only:
                lines.append("Transfer-Encoding: chunked")
                slot.chunked = True
            else:
                slot.close_after = slot.close_after or not slot.head_only
            if slot.close_after:
                lines.append("Connection: close")
            head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
            slot.stream = resp.stream
            slot.payload = head if slot.head_only or resp.stream is not None else head + resp.body
            if self._closed and slot.stream is not None:
                slot.stream.close()
            self._drain()

    def _drain(self) -> None:
        if self._closed:
            return
        out = []
        close = False
        while self._pending and self._pending[0].payload is not None:
            slot = self._pending[0]
            if slot.stream is not None and not slot.head_only:
                if not slot.pumping:
                    slot.pumping = True
                    out.append(slot.payload)
                    task = self._loop.create_task(self._pump(slot))
                    self._tasks.add(task)
                    task.add_done_callback(self._tasks.discard)
                break  # a stream holds the connection until it ends
            self._pending.popleft()
            if slot.stream is not None:  # HEAD of a streamed route
                slot.stream.close()
            out.append(slot.payload)
            if slot.close_after:
                close = True
                break
        if out:
            self._transport.write(b"".join(out))
        if close or (self._eof and not self._pending):
            self._transport.close()
            self._closed = True

    async def _pump(self, slot: _Slot) -> None:
        stream = slot.stream
        try:
            while True:
                chunk = await stream.next()
                if chunk is None:
                    break
                self._transport.write(b"%x\r\n%s\r\n" % (len(chunk), chunk) if slot.chunked else chunk)
            if slot.chunked:
                self._transport.write(b"0\r\n\r\n")
        finally:
            stream.close()
        slot.stream = None
        if self._pending and self._pending[0] is slot:
            self._pending.popleft()
        if slot.close_after:
            self._transport.close()
            self._closed = True
        else:
            self._drain()

    def _fail(self, status: int, text: str) -> None:
        """Answer a request that cannot be read, after the answers owed,
        and close: the rest of the stream has no known framing."""
        self._reading = False
        self._buf.clear()
        slot = _Slot(close_after=True)
        self._pending.append(slot)
        self._finish(slot, text_response(status, text))


class HttpServer:
    """The serve loop of `python -m rust_local_rag_tpu_torch`: serves an
    App on host:port (port 0 picks a free one, readable from
    .port once running). run() blocks until SIGINT / SIGTERM (in the main
    thread) or stop(), then closes every connection and runs the App's
    cleanup."""

    def __init__(self, app: App, host: str, port: int):
        self.app = app
        self.host = host
        self.port = port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._conns: set = set()

    def run(self, ready: Optional[Callable[[], None]] = None) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        signals = []
        srv = None
        try:
            srv = loop.run_until_complete(self._start())
            for sig in (signal.SIGINT, signal.SIGTERM):
                try:
                    loop.add_signal_handler(sig, loop.stop)
                    signals.append(sig)
                except (NotImplementedError, RuntimeError, ValueError):
                    pass  # not the main thread: stop() ends the loop
            if ready is not None:
                ready()
            loop.run_forever()
        finally:
            for sig in signals:
                loop.remove_signal_handler(sig)
            loop.run_until_complete(self._shutdown(srv))
            loop.close()
            asyncio.set_event_loop(None)

    async def _start(self):
        self.app.start()
        loop = asyncio.get_running_loop()
        srv = await loop.create_server(lambda: HttpProtocol(self.app, loop, self._conns), self.host, self.port)
        self.port = srv.sockets[0].getsockname()[1]
        return srv

    async def _shutdown(self, srv) -> None:
        if srv is not None:
            srv.close()
        for proto in list(self._conns):
            proto.close()
        if srv is not None:
            await srv.wait_closed()
        await self.app.cleanup()
        rest = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        for t in rest:
            t.cancel()
        await asyncio.gather(*rest, return_exceptions=True)

    def stop(self) -> None:
        """Thread-safe: end run()."""
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)

