"""Keep-alive HTTP/1.1 connections on http.client, shared by the TUI's
ApiClient and the eval harness's RAGClient (the port's stand-in for a
requests Session).

A request takes an idle connection to its (host, port) or opens one, and
gives it back when the answer has been read whole. Several threads may
send at once: each holds a connection of its own while it does.

A request is sent a second time only when all of these hold: it went out
on a reused connection, that connection turned out to be closed or reset
by the server before any byte of an answer arrived, and the caller let it
be repeated. A timeout is never repeated (the server may still be working
on the request). A request that must not be repeated (`retry=False`)
never takes a reused connection, so a stale one cannot fail it.
"""

from __future__ import annotations

import http.client
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

# the ways a server's close of an idle keep-alive connection shows: on the
# send, or on the first read of the status line (RemoteDisconnected is a
# ConnectionResetError that read no byte)
_CLOSED_BEFORE_ANSWER = (BrokenPipeError, ConnectionResetError, ConnectionAbortedError)


@dataclass
class Answer:
    status: int
    reason: str
    headers: http.client.HTTPMessage
    body: bytes


class ConnectionPool:
    def __init__(self, max_idle: int = 8):
        self.max_idle = max_idle
        self._idle: List[Tuple[Tuple[str, int], http.client.HTTPConnection]] = []
        self._lock = threading.Lock()

    def _take(self, addr: Tuple[str, int]) -> Optional[http.client.HTTPConnection]:
        with self._lock:
            for i, (a, conn) in enumerate(self._idle):
                if a == addr:
                    del self._idle[i]
                    return conn
        return None

    def _give_back(self, addr: Tuple[str, int], conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if len(self._idle) < self.max_idle:
                self._idle.append((addr, conn))
                return
        conn.close()

    def idle_count(self) -> int:
        with self._lock:
            return len(self._idle)

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for _, conn in idle:
            conn.close()

    def request(self, host: str, port: int, method: str, path: str, body: Optional[bytes] = None,
                headers: Optional[dict] = None, timeout: float = 30.0, retry: bool = True) -> Answer:
        addr = (host, port)
        conn = self._take(addr) if retry else None
        while True:
            reused = conn is not None
            if conn is None:
                conn = http.client.HTTPConnection(host, port, timeout=timeout)
            try:
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                try:
                    conn.request(method, path, body=body, headers=headers or {})
                    r = conn.getresponse()
                except _CLOSED_BEFORE_ANSWER:
                    if not reused:
                        raise
                    conn.close()
                    conn = None  # the server had closed this idle connection: once more, fresh
                    continue
                answer = Answer(r.status, r.reason, r.headers, r.read())
            except BaseException:
                conn.close()
                raise
            if r.will_close:
                conn.close()
            else:
                self._give_back(addr, conn)
            return answer
