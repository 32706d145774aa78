"""MCP streamable-HTTP session management (port of
rust_local_rag_tpu/server/sessions.py).

The reference serves MCP through rmcp's StreamableHttpService
(mcp_server.rs:546-563), which implements the full streamable-HTTP
transport: per-session state keyed by the Mcp-Session-Id header, an
optional GET SSE channel for server-initiated messages with
Last-Event-ID resumption, and DELETE session termination. This module
is the equivalent for the port's asyncio server: a session registry plus
a per-session replay buffer + subscriber queues.

Sessions are transport bookkeeping only — the tools themselves are
stateless (mcp.py) — but the SSE channel carries server-push job
progress notifications during reindex, which the polling reference
cannot do.
"""

from __future__ import annotations

import asyncio
import collections
import json
import os
import time
import uuid
from typing import Deque, Dict, List, Optional, Tuple

REPLAY_BUFFER = 256  # events kept per session for Last-Event-ID resumption


class McpSession:
    def __init__(self, session_id: str):
        self.session_id = session_id
        self.created = time.time()
        self.last_seen = self.created
        self._next_event_id = 1
        self._buffer: Deque[Tuple[int, str]] = collections.deque(
            maxlen=REPLAY_BUFFER
        )
        self._listeners: List[asyncio.Queue] = []
        self.closed = False

    def publish(self, message: dict) -> int:
        """Append a JSON-RPC message to the stream; wake all listeners."""
        eid = self._next_event_id
        self._next_event_id += 1
        data = json.dumps(message)
        self._buffer.append((eid, data))
        for q in list(self._listeners):
            q.put_nowait((eid, data))
        return eid

    def subscribe(self, last_event_id: Optional[int]) -> asyncio.Queue:
        """Register a listener queue, pre-loaded with any buffered events
        newer than last_event_id (SSE resumption)."""
        q: asyncio.Queue = asyncio.Queue()
        if last_event_id is not None:
            for eid, data in self._buffer:
                if eid > last_event_id:
                    q.put_nowait((eid, data))
        self._listeners.append(q)
        return q

    def unsubscribe(self, q: asyncio.Queue) -> None:
        if q in self._listeners:
            self._listeners.remove(q)

    def close(self) -> None:
        self.closed = True
        for q in list(self._listeners):
            q.put_nowait(None)  # sentinel: stream ends


class McpSessionHub:
    """Registry of live MCP sessions (created on `initialize`, removed on
    DELETE). Also the broadcast point for server-push notifications.

    Bounded: at most `max_sessions` live sessions — creating past the cap
    evicts the least-recently-used listener-less session (clients that
    initialize and vanish must not accumulate replay buffers forever).
    Sessions idle past `idle_ttl_s` with no listeners are likewise evicted
    on the next create."""

    def __init__(
        self,
        max_sessions: Optional[int] = None,
        idle_ttl_s: Optional[float] = None,
    ) -> None:
        self._sessions: Dict[str, McpSession] = {}
        self.max_sessions = (
            max_sessions
            if max_sessions is not None
            else int(os.environ.get("RAG_TPU_MAX_SESSIONS", "256"))
        )
        self.idle_ttl_s = (
            idle_ttl_s
            if idle_ttl_s is not None
            else float(os.environ.get("RAG_TPU_SESSION_TTL_S", "3600"))
        )

    def create(self) -> McpSession:
        self._evict()
        s = McpSession(uuid.uuid4().hex)
        self._sessions[s.session_id] = s
        return s

    def _evict(self) -> None:
        now = time.time()
        stale = [
            sid
            for sid, s in self._sessions.items()
            if not s._listeners and now - s.last_seen > self.idle_ttl_s
        ]
        for sid in stale:
            self.drop(sid)
        while len(self._sessions) >= self.max_sessions:
            victim = min(
                (
                    (s.last_seen, sid)
                    for sid, s in self._sessions.items()
                    if not s._listeners
                ),
                default=None,
            )
            if victim is None:  # every session has a live listener
                break
            self.drop(victim[1])

    def get(self, session_id: str) -> Optional[McpSession]:
        s = self._sessions.get(session_id)
        if s is not None:
            s.last_seen = time.time()
        return s

    def drop(self, session_id: str) -> bool:
        s = self._sessions.pop(session_id, None)
        if s is None:
            return False
        s.close()
        return True

    def has_listeners(self) -> bool:
        return any(s._listeners for s in self._sessions.values())

    def broadcast(self, message: dict) -> None:
        for s in self._sessions.values():
            s.publish(message)

    def __len__(self) -> int:
        return len(self._sessions)


def job_notification(job) -> dict:
    """MCP `notifications/message` carrying reindex job progress — pushed
    over the session SSE channels so clients need not poll get_job_status."""
    return {
        "jsonrpc": "2.0",
        "method": "notifications/message",
        "params": {
            "level": "info",
            "logger": "jobs",
            "data": {
                "job_id": job.job_id,
                "status": job.status.value,
                "progress": job.progress,
                "total": job.total,
                "error": job.error,
            },
        },
    }
