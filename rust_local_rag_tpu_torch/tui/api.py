"""HTTP client for the TUI (cf. bin/rag_tui/api.rs; port of
rust_local_rag_tpu/tui/api.py on http.client in place of requests).

The TUI calls the client from several threads at once (the search worker
and the stats, health and job pollers), so requests run on
utils/http_pool's keep-alive connections, which say when a request is
sent twice. POST /reindex never is: it starts a job.
"""

from __future__ import annotations

import http.client
import json
from dataclasses import dataclass
from typing import List, Optional, Tuple
from urllib.parse import urlsplit

from rust_local_rag_tpu_torch.utils.http_pool import ConnectionPool


@dataclass
class TuiSearchResult:
    text: str
    score: float
    document: str
    chunk_id: str
    chunk_index: int
    page_number: int
    section: Optional[str] = None
    embedding_score: Optional[float] = None
    lexical_score: Optional[float] = None
    initial_score: Optional[float] = None
    reranker_score: Optional[float] = None
    yes_logprob: Optional[float] = None
    no_logprob: Optional[float] = None

    @classmethod
    def from_json(cls, r: dict) -> "TuiSearchResult":
        return cls(
            text=r.get("text", ""),
            score=float(r.get("score", 0.0)),
            document=r.get("document", ""),
            chunk_id=r.get("chunk_id", ""),
            chunk_index=int(r.get("chunk_index", 0)),
            page_number=int(r.get("page_number", 0)),
            section=r.get("section"),
            embedding_score=r.get("embedding_score"),
            lexical_score=r.get("lexical_score"),
            initial_score=r.get("initial_score"),
            reranker_score=r.get("reranker_score"),
            yes_logprob=r.get("yes_logprob"),
            no_logprob=r.get("no_logprob"),
        )


@dataclass
class Stats:
    documents: int = 0
    chunks: int = 0
    status: str = "unknown"
    embedding_model: str = ""
    reranker_model: Optional[str] = None


@dataclass
class JobStatus:
    job_id: str
    status: str
    progress: int
    total: int
    error: Optional[str] = None


class HTTPError(RuntimeError):
    """A status of 400 or above, worded as requests' raise_for_status words
    it (the TUI shows the text in its status line)."""

    def __init__(self, status: int, reason: str, url: str):
        kind = "Client" if status < 500 else "Server"
        super().__init__(f"{status} {kind} Error: {reason} for url: {url}")
        self.status = status


@dataclass
class _Answer:
    status: int
    reason: str
    headers: http.client.HTTPMessage
    body: bytes
    url: str

    def raise_for_status(self) -> None:
        if 400 <= self.status < 600:
            raise HTTPError(self.status, self.reason, self.url)

    def json(self):
        return json.loads(self.body)


def _job(d: dict) -> JobStatus:
    return JobStatus(job_id=d["job_id"], status=d["status"], progress=int(d.get("progress", 0)),
                     total=int(d.get("total", 0)), error=d.get("error"))


class ApiClient:
    def __init__(self, base_url: str = "http://127.0.0.1:3046", timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._pool = ConnectionPool()

    def _target(self) -> Tuple[str, int, str]:
        """(host, port, path prefix) of base_url, read at each request (the
        settings editor repoints a live client)."""
        u = urlsplit(self.base_url)
        if u.scheme != "http" or not u.hostname:
            raise ValueError(f"not an http:// server URL: {self.base_url!r}")
        return u.hostname, u.port or 80, u.path

    def close(self) -> None:
        self._pool.close()

    def _request(self, method: str, path: str, body=None, timeout: float = 30.0, retry: bool = True) -> _Answer:
        host, port, prefix = self._target()
        data = None if body is None else json.dumps(body).encode()
        headers = {} if data is None else {"Content-Type": "application/json"}
        a = self._pool.request(host, port, method, prefix + path, data, headers, timeout, retry)
        return _Answer(a.status, a.reason, a.headers, a.body, f"http://{host}:{port}{prefix}{path}")

    def _checked(self, method: str, path: str, body=None, timeout: float = 30.0) -> _Answer:
        a = self._request(method, path, body, timeout)
        a.raise_for_status()
        return a

    def search(self, query: str, top_k: int = 10, diversity: float = 0.3
               ) -> List[TuiSearchResult]:
        d = self._checked("POST", "/search", {"query": query, "top_k": top_k, "diversity_factor": diversity},
                          self.timeout).json()
        return [TuiSearchResult.from_json(x) for x in d.get("results", [])]

    def stats(self) -> Stats:
        d = self._checked("GET", "/stats", timeout=5).json()
        return Stats(
            documents=int(d.get("documents", 0)),
            chunks=int(d.get("chunks", 0)),
            status=d.get("status", "unknown"),
            embedding_model=d.get("embedding_model", ""),
            reranker_model=d.get("reranker_model"),
        )

    def health(self) -> bool:
        try:
            return self._request("GET", "/healthz", timeout=3).status == 200
        except (http.client.HTTPException, OSError, ValueError):
            return False

    def start_reindex(self) -> JobStatus:
        a = self._request("POST", "/reindex", timeout=10, retry=False)
        if a.status == 409:
            raise RuntimeError("A reindex job is already in progress")
        a.raise_for_status()
        return JobStatus(job_id=a.json()["job_id"], status="pending", progress=0, total=0)

    def job_status(self, job_id: str) -> Optional[JobStatus]:
        a = self._request("GET", f"/jobs/{job_id}", timeout=5)
        if a.status == 404:
            return None
        a.raise_for_status()
        return _job(a.json())

    def watch_jobs(self, on_job, should_stop) -> None:
        """Blocking: open the server's MCP SSE channel and invoke
        on_job(JobStatus) for each pushed reindex progress notification
        (the server's job push). Returns when the stream drops or
        should_stop() turns true; the caller reconnects with backoff.
        The TUI uses this for instant progress; 1 s polling remains the
        fallback when the channel is down. The stream has a connection of
        its own: 5 s to connect, 60 s a read (keep-alives arrive every
        15 s), so a dead stream raises socket.timeout."""
        a = self._request("POST", "/mcp", {"jsonrpc": "2.0", "id": 1, "method": "initialize",
                                           "params": {"protocolVersion": "2025-03-26"}}, timeout=10)
        sid = a.headers.get("Mcp-Session-Id")
        if not sid:
            return
        host, port, prefix = self._target()
        conn = http.client.HTTPConnection(host, port, timeout=5)
        try:
            conn.request("GET", prefix + "/mcp", headers={"Accept": "text/event-stream", "Mcp-Session-Id": sid})
            conn.sock.settimeout(60)
            resp = conn.getresponse()
            if resp.status != 200:
                return
            while True:
                raw = resp.readline()
                if not raw:
                    return
                if should_stop():
                    return
                line = raw.decode("utf-8", "replace").rstrip("\r\n")
                if not line.startswith("data: "):
                    continue
                try:
                    msg = json.loads(line[6:])
                except ValueError:
                    continue
                params = msg.get("params") or {}
                if msg.get("method") == "notifications/message" and params.get("logger") == "jobs":
                    d = params.get("data") or {}
                    on_job(JobStatus(
                        job_id=d.get("job_id", ""),
                        status=d.get("status", "unknown"),
                        progress=int(d.get("progress") or 0),
                        total=int(d.get("total") or 0),
                        error=d.get("error"),
                    ))
        finally:
            conn.close()

    def active_job(self) -> Optional[JobStatus]:
        d = self._checked("GET", "/jobs/active", timeout=5).json()
        return None if d is None else _job(d)
