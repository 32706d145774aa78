"""RAG server client for evaluation over http.client (port of
eval_harness/client.py, which uses requests): HTTP mode (POST /search) and
MCP JSON-RPC mode (tools/call search_documents, results parsed back out of
the markdown), the same endpoints, bodies, errors and fuzzy gold matching
as the harness's RAGClient. Requests go over utils/http_pool's keep-alive
connections."""

from __future__ import annotations

import http.client
import json
import re
import time
from dataclasses import dataclass
from typing import List, Optional
from urllib.parse import urlsplit

from rust_local_rag_tpu_torch.utils.http_pool import ConnectionPool


@dataclass
class SearchResult:
    chunk_id: str
    document: str
    page: int
    text: str
    score: float
    section: Optional[str] = None
    embedding_score: Optional[float] = None


@dataclass
class SearchResponse:
    results: List[SearchResult]
    latency_ms: float


class _HttpError(Exception):
    pass


class RAGClient:
    def __init__(self, endpoint: str = "http://localhost:3046", mode: str = "http", timeout: int = 60):
        self.endpoint = endpoint.rstrip("/")
        self.mode = mode
        self.timeout = timeout
        u = urlsplit(self.endpoint)
        if u.scheme != "http" or not u.hostname:
            raise ValueError(f"not an http:// endpoint: {endpoint!r}")
        self._host, self._port, self._path = u.hostname, u.port or 80, u.path
        self._pool = ConnectionPool(max_idle=1)

    def _request(self, method: str, path: str, body=None, timeout: Optional[float] = None):
        """(status, body bytes) of one request."""
        data = None if body is None else json.dumps(body).encode()
        headers = {"Content-Type": "application/json"} if data is not None else {}
        a = self._pool.request(self._host, self._port, method, path, data, headers, timeout or self.timeout)
        return a.status, a.body

    def request_json(self, method: str, path: str, body=None, timeout: Optional[float] = None):
        """The parsed JSON answer of one request; raises on a status >= 400."""
        status, raw = self._request(method, path, body, timeout)
        if status >= 400:
            raise _HttpError(f"{status} Error for url: http://{self._host}:{self._port}{path}")
        return json.loads(raw)

    def close(self) -> None:
        self._pool.close()

    def search(self, query: str, top_k: int = 5, params: Optional[dict] = None) -> SearchResponse:
        """`params` carries optional per-request search settings (weights,
        use_reranker, rejection_threshold) straight into the request body /
        tool arguments."""
        start = time.perf_counter()
        if self.mode == "mcp":
            results = self._search_via_mcp(query, top_k, params)
        else:
            results = self._search_via_http(query, top_k, params)
        return SearchResponse(results=results, latency_ms=(time.perf_counter() - start) * 1000)

    def _parse_results(self, rows) -> List[SearchResult]:
        out = []
        for r in rows:
            out.append(
                SearchResult(
                    chunk_id=r.get("chunk_id", ""),
                    document=r.get("document", r.get("document_name", "")),
                    page=int(r.get("page", r.get("page_number", 0))),
                    text=r.get("text", ""),
                    score=float(r.get("score", r.get("relevance_score", 0.0))),
                    section=r.get("section"),
                    embedding_score=r.get("embedding_score"),
                )
            )
        return out

    def _search_via_http(self, query: str, top_k: int, params: Optional[dict] = None) -> List[SearchResult]:
        body = {"query": query, "top_k": top_k}
        if params:
            body.update(params)
        try:
            return self._parse_results(self.request_json("POST", f"{self._path}/search", body).get("results", []))
        except (_HttpError, http.client.HTTPException, OSError, ValueError) as e:
            raise ConnectionError(f"Failed to connect to RAG server: {e}") from e

    def _search_via_mcp(self, query: str, top_k: int, params: Optional[dict] = None) -> List[SearchResult]:
        """MCP tools/call; the server returns markdown text like the
        reference's, so results are parsed from the markdown blocks."""
        arguments = {"query": query, "top_k": top_k}
        if params:
            arguments.update(params)
        payload = {
            "jsonrpc": "2.0",
            "id": int(time.time() * 1000),
            "method": "tools/call",
            "params": {"name": "search_documents", "arguments": arguments},
        }
        try:
            data = self.request_json("POST", self._path or "/", payload)
        except (_HttpError, http.client.HTTPException, OSError, ValueError) as e:
            raise ConnectionError(f"Failed to connect to MCP endpoint: {e}") from e
        if "error" in data:
            raise ConnectionError(f"MCP error: {data['error']}")
        texts = [item.get("text", "") for item in data.get("result", {}).get("content", [])
                 if item.get("type") == "text"]
        return _parse_markdown_results("\n".join(texts))

    def health_check(self) -> bool:
        try:
            if self.mode == "mcp":
                status, raw = self._request("POST", self._path or "/",
                                            {"jsonrpc": "2.0", "id": 1, "method": "tools/list"}, timeout=5)
                return status == 200 and "result" in json.loads(raw)
            return self._request("GET", f"{self._path}/readyz", timeout=5)[0] == 200
        except (http.client.HTTPException, OSError, ValueError):
            return False

    def get_stats(self) -> dict:
        if self.mode == "mcp":
            payload = {"jsonrpc": "2.0", "id": 1, "method": "tools/call",
                       "params": {"name": "get_stats", "arguments": {}}}
            for item in self.request_json("POST", self._path or "/", payload, timeout=10).get("result", {}).get("content", []):
                text = item.get("text", "")
                if "{" in text:
                    return json.loads(text[text.index("{"):])
            return {}
        return self.request_json("GET", f"{self._path}/stats", timeout=10)


def _parse_markdown_results(text: str) -> List[SearchResult]:
    """Parse the MCP markdown format back into structured results:
    **1. [85%] doc.pdf (page 5)** blocks separated by ---."""
    results: List[SearchResult] = []
    pattern = re.compile(
        r"\*\*(\d+)\. \[(\d+)%\] (.+?)(?: \(page (\d+)\))?\*\*\n"
        r"(?:\*Section: (.*?)\*\n)?\n(.*?)(?=\n\n---|\Z)",
        re.S,
    )
    for m in pattern.finditer(text):
        _, pct, doc, page, section, body = m.groups()
        results.append(
            SearchResult(
                chunk_id="",
                document=doc.strip(),
                page=int(page) if page else 0,
                text=body.strip(),
                score=int(pct) / 100.0,
                section=section,
            )
        )
    return results


# ----- fuzzy gold matching (eval/rag_client.py:249-283 semantics) -----


def normalize_doc_name(name: str) -> str:
    return name.lower().replace(".pdf", "").strip()


def make_chunk_key(document: str, page: int) -> str:
    return f"{normalize_doc_name(document)}::{page}"


def matches_gold_reference(retrieved: SearchResult, gold_doc: str, gold_page: int, tolerance: int = 1) -> bool:
    doc_match = normalize_doc_name(retrieved.document) == normalize_doc_name(gold_doc)
    page_match = abs(retrieved.page - gold_page) <= tolerance
    return doc_match and page_match
