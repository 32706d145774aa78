"""MCP (Model Context Protocol) tool surface over streamable HTTP (port of
rust_local_rag_tpu/server/mcp.py: the same protocol version, server info,
tool list and answers).

Implements the six tools of the reference's RagMcpServer
(mcp_server.rs:78-300) as JSON-RPC 2.0 methods on a single POST endpoint
(default /mcp): initialize, tools/list, tools/call. Responses are JSON;
clients that ask for text/event-stream get a single-event SSE frame, which
is what the streamable-HTTP transport reduces to for request/response tools.
"""

from __future__ import annotations

import json
import logging
import math
from typing import Any, Dict, Optional

from rust_local_rag_tpu_torch.config import MAX_TOP_K, QueryWeights
from rust_local_rag_tpu_torch.server.formatting import format_search_results

logger = logging.getLogger(__name__)

PROTOCOL_VERSION = "2025-03-26"
SERVER_INFO = {"name": "rust-local-rag-tpu", "version": "0.1.0"}
INSTRUCTIONS = "A TPU-native RAG server for document search and analysis."

_WEIGHT_PROPS = {
    "embedding": {
        "type": "number",
        "description": "Embedding similarity weight (0.0-1.0, default: 0.7)",
    },
    "lexical": {
        "type": "number",
        "description": "Lexical/BM25 weight (0.0-1.0, default: 0.3)",
    },
    "reranker": {
        "type": "number",
        "description": "Reranker weight for score blending (0.0-1.0, default: 0.7)",
    },
    "initial": {
        "type": "number",
        "description": "Initial score weight for score blending (0.0-1.0, default: 0.3)",
    },
}

TOOLS = [
    {
        "name": "search_documents",
        "description": (
            "Search through uploaded documents using semantic similarity "
            "with optional MMR diversification and per-query weight "
            "customization"
        ),
        "inputSchema": {
            "type": "object",
            "properties": {
                "query": {"type": "string", "description": "The search query"},
                "top_k": {
                    "type": "integer",
                    "description": "Number of results to return (default: 5)",
                },
                "diversity_factor": {
                    "type": "number",
                    "description": (
                        "Diversity factor for MMR reranking (0.0-1.0, "
                        "default: 0.3). Higher values increase result "
                        "diversity."
                    ),
                },
                "weights": {
                    "type": "object",
                    "description": (
                        "Optional per-query weight overrides for scoring. "
                        "Omitted weights use cached defaults."
                    ),
                    "properties": _WEIGHT_PROPS,
                },
                "rejection_threshold": {
                    "type": "number",
                    "description": (
                        "Minimum absolute dense-similarity confidence; "
                        "results below it are dropped (possibly returning "
                        "no results). Default: server configuration."
                    ),
                },
                "use_reranker": {
                    "type": "boolean",
                    "description": (
                        "Set false to skip the rerank stage for this query "
                        "(default: true)."
                    ),
                },
                "rejection_cosine_floor": {
                    "type": "number",
                    "description": (
                        "Optional second rejection signal: minimum absolute "
                        "dense cosine a result must ALSO clear when the "
                        "judge gate is active (joint gate). Default: server "
                        "configuration."
                    ),
                },
                "rejection_query_floor": {
                    "type": "number",
                    "description": (
                        "QUERY-level rejection: when the judge runs and its "
                        "best yes-probability over the judged pool is below "
                        "this floor, the whole query returns no results. "
                        "Default: server configuration."
                    ),
                },
                "rejection_unseen_mass": {
                    "type": "number",
                    "description": (
                        "JOINT unseen-term gate: reject the query outright "
                        "when the IDF-weighted share of its terms never "
                        "seen by the indexed corpus is at least this, AND "
                        "its best absolute dense cosine is at most "
                        "rejection_unseen_cos. 0 disables. Default: server "
                        "configuration."
                    ),
                },
                "rejection_unseen_cos": {
                    "type": "number",
                    "description": (
                        "Dense-cosine ceiling paired with "
                        "rejection_unseen_mass (1.0 = mass-only rule). "
                        "Default: server configuration."
                    ),
                },
                "rejection_unseen_judge": {
                    "type": "number",
                    "description": (
                        "Judge-rescue term of the unseen gate: when > 0 "
                        "and the judge runs, the gate only fires if the "
                        "query's best judged yes-probability is also at "
                        "most this. 0 = 2-way rule. Default: server "
                        "configuration."
                    ),
                },
            },
            "required": ["query"],
        },
    },
    {
        "name": "list_documents",
        "description": "List all uploaded documents",
        "inputSchema": {"type": "object", "properties": {}},
    },
    {
        "name": "get_stats",
        "description": "Get RAG system statistics",
        "inputSchema": {"type": "object", "properties": {}},
    },
    {
        "name": "start_reindex",
        "description": (
            "Start a background reindexing job and return immediately with "
            "job ID"
        ),
        "inputSchema": {"type": "object", "properties": {}},
    },
    {
        "name": "get_job_status",
        "description": "Get the status of a job (reindexing, etc.)",
        "inputSchema": {
            "type": "object",
            "properties": {
                "job_id": {"type": "string", "description": "Job ID to query"}
            },
            "required": ["job_id"],
        },
    },
    {
        "name": "calibrate_reranker",
        "description": (
            "Calibrate reranker timeout by measuring actual LLM latencies "
            "and computing p99 statistics"
        ),
        "inputSchema": {
            "type": "object",
            "properties": {
                "query": {
                    "type": "string",
                    "description": "Sample query to use for calibration",
                },
                "sample_size": {
                    "type": "integer",
                    "description": "Number of samples to test (default: 20)",
                },
            },
            "required": ["query"],
        },
    },
]


def _text_result(text: str, is_error: bool = False) -> dict:
    out: Dict[str, Any] = {"content": [{"type": "text", "text": text}]}
    if is_error:
        out["isError"] = True
    return out


class McpHandler:
    """Dispatches MCP JSON-RPC requests against the app context.

    `ctx` provides: search(query, top_k, diversity, weights) -> results;
    list_documents(); get_stats(); start_reindex() -> (job|None);
    get_job(job_id); has_reranker(); get_embedding_candidates(query, n);
    calibrate(query, candidates, n).
    """

    def __init__(self, ctx):
        self.ctx = ctx

    def handle(self, payload: dict) -> Optional[dict]:
        """Returns a JSON-RPC response dict, or None for notifications."""
        rid = payload.get("id")
        method = payload.get("method", "")
        params = payload.get("params") or {}

        if rid is None:
            return None  # notification

        try:
            result = self._dispatch(method, params)
        except McpError as e:
            return {
                "jsonrpc": "2.0",
                "id": rid,
                "error": {"code": e.code, "message": str(e)},
            }
        except Exception as e:  # noqa: BLE001
            logger.exception("MCP internal error")
            return {
                "jsonrpc": "2.0",
                "id": rid,
                "error": {"code": -32603, "message": str(e)},
            }
        return {"jsonrpc": "2.0", "id": rid, "result": result}

    def _dispatch(self, method: str, params: dict) -> Any:
        if method == "initialize":
            return {
                "protocolVersion": PROTOCOL_VERSION,
                "capabilities": {"tools": {}},
                "serverInfo": SERVER_INFO,
                "instructions": INSTRUCTIONS,
            }
        if method == "ping":
            return {}
        if method == "tools/list":
            return {"tools": TOOLS}
        if method == "tools/call":
            name = params.get("name", "")
            args = params.get("arguments") or {}
            tool = getattr(self, f"_tool_{name}", None)
            if tool is None:
                raise McpError(-32602, f"Unknown tool: {name}")
            return tool(args)
        raise McpError(-32601, f"Method not found: {method}")

    # ----- tools (mcp_server.rs:78-300) -----

    def _tool_search_documents(self, args: dict) -> dict:
        query = args.get("query", "")
        # invalid argument types are -32602 Invalid params, mirroring the
        # HTTP handler's 400s, not internal errors
        try:
            top_k = min(int(args.get("top_k") or 5), MAX_TOP_K)
            diversity = float(args.get("diversity_factor", 0.3))
            rejection = args.get("rejection_threshold")
            rejection = None if rejection is None else float(rejection)
            cos_floor = args.get("rejection_cosine_floor")
            cos_floor = None if cos_floor is None else float(cos_floor)
            q_floor = args.get("rejection_query_floor")
            q_floor = None if q_floor is None else float(q_floor)
            um_mass = args.get("rejection_unseen_mass")
            um_mass = None if um_mass is None else float(um_mass)
            um_cos = args.get("rejection_unseen_cos")
            um_cos = None if um_cos is None else float(um_cos)
            um_judge = args.get("rejection_unseen_judge")
            um_judge = None if um_judge is None else float(um_judge)
            raw_w = args.get("weights")
            if raw_w is not None and not isinstance(raw_w, dict):
                raise ValueError("weights must be an object")
            weights = QueryWeights.from_dict(raw_w)
        except (TypeError, ValueError, AttributeError) as e:
            raise McpError(-32602, f"Invalid params: {e}")
        # float("nan")/float("inf") parse but are not valid factors — and
        # NaN slides through a min/max clamp unchanged
        if not math.isfinite(diversity) or (
            rejection is not None and not math.isfinite(rejection)
        ) or (cos_floor is not None and not math.isfinite(cos_floor)) or (
            q_floor is not None and not math.isfinite(q_floor)
        ) or (um_mass is not None and not math.isfinite(um_mass)) or (
            um_cos is not None and not math.isfinite(um_cos)
        ) or (um_judge is not None and not math.isfinite(um_judge)):
            raise McpError(-32602, "Invalid params: non-finite number")
        diversity = min(max(diversity, 0.0), 1.0)
        use_reranker = args.get("use_reranker", True)
        if not isinstance(use_reranker, bool):
            raise McpError(-32602, "Invalid params: use_reranker must be a boolean")
        try:
            results = self.ctx.search(
                query, top_k, diversity, weights, rejection, use_reranker,
                cos_floor, q_floor, um_mass, um_cos, um_judge,
            )
        except Exception as e:  # noqa: BLE001
            return _text_result(f"Search error: {e}", is_error=True)
        return _text_result(
            f"Found {len(results)} results for '{query}':\n\n"
            f"{format_search_results(results)}"
        )

    def _tool_list_documents(self, args: dict) -> dict:
        docs = self.ctx.list_documents()
        if not docs:
            return _text_result("No documents uploaded yet.")
        listing = "\n".join(f"{i + 1}. {d}" for i, d in enumerate(docs))
        return _text_result(f"Uploaded documents ({len(docs)}):\n{listing}")

    def _tool_get_stats(self, args: dict) -> dict:
        stats = self.ctx.get_stats()
        return _text_result(
            f"RAG System Stats:\n{json.dumps(stats, indent=2)}"
        )

    def _tool_start_reindex(self, args: dict) -> dict:
        job = self.ctx.start_reindex()
        if job is None:
            return _text_result(
                "A reindex job is already in progress. Please wait for it to "
                "complete or check its status with get_job_status.",
                is_error=True,
            )
        response = {
            "job_id": job.job_id,
            "status": "pending",
            "documents_dir": self.ctx.documents_dir,
            "message": (
                "Reindexing job started in background. Use get_job_status "
                "to check progress."
            ),
        }
        return _text_result(
            f"Reindexing started:\n{json.dumps(response, indent=2)}"
        )

    def _tool_get_job_status(self, args: dict) -> dict:
        job_id = args.get("job_id", "")
        job = self.ctx.get_job(job_id)
        if job is None:
            raise McpError(-32002, f"Job {job_id} not found")
        response = {
            "job_id": job.job_id,
            "status": job.status.value,
            "job_type": job.job_type.value,
            "progress": job.progress,
            "total": job.total,
            "error": job.error,
            "started_at": job.started_at,
            "updated_at": job.updated_at,
        }
        return _text_result(f"Job Status:\n{json.dumps(response, indent=2)}")

    def _tool_calibrate_reranker(self, args: dict) -> dict:
        sample_size = int(args.get("sample_size") or 100)
        query = args.get("query", "")
        if not self.ctx.has_reranker():
            return _text_result(
                "Reranker is not enabled. Set RAG_TPU_RERANK_MODEL (or "
                "OLLAMA_RERANK_MODEL) environment variable to enable "
                "reranking.",
                is_error=True,
            )
        candidates = self.ctx.get_embedding_candidates(query, sample_size * 2)
        if not candidates:
            return _text_result(
                "No candidates found for calibration. Index some documents "
                "first using start_reindex.",
                is_error=True,
            )
        try:
            stats = self.ctx.calibrate(query, candidates, sample_size)
        except Exception as e:  # noqa: BLE001
            return _text_result(f"Calibration failed: {e}", is_error=True)
        # 1.2x safety margin, minimum 10 s baseline (mcp_server.rs:258-289)
        safety_margin = 1.2
        recommended_ms = max(int(-(-stats.p99_ms * safety_margin // 1)), 10_000)
        response = {
            "calibration_stats": {
                "mean_ms": stats.mean_ms,
                "median_ms": stats.median_ms,
                "p95_ms": stats.p95_ms,
                "p99_ms": stats.p99_ms,
                "max_ms": stats.max_ms,
                "sample_size": stats.sample_size,
            },
            "safety_margin": safety_margin,
            "recommended_timeout_ms": recommended_ms,
            "current_timeout_ms": 10000,
            "query": query,
        }
        return _text_result(
            f"Reranker Calibration Results:\n{json.dumps(response, indent=2)}"
            f"\n\nRecommendation: Based on p99 latency ({stats.p99_ms:.0f}ms) "
            f"with {safety_margin}x safety margin (minimum 10 seconds "
            f"baseline), set timeout to {recommended_ms // 1000} seconds "
            f"(currently 10 seconds).\n"
            "Note: For reliable p99 estimation, use sample_size ≥ 50-100."
        )


class McpError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
