"""HTTP routes of the port: the JSON evaluation routes and the MCP endpoint
(port of rust_local_rag_tpu/server/http_api.py, without aiohttp).

Route surface (the reference's, mcp_server.rs:573-582):
  GET  /healthz      liveness, always 200
  GET  /readyz       readiness: 100 ms engine read-lock probe
  POST /search       JSON search for the eval harness (served inline by
                     the protocol in server/fastpath.py)
  GET  /stats        engine stats
  POST /reindex      start a background reindex (409 when one is active)
  GET  /jobs/active  the active reindex job or null
  GET  /jobs/{id}    job status
  POST {MCP_HTTP_ENDPOINT} (default /mcp)    MCP JSON-RPC
  GET  {MCP_HTTP_ENDPOINT}    the session's SSE push channel (Last-Event-ID
                              resumption; carries reindex job progress)
  DELETE {MCP_HTTP_ENDPOINT}  end the MCP session
Every GET route also answers HEAD, as aiohttp's add_get does.

The handlers are plain coroutines over the small Request / Response types
below; server/fastpath.HttpProtocol parses HTTP/1.1 and runs them. Blocking
engine calls run on the App's own thread pool under the engine's
reader-writer lock, so searches run together while ingest takes brief
write locks.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import math
import os
import re
import signal
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

from rust_local_rag_tpu_torch.config import MAX_TOP_K, QueryWeights, get_mcp_http_endpoint
from rust_local_rag_tpu_torch.jobs.job_manager import JobManager
from rust_local_rag_tpu_torch.jobs.worker import JobRequest, WorkerSupervisor
from rust_local_rag_tpu_torch.server.batcher import SearchBatcher
from rust_local_rag_tpu_torch.server.mcp import McpHandler
from rust_local_rag_tpu_torch.server.sessions import McpSessionHub, job_notification
from rust_local_rag_tpu_torch.utils.rwlock import RwLock

logger = logging.getLogger(__name__)

TEXT = "text/plain; charset=utf-8"
JSON = "application/json; charset=utf-8"
KEEPALIVE_S = 15.0  # an SSE comment line this often keeps idle streams open


class AppContext:
    """Shared state of the HTTP handlers and the MCP tool dispatcher
    (mcp_server.rs:399-406 AppState)."""

    def __init__(
        self,
        engine,
        engine_lock: RwLock,
        job_manager: JobManager,
        supervisor: WorkerSupervisor,
        documents_dir: str,
    ):
        self.engine = engine
        self.engine_lock = engine_lock
        self.job_manager = job_manager
        self.supervisor = supervisor
        self.documents_dir = documents_dir
        # coalesces concurrent searches into one engine pass
        self.batcher = SearchBatcher(engine, engine_lock)
        # set by App.start: thread-safe callback fired when a job starts,
        # drives the SSE job progress push
        self.on_job_started = None

    # --- blocking operations (run on the App's thread pool) ---

    def search(
        self,
        query,
        top_k,
        diversity,
        weights: Optional[QueryWeights],
        rejection_threshold: Optional[float] = None,
        use_reranker: bool = True,
        rejection_cosine_floor: Optional[float] = None,
        rejection_query_floor: Optional[float] = None,
        rejection_unseen_mass: Optional[float] = None,
        rejection_unseen_cos: Optional[float] = None,
        rejection_unseen_judge: Optional[float] = None,
    ):
        return self.batcher.search(
            query,
            top_k,
            diversity,
            weights,
            rejection_threshold=rejection_threshold,
            use_reranker=use_reranker,
            rejection_cosine_floor=rejection_cosine_floor,
            rejection_query_floor=rejection_query_floor,
            rejection_unseen_mass=rejection_unseen_mass,
            rejection_unseen_cos=rejection_unseen_cos,
            rejection_unseen_judge=rejection_unseen_judge,
        )

    def list_documents(self):
        with self.engine_lock.read():
            return self.engine.list_documents()

    def get_stats(self):
        with self.engine_lock.read():
            return self.engine.get_stats()

    def start_reindex(self):
        """Atomic create-if-not-active + enqueue (mcp_server.rs:148-189)."""
        job = self.job_manager.create_reindex_job_if_not_active(self.documents_dir, 0)
        if job is None:
            return None
        self.supervisor.submit(JobRequest(job.job_id, self.documents_dir))
        if self.on_job_started is not None:
            try:
                self.on_job_started(job.job_id)
            except Exception:  # noqa: BLE001 - progress push is best effort
                logger.debug("on_job_started hook failed", exc_info=True)
        return job

    def get_job(self, job_id: str):
        return self.job_manager.get_job(job_id)

    def find_active_job(self):
        return self.job_manager.find_active_reindex_job()

    def has_reranker(self) -> bool:
        with self.engine_lock.read():
            return self.engine.has_reranker()

    def get_embedding_candidates(self, query: str, count: int):
        with self.engine_lock.read():
            return self.engine.get_embedding_candidates(query, count)

    def calibrate(self, query, candidates, sample_size):
        with self.engine_lock.read():
            return self.engine.get_reranker().calibrate_timeout(query, candidates, sample_size)

    def readyz_probe(self) -> bool:
        """100 ms read-lock probe (mcp_server.rs:328-343)."""
        if self.engine_lock.acquire_read(timeout=0.1):
            self.engine_lock.release_read()
            return True
        return False


def parse_search_params(body: dict):
    """Validate a /search JSON body: (params, None), or (None, error text)
    for a 400, with the JAX server's texts."""
    query = body.get("query", "")
    try:
        top_k = min(int(body.get("top_k", 5)), MAX_TOP_K)
        diversity = float(body.get("diversity_factor", 0.3))
    except (TypeError, ValueError):
        return None, "invalid top_k/diversity_factor"
    # json.loads accepts NaN / Infinity, and NaN slides through a clamp
    if not math.isfinite(diversity):
        return None, "invalid top_k/diversity_factor"
    diversity = min(max(diversity, 0.0), 1.0)
    weights = QueryWeights.from_dict(body["weights"]) if isinstance(body.get("weights"), dict) else None
    params = {"query": query, "top_k": top_k, "diversity": diversity, "weights": weights}
    params["rejection_threshold"], err = _optional_float(body, "rejection_threshold")
    if err:
        return None, err
    use_reranker = body.get("use_reranker", True)
    if not isinstance(use_reranker, bool):
        return None, "invalid use_reranker"
    params["use_reranker"] = use_reranker
    for name in ("rejection_cosine_floor", "rejection_query_floor", "rejection_unseen_mass",
                 "rejection_unseen_cos", "rejection_unseen_judge"):
        value, err = _optional_float(body, name)
        if err:
            return None, err
        params[name] = value
    return params, None


def _optional_float(body: dict, name: str):
    """(float or None, None), or (None, "invalid <name>") when the value is
    not a finite number."""
    raw = body.get(name)
    if raw is None:
        return None, None
    try:
        value = float(raw)
    except (TypeError, ValueError):
        return None, f"invalid {name}"
    if not math.isfinite(value):
        return None, f"invalid {name}"
    return value, None


# ------------------------------------------------------------ messages ----


@dataclass
class Request:
    method: str
    path: str  # percent-decoded, without the query string
    headers: Dict[str, str]  # lower-case names
    body: bytes = b""


class EventStream:
    """A streamed response body: next() gives the next chunk, None at the
    end; close() runs once the stream ends or its connection is lost."""

    def __init__(self, next_chunk, on_close: Callable[[], None]):
        self.next = next_chunk
        self._on_close = on_close

    def close(self) -> None:
        on_close, self._on_close = self._on_close, None
        if on_close is not None:
            on_close()


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: Optional[str] = None
    headers: Dict[str, str] = field(default_factory=dict)
    stream: Optional[EventStream] = None


def text_response(status: int, text: str, headers: Optional[dict] = None) -> Response:
    return Response(status, text.encode(), TEXT, dict(headers or {}))


def json_response(obj, status: int = 200, headers: Optional[dict] = None) -> Response:
    return Response(status, json.dumps(obj).encode(), JSON, dict(headers or {}))


def _job_json(job) -> dict:
    return {"job_id": job.job_id, "status": job.status.value, "progress": job.progress,
            "total": job.total, "error": job.error}


# ----------------------------------------------------------------- app ----


class App:
    """The route table and the handlers over one AppContext. start() and
    cleanup() run on the serving loop: the job progress pusher and the
    supervisor watchdog."""

    def __init__(self, ctx: AppContext):
        self.ctx = ctx
        self.mcp = McpHandler(ctx)
        self.hub = McpSessionHub()
        self.endpoint = get_mcp_http_endpoint()
        # POST /search maps to None: the protocol serves it inline
        self.routes: Dict[str, Dict[str, Optional[Callable]]] = {
            "/healthz": {"GET": self.healthz},
            "/readyz": {"GET": self.readyz},
            "/search": {"POST": None},
            "/stats": {"GET": self.stats},
            "/reindex": {"POST": self.reindex},
            "/jobs/active": {"GET": self.active_job},
        }
        self.routes.setdefault(self.endpoint, {}).update(
            {"POST": self.mcp_post, "GET": self.mcp_get, "DELETE": self.mcp_delete})
        self._job_route = re.compile(r"^/jobs/([^{}/]+)$")
        self._executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._tasks: set = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.watchdog_interval_s = float(os.environ.get("RAG_TPU_WATCHDOG_INTERVAL_S", "5"))
        # what the watchdog does when the worker supervisor dies: SIGTERM
        # to this process, which HttpServer.run turns into a graceful shutdown
        self.watchdog_escalate: Callable[[], None] = lambda: os.kill(os.getpid(), signal.SIGTERM)

    # ----- routing -----

    def resolve(self, method: str, path: str) -> Tuple[Optional[Callable], Optional[Response], dict]:
        """(handler, None, match_info), or (None, 404/405 response, {}).
        POST /search resolves to (None, None, {})."""
        methods = self.routes.get(path)
        info: dict = {}
        if methods is None:
            m = self._job_route.match(path)
            if m is None:
                return None, text_response(404, "404: Not Found"), {}
            methods, info = {"GET": self.job_status}, {"job_id": m.group(1)}
        if method == "HEAD" and "GET" in methods:
            method = "GET"
        if method not in methods:
            allowed = set(methods) | ({"HEAD"} if "GET" in methods else set())
            return None, text_response(405, "405: Method Not Allowed", {"Allow": ",".join(sorted(allowed))}), {}
        return methods[method], None, info

    # ----- lifecycle (on the serving loop) -----

    def start(self) -> None:
        """Install the job-started hook and the watchdog; make the pool.

        The pool is sized for the batcher's widest batch plus slack: search
        threads wait on a future, not on the CPU, and asyncio's default
        pool (min(32, cpus + 4)) would cap every coalesced batch at its
        width on a small host."""
        self._loop = asyncio.get_running_loop()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=int(os.environ.get("RAG_TPU_BATCH_MAX", "16")) + 64,
            thread_name_prefix="http-worker",
        )
        loop = self._loop

        def on_started(job_id: str) -> None:
            loop.call_soon_threadsafe(self._spawn, self._watch_job(job_id))

        self.ctx.on_job_started = on_started
        self._spawn(self._watchdog())

    async def cleanup(self) -> None:
        self.ctx.on_job_started = None
        tasks = list(self._tasks)
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)

    def _spawn(self, coro) -> None:
        t = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    async def _in_executor(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(self._executor, fn, *args)

    async def _watch_job(self, job_id: str) -> None:
        """Poll one job until it ends, broadcasting every change of status
        or progress as an MCP notification to every session (each session's
        replay buffer keeps them for a client that connects later)."""
        last = None
        while True:
            try:
                job = await self._in_executor(self.ctx.get_job, job_id)
            except Exception:  # noqa: BLE001 - the push is best effort
                logger.debug("job progress fetch failed", exc_info=True)
                return
            if job is None:
                return
            snap = (job.status.value, job.progress, job.total)
            if snap != last:
                self.hub.broadcast(job_notification(job))
                last = snap
            if job.status.value in ("completed", "failed"):
                return
            await asyncio.sleep(0.4)

    async def _watchdog(self) -> None:
        """If the worker supervisor thread dies, shut the server down rather
        than serve with a dead ingest pipeline (main.rs:183-215)."""
        while True:
            await asyncio.sleep(self.watchdog_interval_s)
            sup = self.ctx.supervisor
            if sup is not None and not sup.is_healthy():
                logger.critical("Worker supervisor died unexpectedly; shutting down server")
                self.watchdog_escalate()
                return

    # ----- handlers -----

    async def healthz(self, req: Request, info: dict) -> Response:
        return Response(200)

    async def readyz(self, req: Request, info: dict) -> Response:
        ok = await self._in_executor(self.ctx.readyz_probe)
        return Response(200 if ok else 503)

    async def stats(self, req: Request, info: dict) -> Response:
        return json_response(await self._in_executor(self.ctx.get_stats))

    async def reindex(self, req: Request, info: dict) -> Response:
        try:
            job = await self._in_executor(self.ctx.start_reindex)
        except Exception as e:  # noqa: BLE001 - reported to the client
            logger.error("Failed to create reindex job: %s", e)
            return text_response(500, f"Failed to create job: {e}")
        if job is None:
            return text_response(409, "A reindex job is already in progress")
        return json_response({"job_id": job.job_id, "message": "Reindexing started"})

    async def job_status(self, req: Request, info: dict) -> Response:
        job_id = info["job_id"]
        job = await self._in_executor(self.ctx.get_job, job_id)
        if job is None:
            return text_response(404, f"Job {job_id} not found")
        return json_response(_job_json(job))

    async def active_job(self, req: Request, info: dict) -> Response:
        job = await self._in_executor(self.ctx.find_active_job)
        return json_response(None if job is None else _job_json(job))

    async def mcp_post(self, req: Request, info: dict) -> Response:
        try:
            payload = json.loads(req.body)
        except ValueError:
            return json_response(
                {"jsonrpc": "2.0", "id": None, "error": {"code": -32700, "message": "Parse error"}}, 400)
        if not isinstance(payload, dict):
            # JSON-RPC batch arrays and other non-objects are not supported
            return json_response(
                {"jsonrpc": "2.0", "id": None, "error": {"code": -32600, "message": "Invalid Request"}}, 400)
        # streamable-HTTP sessions (rmcp StreamableHttpService,
        # mcp_server.rs:546-563): `initialize` creates one and later
        # requests echo its id; an unknown id gets 404 so clients
        # re-initialize; requests with no id are served without a session
        headers = {}
        sid = req.headers.get("mcp-session-id")
        initialize = payload.get("method") == "initialize"
        if sid is not None and self.hub.get(sid) is None and not initialize:
            return Response(404)
        response = await self._in_executor(self.mcp.handle, payload)
        if initialize:
            headers["Mcp-Session-Id"] = self.hub.create().session_id
        elif sid is not None:
            headers["Mcp-Session-Id"] = sid
        if response is None:  # a notification
            return Response(202, headers=headers)
        accept = req.headers.get("accept", "")
        if "text/event-stream" in accept and "application/json" not in accept:
            body = f"event: message\ndata: {json.dumps(response)}\n\n"
            return Response(200, body.encode(), "text/event-stream", headers)
        return json_response(response, headers=headers)

    async def mcp_get(self, req: Request, info: dict) -> Response:
        """The session's server-push SSE channel, resumable from its replay
        buffer with Last-Event-ID; it carries reindex job progress and ends
        when the session is deleted."""
        if "text/event-stream" not in req.headers.get("accept", ""):
            return Response(405, headers={"Allow": "POST"})
        sid = req.headers.get("mcp-session-id")
        if not sid:
            return text_response(400, "Mcp-Session-Id required")
        session = self.hub.get(sid)
        if session is None:
            return Response(404)
        last_id = None
        raw = req.headers.get("last-event-id")
        if raw is not None:
            try:
                last_id = int(raw)
            except ValueError:
                last_id = None
        q = session.subscribe(last_id)

        async def next_chunk() -> Optional[bytes]:
            try:
                item = await asyncio.wait_for(q.get(), timeout=KEEPALIVE_S)
            except asyncio.TimeoutError:
                return b": keep-alive\n\n"
            if item is None:  # the session was deleted
                return None
            eid, data = item
            return f"id: {eid}\nevent: message\ndata: {data}\n\n".encode()

        return Response(
            200,
            content_type="text/event-stream",
            headers={"Cache-Control": "no-store", "Mcp-Session-Id": sid},
            stream=EventStream(next_chunk, lambda: session.unsubscribe(q)),
        )

    async def mcp_delete(self, req: Request, info: dict) -> Response:
        sid = req.headers.get("mcp-session-id")
        if not sid:
            return text_response(400, "Mcp-Session-Id required")
        return Response(200 if self.hub.drop(sid) else 404)

