"""The port's HTTP server (server/fastpath.HttpProtocol over
server/http_api.App, no aiohttp) against the JAX package's (its fast-path
protocol in front of aiohttp, started as tests/test_server.py starts it):
both hermetic (hash encoder, hash FakeReranker) over the same PDFs, both
reindexed over HTTP, then fed the same raw bytes. They must answer with
the same status and the same parsed body.

Normalised before comparing: chunk ids and job ids (uuid4, drawn anew by
each server), MCP session ids, and the clock fields of a job. Scores may
differ within 1e-6: the last-bit FMA difference of the blend (ROADMAP C5)
and the serializer's 7 fractional digits against json.dumps' repr; the
judged and object lanes' score, a quotient by the query's largest initial
score, within 1e-6 of its normaliser (score_tol, ROADMAP C10)."""

import asyncio
import json
import os
import re
import socket
import threading
import time

import pytest

import pdfgen
from rust_local_rag_tpu.engine import RagEngine as JEngine
from rust_local_rag_tpu.jobs import JobManager as JManager
from rust_local_rag_tpu.jobs import WorkerSupervisor as JSupervisor
from rust_local_rag_tpu.models import EmbeddingService as JService
from rust_local_rag_tpu.models import HashEncoder as JHash
from rust_local_rag_tpu.models.reranker import FakeReranker as JFakeReranker
from rust_local_rag_tpu.models.reranker_service import RerankerService as JRerankerService
from rust_local_rag_tpu.server.http_api import AppContext as JContext
from rust_local_rag_tpu.server.http_api import build_app as j_build_app
from rust_local_rag_tpu.utils.rwlock import RwLock as JLock
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine
from rust_local_rag_tpu_torch.jobs import JobManager, WorkerSupervisor
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService
from rust_local_rag_tpu_torch.models.fake_encoder import HashEncoder
from rust_local_rag_tpu_torch.models.reranker import FakeReranker
from rust_local_rag_tpu_torch.models.reranker_service import RerankerService
from rust_local_rag_tpu_torch.server.fastpath import MAX_BODY, HttpServer
from rust_local_rag_tpu_torch.server.http_api import App, AppContext
from rust_local_rag_tpu_torch.utils.rwlock import RwLock

SCORE_TOL = 1e-6
DOCS = {
    "astronomy.pdf": ["ASTRONOMY\n\nTelescopes observe distant galaxies and nebulae. Spectroscopy reveals the "
                      "composition of stars and the speed of receding galaxies.",
                      "Radio telescopes map cold hydrogen clouds in the spiral arms of galaxies."],
    "garden.pdf": ["GARDENING\n\nTomato plants need full sun and regular watering. Compost improves soil "
                   "structure and fertility.", "Prune tomato suckers weekly; mulch keeps the soil moist."],
    "kitchen.pdf": ["COOKING\n\nBraising softens tough cuts of meat slowly in a covered pot with a little "
                    "liquid.", "Resting roasted meat lets the juices settle before carving."],
    "rails.pdf": ["RAILWAYS\n\nSignal blocks keep trains apart; a train may enter a block only when it is "
                  "clear.", "Steam locomotives gave way to diesel and electric traction."],
}
QUERIES = ["telescopes observe galaxies", "tomato watering compost", "braising meat in a pot",
           "signal blocks keep trains apart", "quantum chromodynamics lattice"]
LANES = {
    "hot": {"diversity_factor": 0, "use_reranker": False},
    "mmr": {"diversity_factor": 0.3, "use_reranker": False},
    # eval_harness/configs/baseline.yaml:58-65
    "judged": {"diversity_factor": 0, "use_reranker": True, "rejection_threshold": 0.0,
               "rejection_unseen_mass": 0.35, "rejection_unseen_cos": 0.6, "rejection_unseen_judge": 0.2,
               "weights": {"reranker": 0.0, "initial": 1.0}},
    "object": {},
}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _JaxServer:
    def __init__(self, root, docs):
        root.mkdir(parents=True, exist_ok=True)
        svc = JService(JHash(dim=128, model_name="http-parity"))
        self.engine = JEngine(str(root / "data"), svc, reranker=JRerankerService(JFakeReranker(model_name="fake-rr")))
        self.lock = JLock()
        self.jm = JManager(str(root / "jobs.db"))
        self.sup = JSupervisor(self.jm, self.engine, self.lock, log_dir=str(root / "logs"))
        self.ctx = JContext(self.engine, self.lock, self.jm, self.sup, str(docs))
        self.port = _free_port()

    def start(self):
        from aiohttp import web

        from rust_local_rag_tpu.server.fastpath import FastPathProtocol

        self.sup.start()
        self.app = j_build_app(self.ctx)
        started = threading.Event()

        def run():
            self.loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self.loop)
            self.runner = web.AppRunner(self.app)
            self.loop.run_until_complete(self.runner.setup())
            loop = self.loop
            self.srv = loop.run_until_complete(loop.create_server(
                lambda: FastPathProtocol(self.runner.server, self.ctx, loop), "127.0.0.1", self.port))
            started.set()
            loop.run_forever()
            loop.close()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(30)

    def hub(self):
        return self.app["mcp_hub"]

    def stop(self):
        self.sup.stop(timeout=5)

        async def close():
            self.srv.close()
            await self.runner.cleanup()

        asyncio.run_coroutine_threadsafe(close(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.ctx.batcher.stop()


class _PortServer:
    def __init__(self, root, docs):
        root.mkdir(parents=True, exist_ok=True)
        svc = EmbeddingService(HashEncoder(dim=128, model_name="http-parity"))
        self.engine = RagEngine(str(root / "data"), svc, RerankerService(FakeReranker(model_name="fake-rr")),
                                device="cpu")
        self.lock = RwLock()
        self.jm = JobManager(str(root / "jobs.db"))
        self.sup = WorkerSupervisor(self.jm, self.engine, self.lock, log_dir=str(root / "logs"))
        self.ctx = AppContext(self.engine, self.lock, self.jm, self.sup, str(docs))
        self.app = App(self.ctx)
        self.server = HttpServer(self.app, "127.0.0.1", 0)

    def start(self):
        self.sup.start()
        ready = threading.Event()
        self.thread = threading.Thread(target=self.server.run, kwargs={"ready": ready.set}, daemon=True)
        self.thread.start()
        assert ready.wait(30)
        self.port = self.server.port

    def hub(self):
        return self.app.hub

    def stop(self):
        self.sup.stop(timeout=5)
        self.server.stop()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        self.ctx.batcher.stop()


# ------------------------------------------------------------ raw HTTP ----


class Conn:
    """One keep-alive connection that sends raw bytes and reads whole
    responses (Content-Length, chunked, or until close)."""

    def __init__(self, port, timeout=60.0):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
        self.f = self.sock.makefile("rb")

    def send(self, data: bytes):
        self.sock.sendall(data)

    def head(self):
        """(status, headers) of the next response, interim 1xx skipped
        and counted in self.interim."""
        self.interim = 0
        while True:
            line = self.f.readline()
            if not line:
                raise EOFError("connection closed")
            status = int(line.split(b" ", 2)[1])
            headers = {}
            while True:
                h = self.f.readline()
                if h in (b"\r\n", b""):
                    break
                k, _, v = h.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            if status >= 200:
                return status, headers
            self.interim += 1

    def chunk(self):
        size = int(self.f.readline().split(b";")[0], 16)
        data = self.f.read(size)
        self.f.readline()
        if size == 0:
            return None
        return data

    def read(self, head_only=False):
        status, headers = self.head()
        if head_only:
            body = b""
        elif "chunked" in headers.get("transfer-encoding", ""):
            parts = []
            while (c := self.chunk()) is not None:
                parts.append(c)
            body = b"".join(parts)
        elif "content-length" in headers:
            body = self.f.read(int(headers["content-length"]))
        else:
            body = self.f.read()
        return status, headers, body

    def request(self, data: bytes, head_only=False):
        self.send(data)
        return self.read(head_only)

    def closed_by_peer(self) -> bool:
        self.sock.settimeout(5)
        try:
            return self.f.read(1) == b""
        except (ConnectionResetError, socket.timeout):
            return False

    def close(self):
        self.f.close()
        self.sock.close()


def req(method: str, path: str, body=None, headers=None) -> bytes:
    if body is not None and not isinstance(body, bytes):
        body = json.dumps(body).encode()
    lines = [f"{method} {path} HTTP/1.1", "Host: test"]
    lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
    if body is not None and "Transfer-Encoding" not in (headers or {}):
        lines.append(f"Content-Length: {len(body)}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + (body or b"")


_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
_CLOCK = re.compile(r'"(started_at|updated_at)": \d+')
_SESSION = re.compile(r"\b[0-9a-f]{32}\b")


def norm(obj):
    """Drop what each server draws anew: uuids, job clocks, session ids."""
    if isinstance(obj, dict):
        return {k: ("ID" if k in ("chunk_id", "job_id") else norm(v))
                for k, v in obj.items() if k not in ("started_at", "updated_at")}
    if isinstance(obj, list):
        return [norm(v) for v in obj]
    if isinstance(obj, str):
        return _SESSION.sub("SID", _CLOCK.sub(r'"\1": T', _UUID.sub("ID", obj)))
    return obj


def parsed(status, headers, body):
    ctype = headers.get("content-type", "")
    if "json" in ctype:
        return status, norm(json.loads(body))
    if "event-stream" in ctype:
        return status, [norm(json.loads(ln[6:])) for ln in body.decode().splitlines() if ln.startswith("data: ")]
    return status, norm(body.decode("utf-8", "replace"))


def score_tol(row) -> float:
    """The tolerance of a result row's "score" (row: the JAX server's).

    The judged and object lanes (the rows that carry a reranker_score)
    divide the initial score by the query's largest initial score, so a
    last-bit difference of the dense plane reaches score multiplied by
    |score / initial_score| (init_w / vmax, or the initial term's share
    of it): SCORE_TOL is held in units of that normaliser. Every other
    field, and the hot and MMR rows, keep SCORE_TOL."""
    init = row.get("initial_score")
    if "reranker_score" not in row or not isinstance(init, (int, float)) or init == 0:
        return SCORE_TOL
    return SCORE_TOL * max(1.0, abs(row["score"] / init))


def assert_same(a, b, path="$", tol=SCORE_TOL):
    """a (the port's answer) equals b (the JAX server's), floats within tol."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), f"{path}: {a!r} != {b!r}"
        assert abs(a - b) <= tol, f"{path}: {a!r} != {b!r} (tolerance {tol:g})"
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), f"{path}: keys {sorted(a)} != {sorted(b)}"
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}", score_tol(b) if k == "score" else SCORE_TOL)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), f"{path}: {a!r} != {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def both(servers, fn):
    """fn(server) on the JAX server and the port's; the two answers match."""
    jax_out, port_out = fn(servers["jax"]), fn(servers["port"])
    assert_same(port_out, jax_out)
    return port_out


def one(server, data: bytes, head_only=False):
    c = Conn(server.port)
    try:
        return parsed(*c.request(data, head_only))
    finally:
        c.close()


def wait_job(server, job_id, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, body = one(server, req("GET", f"/jobs/{job_id}"))
        if body["status"] in ("completed", "failed"):
            return body
        time.sleep(0.05)
    raise AssertionError("reindex did not finish")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("http")
    docs = root / "documents"
    docs.mkdir()
    for name, pages in DOCS.items():
        (docs / name).write_bytes(pdfgen.make_pdf(pages))
    made = {"jax": _JaxServer(root / "jax", docs), "port": _PortServer(root / "port", docs)}
    for s in made.values():
        s.start()
    for s in made.values():
        c = Conn(s.port)
        status, _, body = c.request(req("POST", "/reindex"))
        assert status == 200
        s.job_id = json.loads(body)["job_id"]
        c.close()
    for s in made.values():
        assert wait_job(s, s.job_id)["status"] == "completed"
    yield made
    for s in made.values():
        s.stop()


# --------------------------------------------------------------- routes ----


@pytest.mark.parametrize("method,path", [
    ("GET", "/healthz"), ("GET", "/readyz"), ("GET", "/stats"), ("GET", "/jobs/active"),
    ("GET", "/jobs/no-such-job"), ("GET", "/jobs/a%20b"), ("GET", "/nope"), ("GET", "/healthz/"),
    ("GET", "/Healthz"), ("GET", "/search"), ("POST", "/healthz"), ("PUT", "/mcp"), ("DELETE", "/stats"),
    ("GET", "/stats?verbose=1"), ("GET", "/mcp"),
])
def test_route_answers_equal_jax(servers, method, path):
    body = b"" if method in ("POST", "PUT") else None
    out = both(servers, lambda s: one(s, req(method, path, body)))
    if out[0] == 405:
        allow = []
        for s in servers.values():
            c = Conn(s.port)
            allow.append(c.request(req(method, path, body))[1]["allow"])
            c.close()
        assert allow[0] == allow[1]


def test_head_and_job_status_equal_jax(servers):
    both(servers, lambda s: one(s, req("HEAD", "/healthz"), head_only=True))
    status, body = both(servers, lambda s: one(s, req("GET", f"/jobs/{s.job_id}")))
    assert status == 200 and body["status"] == "completed" and body["progress"] == body["total"] == len(DOCS)
    _, stats = both(servers, lambda s: one(s, req("GET", "/stats")))
    assert stats["documents"] == len(DOCS) and stats["reranker_model"] == "fake-rr"


@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("top_k", [1, 3, 7])
def test_search_lanes_equal_jax(servers, lane, top_k):
    for q in QUERIES:
        status, body = both(servers, lambda s: one(s, req("POST", "/search", {"query": q, "top_k": top_k,
                                                                               **LANES[lane]})))
        assert status == 200 and len(body["results"]) <= top_k


def test_each_lane_is_served_by_its_path(servers):
    """The port's lanes: hot and MMR hot answer the serializer's bytes, the
    judged lane serialize_batch_rr's, the object lane json.dumps."""
    port = servers["port"]
    rows = {}
    for lane, params in LANES.items():
        c = Conn(port.port)
        _, _, body = c.request(req("POST", "/search", {"query": QUERIES[0], "top_k": 3, **params}))
        c.close()
        rows[lane] = body
    assert rows["hot"].startswith(b'{"results": [{"text":"')  # the serializer's compact fragments
    assert rows["mmr"].startswith(b'{"results": [{"text":"')
    assert rows["judged"].startswith(b'{"results": [{"text":"') and b'"reranker_score":' in rows["judged"]
    assert rows["object"].startswith(b'{"results": [{"text": "')  # json.dumps
    assert port.ctx.batcher.judged_fallbacks == 0 and port.engine.rerank_fallbacks == 0


BAD_BODIES = [
    b"{not json", b"[1, 2]", b"", b"\xff\xfe", b'"a string"',
    {"query": "x", "top_k": "many"}, {"query": "x", "top_k": None}, {"query": "x", "diversity_factor": "x"},
    b'{"query": "x", "diversity_factor": NaN}', b'{"query": "x", "diversity_factor": Infinity}',
    {"query": "x", "use_reranker": "yes"}, {"query": "x", "use_reranker": 1},
    {"query": "x", "rejection_threshold": "high"}, b'{"query": "x", "rejection_threshold": -Infinity}',
    {"query": "x", "rejection_cosine_floor": [1]}, {"query": "x", "rejection_query_floor": {}},
    {"query": "x", "rejection_unseen_mass": "?"}, b'{"query": "x", "rejection_unseen_cos": NaN}',
    {"query": "x", "rejection_unseen_judge": "0.2x"},
]


@pytest.mark.parametrize("body", BAD_BODIES, ids=range(len(BAD_BODIES)))
def test_bad_search_bodies_equal_jax(servers, body):
    status, text = both(servers, lambda s: one(s, req("POST", "/search", body)))
    assert status == 400 and text.startswith("invalid ")


def test_search_edge_values_equal_jax(servers):
    for body in ({"query": "galaxies", "top_k": 500, "diversity_factor": 0, "use_reranker": False},
                 {"query": "galaxies", "top_k": 0, "use_reranker": False},
                 {"query": "galaxies", "diversity_factor": 7, "use_reranker": False},
                 {"query": "galaxies", "weights": {"embedding": 1.0, "lexical": 0.0}, "use_reranker": False,
                  "diversity_factor": 0},
                 {"query": "galaxies", "rejection_threshold": 0.9, "use_reranker": False, "diversity_factor": 0}):
        both(servers, lambda s: one(s, req("POST", "/search", body)))
    # an empty query scores every chunk 0: the same rows, in an order that
    # ties leave open (ROADMAP C5), so compared as sorted rows
    body = {"query": "", "top_k": 4, "diversity_factor": 0, "use_reranker": False}
    both(servers, lambda s: sorted(json.dumps(r, sort_keys=True)
                                   for r in one(s, req("POST", "/search", body))[1]["results"]))


# ----------------------------------------------------------- transport ----


def test_pipelined_requests_answer_in_order_equal_jax(servers):
    """Five requests in one write; the slow ones (searches) first. The
    answers come back in request order on both servers."""
    batch = (req("POST", "/search", {"query": QUERIES[1], "top_k": 2, **LANES["judged"]})
             + req("GET", "/healthz")
             + req("POST", "/search", {"query": QUERIES[2], "top_k": 2, **LANES["hot"]})
             + req("GET", "/nope")
             + req("GET", "/stats"))

    def run(s):
        c = Conn(s.port)
        c.send(batch)
        out = [parsed(*c.read()) for _ in range(5)]
        c.close()
        return out

    out = both(servers, run)
    assert [o[0] for o in out] == [200, 200, 200, 404, 200]


def test_keep_alive_and_connection_close_equal_jax(servers):
    def run(s):
        c = Conn(s.port)
        out = [parsed(*c.request(req("GET", "/healthz"))) for _ in range(3)]
        out.append(parsed(*c.request(req("POST", "/search", {"query": "tomato", "top_k": 1, **LANES["hot"]}))))
        out.append(parsed(*c.request(req("GET", "/stats", headers={"Connection": "close"}))))
        out.append(c.closed_by_peer())
        c.close()
        c = Conn(s.port)  # HTTP/1.0 without keep-alive: answered, then closed
        c.send(b"GET /healthz HTTP/1.0\r\n\r\n")
        out.append(parsed(*c.read()))
        out.append(c.closed_by_peer())
        c.close()
        return out

    out = both(servers, run)
    assert out[5] is True and out[7] is True


def test_expect_100_continue_equal_jax(servers):
    body = json.dumps({"query": "galaxies " * 200, "top_k": 2, **LANES["hot"]}).encode()

    def run(s):
        c = Conn(s.port, timeout=10)
        try:
            c.send(req("POST", "/search", body, {"Expect": "100-continue"})[:-len(body)])
            # the interim answer arrives before the body is sent
            interim = (c.f.readline(), c.f.readline())
            c.send(body)
            return interim, parsed(*c.read())
        finally:
            c.close()

    interim, (status, res) = both(servers, run)
    assert interim == (b"HTTP/1.1 100 Continue\r\n", b"\r\n")
    assert status == 200 and res["results"]


def test_chunked_body_equal_jax(servers):
    body = json.dumps({"query": "signal blocks trains", "top_k": 3, **LANES["hot"]}).encode()
    parts = [body[:7], body[7:30], body[30:]]
    chunked = b"".join(b"%x;ext=1\r\n%s\r\n" % (len(p), p) for p in parts) + b"0\r\nX-Trailer: t\r\n\r\n"

    def run(s):
        c = Conn(s.port)
        c.send(req("POST", "/search", b"", {"Transfer-Encoding": "chunked"}) + chunked)
        out = parsed(*c.read())
        c.close()
        return out

    status, res = both(servers, run)
    assert status == 200 and res["results"][0]["document"] == "rails.pdf"


def test_oversized_header_is_refused_equal_jax(servers):
    big = req("GET", "/healthz", headers={"X-Big": "a" * 40000})
    (status,) = both(servers, lambda s: (one(s, big)[0],))  # the texts differ (aiohttp's own)
    assert status == 400


def test_port_refuses_oversized_body_and_closes(servers):
    c = Conn(servers["port"].port)
    c.send(b"POST /search HTTP/1.1\r\nHost: t\r\nContent-Length: %d\r\n\r\n{" % (MAX_BODY + 1))
    status, _, _ = c.read()
    assert status == 413 and c.closed_by_peer()
    c.close()


# ------------------------------------------------------------------ MCP ----


def mcp(method, params=None, rid=1, headers=None):
    payload = {"jsonrpc": "2.0", "id": rid, "method": method}
    if params is not None:
        payload["params"] = params
    return req("POST", "/mcp", payload, headers)


@pytest.mark.parametrize("data", [
    req("POST", "/mcp", b"{oops"), req("POST", "/mcp", b"[{\"jsonrpc\": \"2.0\", \"id\": 1, \"method\": \"ping\"}]"),
    req("POST", "/mcp", b"\"text\""), req("POST", "/mcp", b""),
    req("POST", "/mcp", {"jsonrpc": "2.0", "method": "notifications/initialized"}),
    mcp("ping"), mcp("tools/list"), mcp("no/such/method"), mcp("tools/call", {"name": "nope"}),
    mcp("tools/call", {"name": "search_documents", "arguments": {"query": "galaxies", "top_k": 2}}),
    mcp("tools/call", {"name": "search_documents", "arguments": {"query": "tomato", "top_k": 3,
                                                                  "diversity_factor": 0, "use_reranker": False}}),
    mcp("tools/call", {"name": "search_documents", "arguments": {"query": "tomato", "top_k": "x"}}),
    mcp("tools/call", {"name": "search_documents", "arguments": {"query": "tomato", "use_reranker": "no"}}),
    mcp("tools/call", {"name": "list_documents"}), mcp("tools/call", {"name": "get_stats"}),
    mcp("tools/call", {"name": "get_job_status", "arguments": {"job_id": "missing"}}),
    mcp("tools/call", {"name": "search_documents", "arguments": {"query": "rails"}},
        headers={"Accept": "text/event-stream"}),
    mcp("tools/list", headers={"Accept": "application/json, text/event-stream"}),
    mcp("tools/list", headers={"Mcp-Session-Id": "0" * 32}),
    req("DELETE", "/mcp"), req("DELETE", "/mcp", headers={"Mcp-Session-Id": "f" * 32}),
    req("GET", "/mcp", headers={"Accept": "text/event-stream"}),
    req("GET", "/mcp", headers={"Accept": "text/event-stream", "Mcp-Session-Id": "e" * 32}),
], ids=range(23))
def test_mcp_answers_equal_jax(servers, data):
    both(servers, lambda s: one(s, data))


def test_mcp_session_tools_and_job_status_equal_jax(servers):
    def run(s):
        c = Conn(s.port)
        status, headers, body = c.request(mcp("initialize", {"protocolVersion": "2025-03-26"}))
        sid = headers["mcp-session-id"]
        out = [parsed(status, headers, body)]
        h = {"Mcp-Session-Id": sid}
        for m, p in (("tools/list", None), ("tools/call", {"name": "get_stats"}),
                     ("tools/call", {"name": "get_job_status", "arguments": {"job_id": s.job_id}}),
                     ("tools/call", {"name": "calibrate_reranker", "arguments": {"query": "galaxies",
                                                                                 "sample_size": 3}})):
            status, headers, body = c.request(mcp(m, p, headers=h))
            assert headers["mcp-session-id"] == sid
            out.append(parsed(status, headers, body))
        out.append(parsed(*c.request(req("DELETE", "/mcp", headers=h))))
        out.append(parsed(*c.request(req("DELETE", "/mcp", headers=h))))
        out.append(parsed(*c.request(mcp("tools/list", headers=h))))
        c.close()
        return out

    out = run(servers["port"])
    ref = run(servers["jax"])
    # calibration reports host latencies: compare its shape, not its numbers
    cal_p, cal_j = out[4][1]["result"]["content"][0]["text"], ref[4][1]["result"]["content"][0]["text"]
    assert re.sub(r"[0-9.]+", "N", cal_p) == re.sub(r"[0-9.]+", "N", cal_j)
    for o in (out, ref):
        o[4] = None
    assert_same(out, ref)
    assert [o[0] for o in out if o] == [200, 200, 200, 200, 200, 404, 404]


# ------------------------------------------------------------------ SSE ----


def _events(conn, want, timeout=60):
    """Read SSE chunks until `want(events)` holds; the parsed events."""
    events, buf = [], b""
    deadline = time.monotonic() + timeout
    while not want(events):
        assert time.monotonic() < deadline, events
        chunk = conn.chunk()
        if chunk is None:
            events.append(None)
            break
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            fields = dict(ln.split(": ", 1) for ln in frame.decode().splitlines() if ": " in ln and ln[0] != ":")
            events.append((int(fields["id"]), json.loads(fields["data"])) if "data" in fields else "keep-alive")
    return events


def test_sse_job_progress_resume_and_delete_equal_jax(servers):
    """A session's GET stream receives a reindex job's progress; a second
    stream resumes from Last-Event-ID; DELETE ends the streams."""

    def run(s):
        conns = [Conn(s.port) for _ in range(3)]
        c, stream, again = conns
        try:
            _, headers, _ = c.request(mcp("initialize"))
            sid = headers["mcp-session-id"]
            stream.send(req("GET", "/mcp", headers={"Accept": "text/event-stream", "Mcp-Session-Id": sid}))
            status, sh = stream.head()
            _, _, body = c.request(req("POST", "/reindex"))
            job_id = json.loads(body)["job_id"]

            def mine(ev):  # this job's events (an earlier job's last one may still arrive)
                return [e for e in ev if isinstance(e, tuple) and e[1]["params"]["data"]["job_id"] == job_id]

            events = _events(stream, lambda ev: any(e[1]["params"]["data"]["status"] == "completed"
                                                     for e in mine(ev)))
            ids = [e[0] for e in events]
            assert ids == list(range(1, len(ids) + 1))
            # a second stream resumes after the first event
            again.send(req("GET", "/mcp", headers={"Accept": "text/event-stream", "Mcp-Session-Id": sid,
                                                   "Last-Event-ID": "1"}))
            again.head()
            replay = _events(again, lambda ev: len(ev) >= len(ids) - 1)
            assert [e[0] for e in replay][:len(ids) - 1] == ids[1:]
            listeners = len(s.hub().get(sid)._listeners)
            assert parsed(*c.request(req("DELETE", "/mcp", headers={"Mcp-Session-Id": sid}))) == (200, "")
            ended = [_events(x, lambda ev: False)[-1] for x in (stream, again)]
        finally:
            for x in conns:
                x.close()
        # how many progress events a job gives depends on the watcher's
        # 0.4 s polls, so only the last one is compared across servers
        last = mine(events)[-1][1]["params"]["data"]
        return status, sh["content-type"], sh.get("cache-control"), listeners, ended, norm(last)

    out = both(servers, run)
    assert out[0] == 200 and out[3] == 2 and out[4] == [None, None]
    assert out[5]["status"] == "completed" and out[5]["progress"] == out[5]["total"] == len(DOCS)


def test_sse_client_disconnect_does_not_leak_its_subscription(servers):
    """A client that drops its GET stream leaves no listener behind: the
    port closes the stream when the connection is lost. (The JAX server
    drops it at its next 15 s keep-alive write, so only the port is
    timed here.)"""
    s = servers["port"]
    c = Conn(s.port)
    _, headers, _ = c.request(mcp("initialize"))
    sid = headers["mcp-session-id"]
    session = s.hub().get(sid)
    for _ in range(3):
        stream = Conn(s.port)
        stream.send(req("GET", "/mcp", headers={"Accept": "text/event-stream", "Mcp-Session-Id": sid}))
        assert stream.head()[0] == 200
        deadline = time.monotonic() + 10
        while not session._listeners and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(session._listeners) == 1
        stream.sock.shutdown(socket.SHUT_RDWR)
        stream.close()
        while session._listeners and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not session._listeners
    c.request(req("DELETE", "/mcp", headers={"Mcp-Session-Id": sid}))
    c.close()


def test_sse_keepalive_comment(servers, monkeypatch):
    """An idle stream gets `: keep-alive` comments (every 15 s; shortened
    here on the port's side only)."""
    from rust_local_rag_tpu_torch.server import http_api

    monkeypatch.setattr(http_api, "KEEPALIVE_S", 0.05)
    s = servers["port"]
    c = Conn(s.port)
    _, headers, _ = c.request(mcp("initialize"))
    stream = Conn(s.port)
    stream.send(req("GET", "/mcp", headers={"Accept": "text/event-stream",
                                           "Mcp-Session-Id": headers["mcp-session-id"]}))
    stream.head()
    assert stream.chunk() == b": keep-alive\n\n"
    c.request(req("DELETE", "/mcp", headers={"Mcp-Session-Id": headers["mcp-session-id"]}))
    assert _events(stream, lambda ev: False)[-1] is None
    for x in (c, stream):
        x.close()


def test_reindex_conflict_answers_409_like_jax(servers, monkeypatch):
    """While a job is active a second POST /reindex is refused (409)."""
    outs = []
    for name in ("jax", "port"):
        s = servers[name]
        gate = threading.Event()
        real = s.engine.add_document

        def slow_add(filename, data, batch_callback=None, _real=real, _gate=gate):
            _gate.wait(30)
            return _real(filename, data, batch_callback=batch_callback)

        monkeypatch.setattr(s.engine, "add_document", slow_add)
        c = Conn(s.port)
        try:
            status, _, body = c.request(req("POST", "/reindex"))
            second = parsed(*c.request(req("POST", "/reindex")))
            _, active = parsed(*c.request(req("GET", "/jobs/active")))
        finally:
            gate.set()
            c.close()
        wait_job(s, json.loads(body)["job_id"])
        monkeypatch.setattr(s.engine, "add_document", real)
        outs.append((status, second, active["status"] in ("pending", "inprogress")))
    assert outs[0] == outs[1] == (200, (409, "A reindex job is already in progress"), True)


def test_watchdog_escalates_when_the_supervisor_dies(tmp_path, monkeypatch):
    """If the worker supervisor's thread dies, the server shuts down (the
    escalation hook fires), as the JAX server's watchdog does."""
    monkeypatch.setenv("RAG_TPU_WATCHDOG_INTERVAL_S", "0.05")
    docs = tmp_path / "documents"
    docs.mkdir()
    s = _PortServer(tmp_path, docs)
    fired = threading.Event()
    s.app.watchdog_escalate = fired.set
    s.start()
    live = s.sup._supervisor
    try:
        assert not fired.wait(0.3)  # a live supervisor: quiet
        s.sup._supervisor = threading.Thread(target=lambda: None)  # one that is not alive
        assert fired.wait(10)
    finally:
        s.sup._supervisor = live
        s.stop()


def test_executor_is_sized_for_the_batcher(tmp_path, monkeypatch):
    monkeypatch.setenv("RAG_TPU_BATCH_MAX", "40")
    docs = tmp_path / "documents"
    docs.mkdir()
    s = _PortServer(tmp_path, docs)
    s.start()
    try:
        assert s.app._executor._max_workers == 104
    finally:
        s.stop()
    assert os.listdir(docs) == []
