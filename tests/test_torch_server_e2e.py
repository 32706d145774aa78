"""The port's server end to end: build_runtime(device="cpu") in hermetic
mode (RAG_TPU_FAKE_ENCODER, RAG_TPU_FAKE_RERANKER) served over HTTP and
MCP beside the JAX runtime built from the same environment, driven as a
client would (http.client, keep-alive); and `python -m
rust_local_rag_tpu_torch` as a subprocess (RAG_TPU_PLATFORM=cpu): /readyz,
a reindex, one /search, and exit 0 on SIGTERM after the graceful flush.

Answers are compared as in tests/test_torch_http.py: the same status and
parsed body, ids normalised, scores within 1e-6 (ROADMAP C5 and the
serializer's 7 fractional digits)."""

import asyncio
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

import pdfgen
from rust_local_rag_tpu.engine import RagEngine as JEngine
from rust_local_rag_tpu.jobs import JobManager as JManager
from rust_local_rag_tpu.jobs import WorkerSupervisor as JSupervisor
from rust_local_rag_tpu.server.http_api import AppContext as JContext
from rust_local_rag_tpu.server.http_api import build_app as j_build_app
from rust_local_rag_tpu.utils.rwlock import RwLock as JLock
from rust_local_rag_tpu_torch.server.app import build_runtime, prepare
from rust_local_rag_tpu_torch.server.fastpath import HttpServer
from rust_local_rag_tpu_torch.server.formatting import format_search_results
from rust_local_rag_tpu_torch.server.http_api import App
from test_torch_http import DOCS, LANES, QUERIES, _free_port, assert_same, norm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERMETIC = {
    "RAG_TPU_FAKE_ENCODER": "1",
    "RAG_TPU_FAKE_ENCODER_DIM": "128",
    "RAG_TPU_EMBEDDING_MODEL": "e2e-model",
    "RAG_TPU_RERANK_MODEL": "fake-rr",
    "RAG_TPU_FAKE_RERANKER": "1",
}


class Client:
    """A keep-alive http.client connection."""

    def __init__(self, port):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)

    def call(self, method, path, body=None, headers=None):
        data = None if body is None else json.dumps(body).encode()
        h = {"Content-Type": "application/json"} if data is not None else {}
        self.conn.request(method, path, body=data, headers={**h, **(headers or {})})
        r = self.conn.getresponse()
        raw = r.read()
        ctype = r.getheader("Content-Type", "")
        return r.status, dict(r.getheaders()), (json.loads(raw) if "json" in ctype else raw.decode())

    def wait_job(self, job_id, timeout=120):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            _, _, job = self.call("GET", f"/jobs/{job_id}")
            if job["status"] in ("completed", "failed"):
                return job
            time.sleep(0.05)
        raise AssertionError("reindex did not finish")

    def close(self):
        self.conn.close()


def _docs(path):
    path.mkdir()
    for name, pages in DOCS.items():
        (path / name).write_bytes(pdfgen.make_pdf(pages))


@pytest.fixture
def runtimes(tmp_path, monkeypatch):
    """The port's runtime and the JAX one, each over its own data dir and
    the same documents, both serving."""
    for k, v in HERMETIC.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("LOG_DIR", str(tmp_path / "logs"))
    docs = tmp_path / "documents"
    _docs(docs)

    ctx = build_runtime(str(tmp_path / "port"), str(docs), device="cpu")
    prepare(ctx)
    server = HttpServer(App(ctx), "127.0.0.1", 0)
    ready = threading.Event()
    thread = threading.Thread(target=server.run, kwargs={"ready": ready.set}, daemon=True)
    thread.start()
    assert ready.wait(30)

    from aiohttp import web

    from rust_local_rag_tpu.server.fastpath import FastPathProtocol

    (tmp_path / "jax").mkdir()
    jengine = JEngine.create(str(tmp_path / "jax"))
    jlock, jm = JLock(), JManager(str(tmp_path / "jax" / "jobs.db"))
    jsup = JSupervisor(jm, jengine, jlock, log_dir=str(tmp_path / "jlogs"))
    jctx = JContext(jengine, jlock, jm, jsup, str(docs))
    jsup.start()
    japp = j_build_app(jctx)
    jport = _free_port()
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(japp)
    started = threading.Event()
    servers = []

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        servers.append(loop.run_until_complete(loop.create_server(
            lambda: FastPathProtocol(runner.server, jctx, loop), "127.0.0.1", jport)))
        started.set()
        loop.run_forever()
        loop.close()

    jthread = threading.Thread(target=run, daemon=True)
    jthread.start()
    assert started.wait(30)
    yield {"port": (server.port, ctx), "jax": (jport, jctx)}
    ctx.supervisor.stop(timeout=5)
    server.stop()
    thread.join(timeout=30)
    ctx.batcher.stop()
    jsup.stop(timeout=5)

    async def close():
        servers[0].close()
        await runner.cleanup()

    asyncio.run_coroutine_threadsafe(close(), loop).result(30)
    loop.call_soon_threadsafe(loop.stop)
    jthread.join(timeout=10)
    jctx.batcher.stop()
    assert not thread.is_alive()


def test_build_runtime_serves_every_route_like_jax(runtimes):
    def drive(port):
        c = Client(port)
        out = {}
        out["healthz"] = c.call("GET", "/healthz")[0]
        out["readyz"] = c.call("GET", "/readyz")[0]
        out["stats_before"] = c.call("GET", "/stats")[2]
        status, _, body = c.call("POST", "/reindex")
        out["reindex"] = status
        out["job"] = norm(c.wait_job(body["job_id"]))
        out["active"] = c.call("GET", "/jobs/active")[2]
        out["stats"] = c.call("GET", "/stats")[2]
        for lane, params in LANES.items():
            out[lane] = [norm(c.call("POST", "/search", {"query": q, "top_k": 3, **params})[2]) for q in QUERIES]
        status, headers, init = c.call("POST", "/mcp", {"jsonrpc": "2.0", "id": 1, "method": "initialize"})
        h = {"Mcp-Session-Id": headers["Mcp-Session-Id"]}
        out["initialize"] = init
        out["tools"] = c.call("POST", "/mcp", {"jsonrpc": "2.0", "id": 2, "method": "tools/list"}, h)[2]
        out["mcp_search"] = norm(c.call("POST", "/mcp", {
            "jsonrpc": "2.0", "id": 3, "method": "tools/call",
            "params": {"name": "search_documents", "arguments": {"query": QUERIES[1], "top_k": 3}}}, h)[2])
        out["mcp_stats"] = c.call("POST", "/mcp", {"jsonrpc": "2.0", "id": 4, "method": "tools/call",
                                                   "params": {"name": "get_stats"}}, h)[2]
        out["list"] = c.call("POST", "/mcp", {"jsonrpc": "2.0", "id": 5, "method": "tools/call",
                                              "params": {"name": "list_documents"}}, h)[2]
        out["delete"] = c.call("DELETE", "/mcp", headers=h)[0]
        c.close()
        return out

    port_out, jax_out = drive(runtimes["port"][0]), drive(runtimes["jax"][0])
    assert_same(port_out, jax_out)
    assert port_out["stats"]["chunks"] == len(DOCS) and port_out["stats"]["embedding_model"] == "e2e-model"
    assert port_out["stats_before"]["chunks"] == 0 and port_out["job"]["status"] == "completed"
    assert all(r["results"] for r in port_out["hot"][:4])
    # MCP's text is format_search_results of the batcher's own answer
    ctx = runtimes["port"][1]
    res = ctx.search(QUERIES[1], 3, 0.3, None)
    want = f"Found {len(res)} results for '{QUERIES[1]}':\n\n{format_search_results(res)}"
    assert port_out["mcp_search"]["result"]["content"][0]["text"] == norm(want)


def test_python_m_serves_then_exits_0_on_sigterm(tmp_path):
    """`python -m rust_local_rag_tpu_torch` with RAG_TPU_PLATFORM=cpu and
    the hermetic models: ready, reindexes, searches, and on SIGTERM
    flushes and exits 0."""
    docs = tmp_path / "documents"
    _docs(docs)
    port = _free_port()
    env = dict(os.environ, **HERMETIC, RAG_TPU_PLATFORM="cpu", DATA_DIR=str(tmp_path / "data"),
               DOCUMENTS_DIR=str(docs), LOG_DIR=str(tmp_path / "logs"), MCP_HTTP_BIND=f"127.0.0.1:{port}",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "rust_local_rag_tpu_torch"], env=env, cwd=str(tmp_path),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        status = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                c = Client(port)
                status = c.call("GET", "/readyz")[0]
                break
            except OSError:
                time.sleep(0.2)
        assert status == 200, proc.stderr.read() if proc.poll() is not None else "not ready"
        _, _, body = c.call("POST", "/reindex")
        assert c.wait_job(body["job_id"])["status"] == "completed"
        status, _, res = c.call("POST", "/search", {"query": QUERIES[3], "top_k": 2, **LANES["hot"]})
        assert status == 200 and res["results"][0]["document"] == "rails.pdf"
        c.close()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with open(tmp_path / "logs" / "rust-local-rag-tpu.log", encoding="utf-8") as f:
        log = [json.loads(line)["message"] for line in f]
    assert "RAG state successfully saved to disk" in log and log[-1] == "MCP server shut down gracefully"
    assert os.path.exists(tmp_path / "data" / "jobs.db")


ENV_CASES = [
    {},
    {"DATA_DIR": "/d", "DOCUMENTS_DIR": "/docs", "LOG_DIR": "/l", "LOG_LEVEL": "debug", "LOG_MAX_MB": "9",
     "MCP_HTTP_BIND": "0.0.0.0:9", "MCP_HTTP_ENDPOINT": "/rpc", "RAG_TPU_EMBEDDING_MODEL": "m1"},
    {"LOG_MAX_MB": "lots", "OLLAMA_EMBEDDING_MODEL": "ollama-m", "RAG_TPU_RERANK_MODEL": "",
     "OLLAMA_RERANK_MODEL": "ollama-rr"},
]


@pytest.mark.parametrize("env", ENV_CASES, ids=range(len(ENV_CASES)))
def test_config_getters_like_jax(env, monkeypatch):
    from rust_local_rag_tpu import config as jcfg
    from rust_local_rag_tpu_torch import config as tcfg

    for k in ("DATA_DIR", "DOCUMENTS_DIR", "LOG_DIR", "LOG_LEVEL", "LOG_MAX_MB", "MCP_HTTP_BIND",
              "MCP_HTTP_ENDPOINT", "RAG_TPU_EMBEDDING_MODEL", "OLLAMA_EMBEDDING_MODEL", "RAG_TPU_RERANK_MODEL",
              "OLLAMA_RERANK_MODEL", "PROMPTS_DIR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for name in ("get_data_dir", "get_documents_dir", "get_log_dir", "get_log_level", "get_log_max_mb",
                 "get_embedding_model", "get_rerank_model", "get_mcp_http_bind", "get_mcp_http_endpoint",
                 "get_prompts_dir"):
        assert getattr(tcfg, name)() == getattr(jcfg, name)(), name
    for d in (None, {}, {"embedding": 0.2, "reranker": "x"}, {"initial": 0.5, "other": 1}):
        t, j = tcfg.QueryWeights.from_dict(d), jcfg.QueryWeights.from_dict(d)
        assert [getattr(t, k) for k in t.__slots__] == [getattr(j, k) for k in j.__slots__]
