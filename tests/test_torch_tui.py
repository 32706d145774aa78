"""The port's terminal client (rust_local_rag_tpu_torch/tui/) against the
JAX package's (rust_local_rag_tpu/tui/) on the CPU.

* tests/test_tui.py's 24 cases, each run on both packages;
* both ApiClients (the port's on http.client, the JAX one on requests)
  against one in-process port server (build_runtime(device="cpu"), the
  hermetic encoder and reranker): equal answers for every method, a
  reindex pushed over watch_jobs to both, and the same errors from a stub
  server (409, 500, a dead port); keep-alive: one connection for many
  requests, a fresh one when the server closed the idle one;
* the Controller headless against the port server in both packages;
* ui.draw on a recording screen: the same calls from both packages in
  every mode;
* `python -m rust_local_rag_tpu_torch.tui` in a pseudo-terminal against
  the port server: it draws, searches as the query is typed and quits on
  Esc with exit code 0.
"""

import curses
import http.server
import json
import os
import pty
import select
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import jax
import pytest
import torch

from rust_local_rag_tpu.models import checkpoint as j_checkpoint
from rust_local_rag_tpu.models import discovery as j_discovery
from rust_local_rag_tpu.models import encoder as j_encoder
from rust_local_rag_tpu.tui import api as j_api
from rust_local_rag_tpu.tui import app as j_app
from rust_local_rag_tpu.tui import main as j_main
from rust_local_rag_tpu.tui import settings as j_settings
from rust_local_rag_tpu.tui import theme as j_theme
from rust_local_rag_tpu.tui import ui as j_ui
from rust_local_rag_tpu_torch.models import checkpoint as t_checkpoint
from rust_local_rag_tpu_torch.models import discovery as t_discovery
from rust_local_rag_tpu_torch.models import encoder as t_encoder
from rust_local_rag_tpu_torch.server import http_api
from rust_local_rag_tpu_torch.server.app import build_runtime, prepare
from rust_local_rag_tpu_torch.server.fastpath import HttpServer
from rust_local_rag_tpu_torch.server.http_api import App
from rust_local_rag_tpu_torch.tui import api as t_api
from rust_local_rag_tpu_torch.tui import app as t_app
from rust_local_rag_tpu_torch.tui import main as t_main
from rust_local_rag_tpu_torch.tui import settings as t_settings
from rust_local_rag_tpu_torch.tui import theme as t_theme
from rust_local_rag_tpu_torch.tui import ui as t_ui
from test_torch_http import QUERIES
from test_torch_server_e2e import HERMETIC, _docs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = dict(vocab_size=32, dim=8, depth=1, heads=2, ffn_dim=16, max_len=8, activation_dtype="float32", out_dim=12)


def _save_mini_jax(path, metadata):
    cfg = j_encoder.EncoderConfig(**MINI)
    params = j_encoder.init_encoder_params(jax.random.PRNGKey(0), cfg)
    j_checkpoint.save_params(params, path, metadata=dict(metadata, encoder_config=cfg.to_json()))


def _save_mini_torch(path, metadata):
    cfg = t_encoder.EncoderConfig(**MINI)
    t_checkpoint.save_params(t_encoder.Encoder(cfg, torch.Generator().manual_seed(0)), path,
                             metadata=dict(metadata, encoder_config=cfg.to_json()))


PKGS = {
    "jax": SimpleNamespace(api=j_api, app=j_app, main=j_main, settings=j_settings, theme=j_theme, ui=j_ui,
                           discovery=j_discovery, save_mini=_save_mini_jax),
    "torch": SimpleNamespace(api=t_api, app=t_app, main=t_main, settings=t_settings, theme=t_theme, ui=t_ui,
                             discovery=t_discovery, save_mini=_save_mini_torch),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _results(pkg, n):
    return [
        pkg.api.TuiSearchResult(
            text=f"text {i}", score=0.9 - i * 0.1, document=f"d{i}.pdf",
            chunk_id=f"c{i}", chunk_index=i, page_number=i + 1,
        )
        for i in range(n)
    ]


# ----- tests/test_tui.py, each case on both packages -----

def test_typing_updates_query(pkg):
    s = pkg.app.AppState()
    for ch in "hello":
        s.update(pkg.app.Msg("char", ch))
    assert s.query == "hello"
    assert s.cursor == 5
    s.update(pkg.app.Msg("backspace"))
    assert s.query == "hell"


def test_stale_search_id_guard(pkg):
    s = pkg.app.AppState()
    sid1 = s.start_search()
    sid2 = s.start_search()
    assert not s.complete_search(sid1, _results(pkg, 3))  # stale
    assert s.results == []
    assert s.complete_search(sid2, _results(pkg, 2))
    assert len(s.results) == 2
    assert not s.searching


def test_fail_search_stale_and_fresh(pkg):
    s = pkg.app.AppState()
    sid = s.start_search()
    assert not s.fail_search(sid - 1, "old error")
    assert s.fail_search(sid, "boom")
    assert "boom" in s.status_line


def test_navigation_bounds(pkg):
    s = pkg.app.AppState()
    s.complete_search(s.start_search(), _results(pkg, 3))
    s.update(pkg.app.Msg("up"))
    assert s.selected == 0
    for _ in range(3):
        s.update(pkg.app.Msg("down"))
    assert s.selected == 2


def test_mode_transitions(pkg):
    Mode, Msg = pkg.app.Mode, pkg.app.Msg
    s = pkg.app.AppState()
    s.complete_search(s.start_search(), _results(pkg, 1))
    s.update(Msg("enter_detail"))
    assert s.mode == Mode.DETAIL
    s.update(Msg("back"))
    assert s.mode == Mode.NORMAL
    s.update(Msg("help"))
    assert s.mode == Mode.HELP
    s.update(Msg("help"))
    assert s.mode == Mode.NORMAL
    s.update(Msg("settings"))
    assert s.mode == Mode.SETTINGS


def test_enter_detail_without_results_stays_normal(pkg):
    s = pkg.app.AppState()
    s.update(pkg.app.Msg("enter_detail"))
    assert s.mode == pkg.app.Mode.NORMAL


def test_job_lifecycle_status(pkg):
    s = pkg.app.AppState()
    s.update(pkg.app.Msg("job_update", pkg.api.JobStatus("j1", "inprogress", 1, 3)))
    assert s.reindexing
    s.update(pkg.app.Msg("job_update", pkg.api.JobStatus("j1", "completed", 3, 3)))
    assert not s.reindexing
    assert "completed" in s.status_line


def test_unicode_input(pkg):
    s = pkg.app.AppState()
    s.update(pkg.app.Msg("char", "é"))
    s.update(pkg.app.Msg("char", "漢"))
    assert s.query == "é漢"
    s.update(pkg.app.Msg("backspace"))
    assert s.query == "é"


def test_clear_query_resets(pkg):
    s = pkg.app.AppState()
    s.update(pkg.app.Msg("char", "x"))
    s.complete_search(s.start_search(), _results(pkg, 2))
    s.update(pkg.app.Msg("clear"))
    assert s.query == "" and s.results == [] and s.selected == 0


def test_validate_weights(pkg):
    validate = pkg.settings.validate
    assert validate("RAG_EMBEDDING_WEIGHT", "0.5") is None
    assert validate("RAG_EMBEDDING_WEIGHT", "1.5") is not None
    assert validate("RAG_EMBEDDING_WEIGHT", "abc") is not None
    assert validate("RAG_EMBEDDING_WEIGHT", "") is None  # clears


def test_validate_bind_and_batch(pkg):
    validate = pkg.settings.validate
    assert validate("MCP_HTTP_BIND", "0.0.0.0:8080") is None
    assert validate("MCP_HTTP_BIND", "nope") is not None
    assert validate("MCP_HTTP_BIND", "host:99999") is not None
    assert validate("EMBEDDING_BATCH_SIZE", "64") is None
    assert validate("EMBEDDING_BATCH_SIZE", "0") is not None


def test_settings_env_roundtrip_preserves_comments(pkg, tmp_path):
    env = tmp_path / ".env"
    env.write_text(
        "# my config\n"
        "UNKNOWN_KEY=keepme\n"
        "RAG_EMBEDDING_WEIGHT=0.6\n"
        "\n"
        "# trailing comment\n"
    )
    s = pkg.settings.Settings.load(str(env))
    assert s.get("RAG_EMBEDDING_WEIGHT") == "0.6"
    assert s.set("RAG_EMBEDDING_WEIGHT", "0.8") is None
    assert s.set("EMBEDDING_BATCH_SIZE", "64") is None
    s.save()

    text = env.read_text()
    assert "# my config" in text
    assert "UNKNOWN_KEY=keepme" in text
    assert "RAG_EMBEDDING_WEIGHT=0.8" in text
    assert "EMBEDDING_BATCH_SIZE=64" in text
    assert "# trailing comment" in text
    assert pkg.settings.Settings.load(str(env)).get("RAG_EMBEDDING_WEIGHT") == "0.8"


def test_settings_clear_removes_line(pkg, tmp_path):
    env = tmp_path / ".env"
    env.write_text("RAG_LEXICAL_WEIGHT=0.3\n")
    s = pkg.settings.Settings.load(str(env))
    assert s.set("RAG_LEXICAL_WEIGHT", "") is None
    s.save()
    assert "RAG_LEXICAL_WEIGHT" not in env.read_text()


def test_settings_invalid_rejected(pkg, tmp_path):
    s = pkg.settings.Settings.load(str(tmp_path / ".env"))
    assert s.set("RAG_RERANKER_WEIGHT", "2.0") is not None
    assert s.get("RAG_RERANKER_WEIGHT") == ""


def test_settings_rows_cover_all_keys(pkg, tmp_path):
    s = pkg.settings.Settings.load(str(tmp_path / ".env"))
    assert [r[0] for r in s.rows()] == [k for k, _ in pkg.settings.SETTING_KEYS]


def test_theme_cycle(pkg):
    seen = {"default"}
    cur = "default"
    for _ in range(len(pkg.theme.THEMES)):
        cur = pkg.theme.next_theme(cur)
        seen.add(cur)
    assert seen == set(pkg.theme.THEMES)
    assert pkg.theme.get_theme("nonexistent").name == "default"


def test_result_from_json_optional_fields(pkg):
    base = {"text": "t", "score": 0.5, "document": "d.pdf", "chunk_id": "c", "chunk_index": 1, "page_number": 2}
    assert pkg.api.TuiSearchResult.from_json(base).reranker_score is None
    r2 = pkg.api.TuiSearchResult.from_json(dict(base, reranker_score=0.9, yes_logprob=-0.1, no_logprob=-2.3))
    assert r2.reranker_score == 0.9


def test_settings_validation_three_state(pkg, tmp_path):
    validate = pkg.settings.validate
    assert validate("RAG_EMBEDDING_WEIGHT", "0.5") is None
    for bad in ("nan", "inf", "1.5", "abc"):
        assert validate("RAG_EMBEDDING_WEIGHT", bad)[0] == "error"
    assert validate("RAG_TUI_SERVER_URL", "http://localhost:3046") is None
    assert validate("RAG_TUI_SERVER_URL", "localhost:3046")[0] == "error"
    assert validate("RAG_TUI_SERVER_URL", "http://")[0] == "error"
    assert validate("DATA_DIR", str(tmp_path)) is None
    f = tmp_path / "afile"
    f.write_text("x")
    assert validate("DATA_DIR", str(f))[0] == "error"
    lvl, msg = validate("DATA_DIR", str(tmp_path / "nonexistent"))
    assert lvl == "warning" and "created" in msg
    assert validate("ENCODER_WEIGHTS", str(f)) is None
    assert validate("ENCODER_WEIGHTS", str(tmp_path))[0] == "error"
    assert validate("ENCODER_WEIGHTS", str(tmp_path / "nope.st"))[0] == "warning"


def test_settings_set_applies_warnings_rejects_errors(pkg, tmp_path):
    s = pkg.settings.Settings(path=str(tmp_path / ".env"))
    assert s.set("RAG_EMBEDDING_WEIGHT", "2.0")  # rejected
    assert "RAG_EMBEDDING_WEIGHT" not in s.values
    out = s.set("DATA_DIR", str(tmp_path / "newdir"))
    assert out.startswith("warning:")
    assert s.values["DATA_DIR"] == str(tmp_path / "newdir")  # applied


def test_model_discovery_lists_assets_and_hermetic(pkg, monkeypatch, tmp_path):
    monkeypatch.delenv("RAG_TPU_MODELS_DIR", raising=False)
    monkeypatch.delenv("ENCODER_WEIGHTS", raising=False)
    models = pkg.discovery.discover_models()
    assert "hash-encoder" in [m["name"] for m in models["embedding"]]
    rr = [m["name"] for m in models["rerank"]]
    assert "fake-rr" in rr and "" in rr  # disabled mode is offered
    path = str(tmp_path / "mini.safetensors")
    pkg.save_mini(path, {"trained_steps": "7"})
    monkeypatch.setenv("RAG_TPU_MODELS_DIR", str(tmp_path))
    found = [m for m in pkg.discovery.discover_encoder_models() if m["kind"] == "checkpoint" and m["path"] == path]
    assert found and found[0]["detail"] == "1L x 8d -> 12d, 7 steps"


def test_choices_for_key(pkg, monkeypatch):
    monkeypatch.delenv("RAG_TPU_MODELS_DIR", raising=False)
    assert pkg.discovery.choices_for_key("DATA_DIR") is None
    rr = pkg.discovery.choices_for_key("RAG_TPU_RERANK_MODEL")
    assert "fake-rr" in rr and "" in rr
    assert pkg.discovery.choices_for_key("ENCODER_WEIGHTS")[-1] == ""  # explicit clear option


def test_settings_modified_tracking_and_save(pkg, tmp_path):
    env = tmp_path / ".env"
    env.write_text("RAG_EMBEDDING_WEIGHT=0.7\n")
    s = pkg.settings.Settings.load(str(env))
    assert not s.is_modified("RAG_EMBEDDING_WEIGHT")
    s.set("RAG_EMBEDDING_WEIGHT", "0.9")
    assert s.is_modified("RAG_EMBEDDING_WEIGHT")
    s.set("RAG_EMBEDDING_WEIGHT", "0.7")  # back to original -> unmodified
    assert not s.is_modified("RAG_EMBEDDING_WEIGHT")
    s.set("RAG_EMBEDDING_WEIGHT", "0.9")
    s.save()  # mark_saved semantics (settings.rs:98-100)
    assert not s.is_modified("RAG_EMBEDDING_WEIGHT")


def test_settings_requires_restart_flags(pkg):
    s = pkg.settings.Settings()
    assert s.requires_restart("MCP_HTTP_BIND")
    assert s.requires_restart("RAG_EMBEDDING_WEIGHT")  # OnceLock-cached server-side
    assert not s.requires_restart("RAG_TUI_SERVER_URL")  # client-only


def test_settings_edit_cursor_insert_delete(pkg):
    class _Ctl:
        settings = pkg.settings.Settings()

    key = pkg.main._handle_settings_key
    st = pkg.app.AppState()
    st.mode = pkg.app.Mode.SETTINGS
    st.settings_editing = True
    st.settings_edit_buffer = "abc"
    st.settings_cursor = 1
    key(ord("X"), st, _Ctl())  # insert at cursor
    assert st.settings_edit_buffer == "aXbc" and st.settings_cursor == 2
    key(curses.KEY_BACKSPACE, st, _Ctl())  # delete before cursor
    assert st.settings_edit_buffer == "abc" and st.settings_cursor == 1
    key(curses.KEY_DC, st, _Ctl())  # delete AT cursor
    assert st.settings_edit_buffer == "ac" and st.settings_cursor == 1
    key(curses.KEY_HOME, st, _Ctl())
    assert st.settings_cursor == 0
    key(curses.KEY_END, st, _Ctl())
    assert st.settings_cursor == 2
    key(curses.KEY_LEFT, st, _Ctl())
    assert st.settings_cursor == 1
    key(curses.KEY_RIGHT, st, _Ctl())
    assert st.settings_cursor == 2


# ----- both clients against the port's server -----

@pytest.fixture
def server(tmp_path, monkeypatch):
    """The port's runtime over three PDFs, hermetic models, on the CPU;
    SSE keep-alives every 0.2 s so a stopped watcher returns at once."""
    for k, v in HERMETIC.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setattr(http_api, "KEEPALIVE_S", 0.2)
    docs = tmp_path / "documents"
    _docs(docs)
    ctx = build_runtime(str(tmp_path / "data"), str(docs), device="cpu")
    prepare(ctx)
    srv = HttpServer(App(ctx), "127.0.0.1", 0)
    ready = threading.Event()
    thread = threading.Thread(target=srv.run, kwargs={"ready": ready.set}, daemon=True)
    thread.start()
    assert ready.wait(30)
    yield SimpleNamespace(url=f"http://127.0.0.1:{srv.port}", port=srv.port, ctx=ctx)
    ctx.supervisor.stop(timeout=5)
    srv.stop()
    thread.join(timeout=30)
    ctx.batcher.stop()
    assert not thread.is_alive()


def _wait_job(client, job_id, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        job = client.job_status(job_id)
        if job.status in ("completed", "failed"):
            return job
        time.sleep(0.05)
    raise AssertionError(f"job {job_id} did not finish")


def _plain(x):
    """Dataclasses of either package -> comparable dicts."""
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return None if x is None else dict(vars(x))


def _watch(client, events, stop):
    t = threading.Thread(target=client.watch_jobs, args=(events.append, stop.is_set), daemon=True)
    t.start()
    return t


def test_api_clients_equal_against_the_port_server(server):
    jc, tc = j_api.ApiClient(server.url), t_api.ApiClient(server.url)
    assert jc.health() and tc.health()
    assert _plain(tc.stats()) == _plain(jc.stats())
    assert tc.stats().chunks == 0 and tc.active_job() is None and jc.active_job() is None
    assert tc.job_status("no-such-job") is None and jc.job_status("no-such-job") is None

    stop = threading.Event()
    jevents, tevents = [], []
    watchers = [_watch(jc, jevents, stop), _watch(tc, tevents, stop)]
    time.sleep(0.5)  # both SSE streams open before the job starts
    job = tc.start_reindex()
    assert job.status == "pending" and job.progress == 0 and len(job.job_id) > 8
    done = _wait_job(tc, job.job_id)
    assert done.status == "completed" and _plain(jc.job_status(job.job_id)) == _plain(done)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not all(
            any(e.status == "completed" for e in ev) for ev in (jevents, tevents)):
        time.sleep(0.05)
    stop.set()
    for t in watchers:
        t.join(timeout=10)
        assert not t.is_alive()
    assert _plain(tevents) == _plain(jevents)
    assert {e.job_id for e in tevents} == {job.job_id} and tevents[-1].status == "completed"

    stats = tc.stats()
    assert _plain(stats) == _plain(jc.stats()) and stats.chunks > 0
    for q in QUERIES:
        for top_k, diversity in ((10, 0.3), (3, 0.0)):
            got = tc.search(q, top_k=top_k, diversity=diversity)
            assert _plain(got) == _plain(jc.search(q, top_k=top_k, diversity=diversity))
    assert tc.search(QUERIES[0])
    # the sequential requests kept to their keep-alive connections: the
    # first one, and the fresh one that POST /reindex opened
    assert tc._pool.idle_count() == 2
    tc.close()


class _Stub(http.server.BaseHTTPRequestHandler):
    """Canned answers: POST /reindex 409, other POSTs 500, GET /stats 200
    (and then closes the connection when the path asks for it; /stats?slow
    answers after 1 s), other GETs 503. Every request's method and path is
    recorded."""

    protocol_version = "HTTP/1.1"
    connections: list = []
    requests: list = []

    def setup(self):
        super().setup()
        _Stub.connections.append(self.client_address)

    def parse_request(self):
        ok = super().parse_request()
        if ok:
            _Stub.requests.append((self.command, self.path))
        return ok

    def _send(self, status, body: dict, close=False):
        raw = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)
        if close:
            self.close_connection = True

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        if self.path == "/reindex":
            self._send(409, {"error": "busy"})
        else:
            self._send(500, {"error": "boom"})

    def do_GET(self):
        if not self.path.startswith("/stats"):
            self._send(503, {"error": "down"})
            return
        if self.path == "/stats?slow":
            time.sleep(1.0)
        self._send(200, {"documents": 2, "chunks": 5, "status": "ready", "embedding_model": "m"},
                   close=self.path == "/stats?close")

    def log_message(self, *a):
        pass


@pytest.fixture
def stub():
    _Stub.connections, _Stub.requests = [], []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def test_api_client_errors_equal_jax(stub):
    url = f"http://127.0.0.1:{stub.server_address[1]}"
    for c in (j_api.ApiClient(url), t_api.ApiClient(url)):
        with pytest.raises(RuntimeError, match="^A reindex job is already in progress$"):
            c.start_reindex()
    errors = []
    for c in (j_api.ApiClient(url), t_api.ApiClient(url)):
        with pytest.raises(Exception) as e:
            c.search("q")
        errors.append(str(e.value))
    assert errors[0] == errors[1] == f"500 Server Error: Internal Server Error for url: {url}/search"
    errors = []
    for c in (j_api.ApiClient(url), t_api.ApiClient(url)):
        with pytest.raises(Exception) as e:
            c.active_job()
        errors.append(str(e.value))
    assert errors[0] == errors[1] == f"503 Server Error: Service Unavailable for url: {url}/jobs/active"
    dead = f"http://127.0.0.1:{_dead_port()}"
    assert not j_api.ApiClient(dead).health() and not t_api.ApiClient(dead).health()
    with pytest.raises(OSError):
        t_api.ApiClient(dead).stats()


def _dead_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_api_client_keeps_alive_and_reconnects(stub):
    url = f"http://127.0.0.1:{stub.server_address[1]}"
    c = t_api.ApiClient(url)
    for _ in range(5):
        assert c.stats().chunks == 5
    assert len(_Stub.connections) == 1
    # the server closes after this answer; the next request finds the pooled
    # connection dead and goes out once more on a fresh one
    c._checked("GET", "/stats?close", timeout=5)
    assert c.stats().chunks == 5 and len(_Stub.connections) == 2
    # concurrent callers each get a connection of their own
    out = []
    threads = [threading.Thread(target=lambda: out.append(c.stats().chunks)) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert out == [5] * 6 and c._pool.idle_count() <= c._pool.max_idle
    c.close()
    assert c._pool.idle_count() == 0


def test_api_client_never_repeats_a_timeout_or_a_reindex(stub):
    url = f"http://127.0.0.1:{stub.server_address[1]}"
    c = t_api.ApiClient(url)
    assert c.stats().chunks == 5  # a pooled connection from here on
    # a read timeout on a reused connection raises; the request went out once
    with pytest.raises(TimeoutError):
        c._checked("GET", "/stats?slow", timeout=0.3)
    assert _Stub.requests.count(("GET", "/stats?slow")) == 1
    # POST /reindex never takes a pooled connection, so a stale one cannot
    # make it go out twice: one request, one 409
    c._checked("GET", "/stats?close", timeout=5)
    assert c.stats().chunks == 5 and c._pool.idle_count() == 1
    with pytest.raises(RuntimeError, match="already in progress"):
        c.start_reindex()
    assert _Stub.requests.count(("POST", "/reindex")) == 1
    c.close()


def test_eval_client_shares_the_pool(stub):
    """evaluation/client.RAGClient runs on the same keep-alive pool: one
    connection for sequential requests, a fresh one after the server
    closes, and a timeout raised without a second send."""
    from rust_local_rag_tpu_torch.evaluation.client import RAGClient

    url = f"http://127.0.0.1:{stub.server_address[1]}"
    c = RAGClient(url)
    for _ in range(3):
        assert c.get_stats()["chunks"] == 5
    assert len(_Stub.connections) == 1
    c.request_json("GET", "/stats?close")
    assert c.get_stats()["chunks"] == 5 and len(_Stub.connections) == 2
    with pytest.raises(TimeoutError):
        c.request_json("GET", "/stats?slow", timeout=0.3)
    assert _Stub.requests.count(("GET", "/stats?slow")) == 1
    c.close()


def _drive_controller(pkg, url, env_path, query):
    """The Controller as main.run drives it, minus curses: type the query,
    tick and drain messages until its search lands, then reindex until the
    job it started is completed (the server may still push the completion
    of an earlier job)."""
    state = pkg.app.AppState()
    ctl = pkg.main.Controller(pkg.api.ApiClient(url), state, pkg.settings.Settings.load(env_path))
    try:
        for ch in query:
            state.update(pkg.app.Msg("char", ch))
            ctl.schedule_search()
        ctl._pending_at = 0.0  # past the debounce
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and (not state.results or state.searching or state.stats is None):
            ctl.tick()
            while not ctl.msgs.empty():
                state.update(ctl.msgs.get_nowait())
            time.sleep(0.02)
        results = list(state.results)
        ctl.start_reindex()
        started = None  # the job id's prefix in "reindex started: ..."
        while time.monotonic() < deadline and not (
                started and state.job is not None and state.job.job_id.startswith(started)
                and state.job.status == "completed"):
            ctl.tick()
            while not ctl.msgs.empty():
                msg = ctl.msgs.get_nowait()
                state.update(msg)
                if msg.kind == "status" and str(msg.payload).startswith("reindex started: "):
                    started = str(msg.payload)[len("reindex started: "):]
            time.sleep(0.02)
        return results, state
    finally:
        ctl.stop()


def test_controller_headless_equal_jax(server, tmp_path):
    c = t_api.ApiClient(server.url)
    _wait_job(c, c.start_reindex().job_id)
    env = str(tmp_path / ".env")
    got = {name: _drive_controller(PKGS[name], server.url, env, QUERIES[2]) for name in sorted(PKGS)}
    want = c.search(QUERIES[2], top_k=10)
    for name, (results, state) in got.items():
        assert _plain(results) == _plain(want), name
        assert state.status_line == "reindex completed" and state.healthy, name
        assert state.stats.chunks == c.stats().chunks, name


class Screen:
    """Records every call ui.draw makes on curses' stdscr surface."""

    def __init__(self, h=30, w=100):
        self.h, self.w, self.calls = h, w, []

    def getmaxyx(self):
        return self.h, self.w

    def __getattr__(self, name):
        return lambda *a: self.calls.append((name, *a))


def _frames(pkg, tmp_path):
    """One frame of every mode (normal with and without results, detail,
    help, settings, settings while editing) on a recording screen."""
    env = tmp_path / f"{id(pkg)}.env"
    env.write_text("# c\nRAG_EMBEDDING_WEIGHT=0.9\nDATA_DIR=" + str(tmp_path / "missing") + "\n")
    settings = pkg.settings.Settings.load(str(env))
    settings.set("RAG_LEXICAL_WEIGHT", "0.2")
    theme = pkg.theme.get_theme("dark")
    s = pkg.app.AppState()
    frames = []

    def draw():
        scr = Screen()
        pkg.ui.draw(scr, s, settings, theme)
        frames.append(scr.calls)

    draw()
    for ch in "tomato":
        s.update(pkg.app.Msg("char", ch))
    rows = _results(pkg, 3)
    rows[1].section, rows[1].reranker_score, rows[1].yes_logprob, rows[1].no_logprob = "Care", 0.8, -0.2, -1.7
    rows[1].text = "word " * 60
    s.complete_search(s.start_search(), rows)
    s.update(pkg.app.Msg("stats", pkg.api.Stats(3, 7, "ready", "enc", "rr")))
    s.update(pkg.app.Msg("job_update", pkg.api.JobStatus("0123456789ab", "inprogress", 1, 3)))
    draw()
    s.update(pkg.app.Msg("down"))
    s.update(pkg.app.Msg("enter_detail"))
    draw()
    s.update(pkg.app.Msg("back"))
    s.update(pkg.app.Msg("help"))
    draw()
    s.update(pkg.app.Msg("settings"))
    for _ in range(11):  # DATA_DIR's row: a warning marker
        s.update(pkg.app.Msg("down"))
    draw()
    s.settings_selected, s.settings_editing, s.settings_edit_buffer, s.settings_cursor = 7, True, "0.25", 2
    draw()
    return frames


def test_ui_draw_makes_the_same_calls_as_jax(tmp_path):
    got = _frames(PKGS["torch"], tmp_path)
    want = _frames(PKGS["jax"], tmp_path)
    assert len(got) == 6 and got == want
    text = [" ".join(str(c[3]) for c in f if c[0] == "addnstr") for f in got]
    assert "rag-tui" in text[0] and "d0.pdf" in text[1] and "Section: Care" in text[2] and "Keys" in text[3]
    assert "missing ⚠" in text[4] and "directory does not exist" in text[4] and "reindexing 1/3" in text[1]
    # the edit buffer "0.25" with its block cursor on the "2"
    assert [c[3] for c in got[5] if c[0] == "addnstr" and c[1] == 12 and c[2] >= 32] == ["0.", "2", "5"]
    assert ("addnstr", 12, 34, "2", 100 - 34 - 1, curses.A_REVERSE) in got[5]


def _read_until(fd, needle: bytes, timeout: float) -> bytes:
    out = b""
    deadline = time.monotonic() + timeout
    while needle not in out and time.monotonic() < deadline:
        r, _, _ = select.select([fd], [], [], 0.2)
        if r:
            try:
                out += os.read(fd, 65536)
            except OSError:
                break
    return out


def test_python_m_tui_in_a_terminal(server, tmp_path):
    """`python -m rust_local_rag_tpu_torch.tui` under a pseudo-terminal:
    the header draws, a typed query's first result shows up, Esc quits
    with exit code 0."""
    c = t_api.ApiClient(server.url)
    _wait_job(c, c.start_reindex().job_id)
    doc = c.search(QUERIES[1])[0].document
    master, slave = pty.openpty()
    env = dict(os.environ, TERM="xterm", RAG_TUI_SERVER_URL=server.url, RAG_TUI_ENV_PATH=str(tmp_path / ".env"),
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p), LINES="30",
               COLUMNS="100")
    proc = subprocess.Popen([sys.executable, "-m", "rust_local_rag_tpu_torch.tui"], stdin=slave, stdout=slave,
                            stderr=slave, env=env, cwd=str(tmp_path), close_fds=True)
    os.close(slave)
    try:
        assert b"rag-tui" in _read_until(master, b"rag-tui", 60)
        os.write(master, QUERIES[1].encode())
        assert doc.encode() in _read_until(master, doc.encode(), 60)
        os.write(master, b"\x1b")
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        os.close(master)
