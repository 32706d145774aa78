"""The port's profiling tools (rust_local_rag_tpu_torch/utils/profiling.py):
StepTimer's statistics against the JAX package's on the same seeded
samples (equal: the same Python over the same floats); device_trace on the
CPU (a torch.profiler window written as a Chrome trace); summarize over
hand-made device intervals; and RAG_TPU_PROFILE_PORT: the capture
listener that server/app.prepare starts, asked over HTTP for a trace of a
live port server on the CPU while it answers searches."""

import http.client
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from rust_local_rag_tpu.utils import profiling as jprof
from rust_local_rag_tpu_torch.server.app import build_runtime, prepare
from rust_local_rag_tpu_torch.server.fastpath import HttpServer
from rust_local_rag_tpu_torch.server.http_api import App
from rust_local_rag_tpu_torch.utils import profiling as prof
from test_torch_server_e2e import HERMETIC, Client, _docs


@pytest.mark.parametrize("n", [1, 2, 100])
@pytest.mark.parametrize("seed", [0, 1])
def test_step_timer_equals_jax(n, seed):
    samples = np.random.default_rng(seed).lognormal(1.0, 0.8, size=n).tolist()
    a, b = prof.StepTimer(), jprof.StepTimer()
    for ms in samples:
        a.record_ms(ms)
        b.record_ms(ms)
    sa, sb = a.stats(), b.stats()
    assert vars(sa) == vars(sb)
    data = sorted(samples)
    assert sa.p99_ms == data[min(round(0.99 * (n - 1)), n - 1)] and sa.median_ms == data[n // 2]


def test_step_timer_context_and_empty():
    t, j = prof.StepTimer(), jprof.StepTimer()
    with pytest.raises(ValueError, match="no samples"):
        t.stats()
    with pytest.raises(ValueError, match="no samples"):
        j.stats()
    with t:
        time.sleep(0.002)
    s = t.stats()
    assert s.sample_size == 1 and s.max_ms >= 2.0


def test_device_trace_on_the_cpu_writes_a_trace(tmp_path):
    a = torch.randn(64, 64)
    with prof.device_trace(str(tmp_path / "t")) as trace:
        for _ in range(3):
            a = a @ a
    assert os.path.dirname(trace.path) == str(tmp_path / "t") and os.path.getsize(trace.path) > 0
    names = [e.get("name") for e in trace.events if e.get("cat") == "cpu_op"]
    assert names.count("aten::mm") == 3
    s = prof.summarize(trace.events)
    assert s["device_ops"] == 0 and s["device_busy_share"] == 0.0 and s["window_us"] > 0


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_summarize_busy_share_top_ops_and_gaps():
    events = [
        ev("kernel", "k_a", 10, 10), ev("kernel", "k_a", 15, 10),  # overlapping: 10-25
        ev("gpu_memcpy", "Memcpy HtoD", 40, 5),                    # 40-45
        ev("kernel", "k_b", 90, 10),                               # 90-100
        ev("cpu_op", "aten::outer", 0, 100), ev("cpu_op", "aten::inner", 50, 20, tid=7),
        ev("user_annotation", "not in the window", 200, 1),
    ]
    s = prof.summarize(events, window=(0, 100))
    assert s["window_us"] == 100 and s["device_busy_us"] == 30
    assert s["device_busy_share"] == pytest.approx(0.3) and s["device_idle_share"] == pytest.approx(0.7)
    assert [(r["name"], r["calls"], r["us"]) for r in s["top_ops"]] == [("k_a", 2, 20.0), ("k_b", 1, 10.0),
                                                                        ("Memcpy HtoD", 1, 5.0)]
    gaps = s["longest_gaps"]
    assert [(g["us"], g["start_us"]) for g in gaps] == [(45, 45), (15, 25), (10, 0)]
    assert gaps[0]["host"]["name"] == "aten::inner" and gaps[0]["host"]["tid"] == 7  # innermost over 67.5
    assert gaps[1]["host"]["name"] == "aten::outer"
    # the caller's own markers are not what the host was doing
    marked = prof.summarize(events, window=(0, 100), ignore=("aten::inner",))
    assert marked["longest_gaps"][0]["host"]["name"] == "aten::outer"
    whole = prof.summarize(events)  # the window: every event's span, 0-201
    assert whole["window_us"] == 201 and whole["device_busy_us"] == 30
    with pytest.raises(ValueError):
        prof.summarize([])


def _post(port, path, body):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        c.request("POST", path, body=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_capture_against_a_live_port_server(tmp_path, monkeypatch):
    for k, v in HERMETIC.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("LOG_DIR", str(tmp_path / "logs"))
    pport = _free_port()
    monkeypatch.setenv("RAG_TPU_PROFILE_PORT", str(pport))
    docs = tmp_path / "documents"
    _docs(docs)
    ctx = build_runtime(str(tmp_path / "data"), str(docs), device="cpu")
    prepare(ctx)
    assert ctx.profiler is not None and ctx.profiler.port == pport
    server = HttpServer(App(ctx), "127.0.0.1", 0)
    ready = threading.Event()
    thread = threading.Thread(target=server.run, kwargs={"ready": ready.set}, daemon=True)
    thread.start()
    assert ready.wait(30)
    try:
        c = Client(server.port)
        assert c.wait_job(c.call("POST", "/reindex")[2]["job_id"])["status"] == "completed"
        out = {}
        capture = threading.Thread(target=lambda: out.update(
            r=_post(pport, "/capture", {"duration_ms": 1500, "log_dir": str(tmp_path / "traces")})))
        capture.start()
        time.sleep(0.3)
        assert _post(pport, "/capture", {"duration_ms": 10})[0] == 409  # one window at a time
        for q in ("telescopes observe galaxies", "tomato watering compost", "braising meat in a pot"):
            assert c.call("POST", "/search", {"query": q, "top_k": 3, "use_reranker": False})[0] == 200
        capture.join(60)
        status, body = out["r"]
        assert status == 200 and body["duration_ms"] == 1500 and body["events"] > 0
        assert os.path.dirname(body["trace"]) == str(tmp_path / "traces")
        with open(body["trace"]) as f:
            events = json.load(f)["traceEvents"]
        # the server's searches ran inside the window: their torch ops are in it
        assert any(e.get("cat") == "cpu_op" for e in events)
        assert _post(pport, "/capture", {"duration_ms": -1})[0] == 400
        assert _post(pport, "/elsewhere", {})[0] == 404
        status, body = _post(pport, "/capture", {"duration_ms": 50})
        assert status == 200 and os.path.dirname(body["trace"]) == str(tmp_path / "logs" / "traces")
        c.close()
    finally:
        ctx.profiler.close()
        ctx.supervisor.stop(timeout=5)
        server.stop()
        thread.join(timeout=30)
        ctx.batcher.stop()


def test_capture_port_in_use_logs_a_warning(tmp_path, monkeypatch, caplog):
    for k, v in HERMETIC.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("LOG_DIR", str(tmp_path / "logs"))
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    monkeypatch.setenv("RAG_TPU_PROFILE_PORT", str(blocker.getsockname()[1]))
    ctx = build_runtime(str(tmp_path / "data"), str(tmp_path / "docs"), device="cpu")
    try:
        prepare(ctx)
        assert ctx.profiler is None
        assert any("Profiler server failed to start" in r.getMessage() for r in caplog.records)
    finally:
        blocker.close()
        ctx.supervisor.stop(timeout=5)
        ctx.batcher.stop()
