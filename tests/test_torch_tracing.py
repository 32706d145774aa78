"""The port's tracer (rust_local_rag_tpu_torch/utils/profiling.py: span,
interval, count, snapshot, reset): off it records nothing and hands out
one shared no-op; on, with an injected clock, its totals are exact; under
a torch.profiler window its spans are user_annotation events nested as in
the program and stay out of the totals; ingest on the CPU opens every
ingest span with the chunks as items and gives the same bits traced or
not; a served request's http and batch spans carry one request id."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService
from rust_local_rag_tpu_torch.models.encoder import Encoder, EncoderConfig, TransformerEncoderModel
from rust_local_rag_tpu_torch.models.tokenizer import load_tokenizer
from rust_local_rag_tpu_torch.ops.attention import fused_attention
from rust_local_rag_tpu_torch.ops.score_segmax import score_segmax
from rust_local_rag_tpu_torch.utils import profiling as prof

TOKENIZER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "rust_local_rag_tpu", "assets", "tokenizer.json")
INGEST_SPANS = ("embed.batches", "embed.handoff", "encoder.tokenize", "encoder.forward", "encoder.readback",
                "store.add", "store.normalize", "store.slab", "store.bm25")


class Clock:
    """Integer nanoseconds that move only when the test moves them."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


@pytest.fixture
def tracer():
    """The process tracer, on and empty; off and empty again after."""
    prof.reset()
    prof.enable()
    try:
        yield prof.TRACER
    finally:
        prof.disable()
        prof.reset()


def test_off_hands_out_the_shared_noop():
    t = prof.Tracer(clock=Clock())
    assert not t.on and not prof.TRACER.on  # off unless RAG_TPU_TRACE asks
    assert t.span("a") is prof.NOOP and prof.span("b", 3, request=7) is prof.NOOP
    with t.span("a", 4):
        t.interval("w", 0, 10)
        t.count("c", 5)
    assert t.current() is None and t.adopt(None) is prof.NOOP
    assert t.snapshot() == {"spans": {}, "counters": {}}


def test_nested_spans_on_an_injected_clock():
    clk = Clock()
    t = prof.Tracer(clock=clk, on=True)
    with t.span("outer", items=3):
        clk.t += 10
        with t.span("inner", items=2):
            clk.t += 5
        clk.t += 1
        with t.span("inner", items=2):
            clk.t += 4
            with t.span("leaf"):
                clk.t += 3
        clk.t += 2
    s = t.snapshot()["spans"]
    assert s["leaf"] == {"calls": 1, "ns": 3, "items": 1, "self_ns": 3}
    assert s["inner"] == {"calls": 2, "ns": 12, "items": 4, "self_ns": 9}
    assert s["outer"] == {"calls": 1, "ns": 25, "items": 3, "self_ns": 13}
    assert s["outer"]["self_ns"] == s["outer"]["ns"] - s["inner"]["ns"]  # its duration less its children's
    t.reset()
    assert t.snapshot() == {"spans": {}, "counters": {}}


def test_counters_intervals_and_a_span_on_another_thread():
    clk = Clock()
    t = prof.Tracer(clock=clk, on=True)
    with t.span("caller", items=2):
        parent = t.current()
        t.interval("wait", 100, 107)
        t.interval("wait", 200, 203, items=2)

        def work():
            with t.adopt(parent), t.span("worker"):
                clk.t += 20

        th = threading.Thread(target=work)
        th.start()
        th.join(10)
        assert not th.is_alive()
        clk.t += 30
        t.count("tokens", 5)
        t.count("tokens", 6)
    snap = t.snapshot()
    assert snap["counters"] == {"tokens": 11}
    assert snap["spans"]["wait"] == {"calls": 2, "ns": 10, "items": 3, "self_ns": 10}
    assert snap["spans"]["worker"]["ns"] == 20
    # the other thread's span and this thread's intervals are the caller's children
    assert snap["spans"]["caller"] == {"calls": 1, "ns": 50, "items": 2, "self_ns": 20}


def test_threads_recording_at_once_lose_nothing():
    t = prof.Tracer(on=True)
    n_threads, per = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with t.span("s", items=3):
                    t.count("c", 2)
                t.interval("i", 0, 5)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    snap = t.snapshot()
    total = n_threads * per
    assert snap["spans"]["s"]["calls"] == total and snap["spans"]["s"]["items"] == 3 * total
    assert snap["spans"]["i"] == {"calls": total, "ns": 5 * total, "items": total, "self_ns": 5 * total}
    assert snap["counters"]["c"] == 2 * total


@pytest.mark.parametrize("on", [False, True])
def test_spans_under_a_device_trace_are_annotations_out_of_the_totals(tmp_path, on):
    prof.reset()
    prof.TRACER.on = on
    try:
        with prof.device_trace(str(tmp_path)) as trace:
            with prof.span("outer"):
                with prof.span("inner", 2):
                    torch.ones(8).sum()
                prof.count("c", 1)
                prof.interval("wait", 0, 9)
        snap = prof.snapshot()
    finally:
        prof.disable()
        prof.reset()
    marks = {e["name"]: e for e in trace.events
             if e.get("cat") == "user_annotation" and e.get("name") in ("outer", "inner")}
    assert set(marks) == {"outer", "inner"}
    outer, inner = marks["outer"], marks["inner"]
    assert outer["tid"] == inner["tid"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert snap == {"spans": {}, "counters": {}}


def test_ranges_carry_the_request_ids(tmp_path):
    import json

    with prof.device_trace(str(tmp_path)) as trace:
        with prof.span("one", request=7), prof.span("many", 2, request=[7, 9]), prof.span("none"):
            torch.ones(2).sum()
    with open(trace.path) as f:  # the file as written, not only the events read back
        events = json.load(f)["traceEvents"]
    ranges = {e["name"]: e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    assert set(ranges) == {"one", "many", "none"}
    assert ranges["one"]["args"]["request"] == "7" and ranges["many"]["args"]["request"] == "7,9"
    assert "request" not in ranges["none"]["args"]
    one, many, none = ranges["one"], ranges["many"], ranges["none"]
    assert one["ts"] <= many["ts"] <= none["ts"] and none["ts"] + none["dur"] <= one["ts"] + one["dur"]


def test_the_capture_port_answers_the_totals(tmp_path, tracer):
    import http.client
    import json

    with prof.span("s", 3):
        prof.count("c", 2)
    srv = prof.CaptureServer(0, str(tmp_path))
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("GET", "/totals")
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200 and body["on"] is True and body["counters"] == {"c": 2}
        assert body["spans"]["s"]["calls"] == 1 and body["spans"]["s"]["items"] == 3
        conn.request("GET", "/elsewhere")
        resp = conn.getresponse()
        assert resp.status == 404 and "error" in json.loads(resp.read())
        conn.close()
    finally:
        srv.close()


def _engine(tmp_path, name):
    cfg = EncoderConfig(vocab_size=30528, dim=16, depth=2, heads=2, ffn_dim=32, max_len=64, out_dim=16)
    enc = Encoder(cfg, torch.Generator().manual_seed(5))
    model = TransformerEncoderModel(enc, load_tokenizer(TOKENIZER, vocab_size=cfg.vocab_size, max_len=cfg.max_len),
                                    device="cpu")
    svc = EmbeddingService(model)
    return RagEngine(str(tmp_path / name), svc, None, device="cpu"), svc


def _ingest(tmp_path, name):
    """Two documents through embed_in_batches (batches of 4) and add_chunks
    -> (embeddings, slab rows, BM25 hits, launch counts). The counts are 0
    on the CPU, where the kernels take their plain twins; chip_smoke.py's
    `tracing` phase compares them on the card."""
    engine, svc = _engine(tmp_path, name)
    rng = np.random.default_rng(3)
    words = ("pump seal valve pressure bearing gasket flow motor shaft coupling impeller housing drain "
             "torque alignment vibration lubricant filter").split()
    docs = [[" ".join(rng.choice(words, size=int(rng.integers(3, 30)))) for _ in range(n)] for n in (9, 6)]
    launches = (score_segmax.launches, fused_attention.launches)
    embs = []
    try:
        for d, texts in enumerate(docs):
            emb = svc.embed_in_batches(texts, batch_size=4)
            embs.append(emb)
            engine.add_chunks([ChunkMeta(id=f"d{d}-{i}", document_name=f"doc{d}.pdf", text=t, chunk_index=i,
                                         page_number=1) for i, t in enumerate(texts)], emb)
        rows = engine.store.corpus()[:len(engine.store)].clone()
        hits = []
        for q in ("pump seal", "bearing vibration lubricant", "impeller"):
            slots, vals = np.full(8, -1, np.int32), np.zeros(8, np.float32)
            n = engine.lexical_index.score_slots_into(q, 8, slots, vals)
            hits.append((slots[:n].tolist(), vals[:n].tolist()))
    finally:
        svc.close()
    counts = (score_segmax.launches - launches[0], fused_attention.launches - launches[1])
    return np.concatenate(embs), rows, hits, counts, sum(len(t) for t in docs)


def test_ingest_spans_and_the_same_bits_traced_or_not(tmp_path, tracer):
    traced = _ingest(tmp_path, "on")
    snap = prof.snapshot()
    prof.disable()
    plain = _ingest(tmp_path, "off")
    chunks = traced[4]
    spans = snap["spans"]
    assert set(INGEST_SPANS) <= set(spans)
    for name in INGEST_SPANS:
        assert spans[name]["ns"] > 0
        if name != "embed.handoff":
            assert spans[name]["items"] == chunks, name
    assert spans["embed.batches"]["calls"] == 2 and spans["store.add"]["calls"] == 2
    assert spans["embed.handoff"]["calls"] == spans["encoder.forward"]["calls"] == 3 + 2  # batches of 4
    for name in ("embed.batches", "store.add"):
        assert 0 <= spans[name]["self_ns"] < spans[name]["ns"]
    tokens = snap["counters"]
    assert 0 < tokens["encoder.tokens_valid"] <= tokens["encoder.tokens_computed"]
    np.testing.assert_array_equal(traced[0], plain[0])
    assert torch.equal(traced[1], plain[1])
    assert traced[2] == plain[2] and traced[3] == plain[3]


def test_a_served_request_carries_one_id(tmp_path, monkeypatch, tracer):
    import http.client
    import json

    from rust_local_rag_tpu_torch.server.app import build_runtime, prepare
    from rust_local_rag_tpu_torch.server.fastpath import HttpServer
    from rust_local_rag_tpu_torch.server.http_api import App
    from test_torch_server_e2e import HERMETIC, Client, _docs

    for k, v in HERMETIC.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("LOG_DIR", str(tmp_path / "logs"))
    docs = tmp_path / "documents"
    _docs(docs)
    monkeypatch.delenv("RAG_TPU_PROFILE_PORT", raising=False)
    ctx = build_runtime(str(tmp_path / "data"), str(docs), device="cpu")
    prepare(ctx)
    server = HttpServer(App(ctx), "127.0.0.1", 0)
    ready = threading.Event()
    thread = threading.Thread(target=server.run, kwargs={"ready": ready.set}, daemon=True)
    thread.start()
    assert ready.wait(30)
    try:
        c = Client(server.port)
        assert c.wait_job(c.call("POST", "/reindex")[2]["job_id"])["status"] == "completed"
        prof.reset()
        body = {"query": "telescopes observe galaxies", "top_k": 3, "use_reranker": False,
                "diversity_factor": 0.0}
        assert c.call("POST", "/search", body)[0] == 200
        want = {"http.parse", "http.write", "batch.hot", "batch.serialize", "batch.queue_wait",
                "engine.prep_queries", "engine.prep_lexical", "engine.dispatch", "engine.fetch", "bm25.lock_wait"}
        deadline = time.monotonic() + 30
        while not want <= set(prof.snapshot()["spans"]) and time.monotonic() < deadline:
            time.sleep(0.01)  # the answer can leave before its spans close
        spans = prof.snapshot()["spans"]
        assert want <= set(spans), want - set(spans)
        assert spans["batch.queue_wait"]["items"] == 1 and spans["batch.hot"]["items"] == 1

        from rust_local_rag_tpu_torch.server.fastpath import HttpProtocol

        done = {"batch": 0, "write": 0}  # the batch span and http.write closed
        execute, finish = ctx.batcher._execute, HttpProtocol._finish

        def executed(*a, **kw):
            try:
                return execute(*a, **kw)
            finally:
                done["batch"] += 1

        def finished(self, *a, **kw):
            try:
                return finish(self, *a, **kw)
            finally:
                done["write"] += 1

        monkeypatch.setattr(ctx.batcher, "_execute", executed)
        monkeypatch.setattr(HttpProtocol, "_finish", finished)
        with prof.device_trace(str(tmp_path / "trace")) as trace:
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            conn.request("POST", "/search", body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read())["results"]
            conn.close()
            deadline = time.monotonic() + 30
            while not (done["batch"] and done["write"]) and time.monotonic() < deadline:
                time.sleep(0.01)
        with open(trace.path) as f:  # the ids as the trace file holds them
            events = json.load(f)["traceEvents"]
        ids = {}
        for e in events:
            if e.get("cat") == "user_annotation" and e.get("name") in ("http.parse", "batch.hot", "http.write"):
                ids.setdefault(e["name"], []).append(e.get("args", {}).get("request"))
        assert set(ids) == {"http.parse", "batch.hot", "http.write"}
        assert ids["http.parse"] == ids["batch.hot"] == ids["http.write"], ids
        assert len(ids["http.parse"]) == 1 and ids["http.parse"][0].isdigit()
        names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
        assert {"engine.prep_queries", "engine.dispatch", "engine.fetch", "batch.serialize"} <= names
        assert not any(prof.REQUEST_TAG in str(e.get("name")) for e in events)
        c.close()
    finally:
        ctx.supervisor.stop(timeout=5)
        server.stop()
        thread.join(timeout=30)
        ctx.batcher.stop()
