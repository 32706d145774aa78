"""The port's eval harness (rust_local_rag_tpu_torch/evaluation/: client,
config, runner, quality; the standard library only) against eval_harness/
(requests and yaml) and the port's server against the JAX server under it.

  * The port's twin of tests/test_eval_harness.py::test_live_server_eval:
    the hermetic HashEncoder + FakeReranker servers of both packages (as
    tests/test_torch_http.py builds them) over the generated eval corpus,
    each evaluated by the port's runner: 168 per-query rows, 153 retrieval
    queries, every row equal between the two servers, latency aside.
  * The port's runner and client against eval_harness's own EvalRunner and
    RAGClient on the same server, in the HTTP and MCP modes: equal reports.
  * The config reader against yaml.safe_load on every eval_harness config.
  * The quality run with the committed encoder and judge through both
    packages on the CPU (the port's evaluation.quality against the JAX
    server driven by eval_harness's runner)."""

import glob
import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest
import requests
import yaml

from eval_harness.client import RAGClient as JClient
from eval_harness.corpus import generate_corpus, generate_ground_truth
from eval_harness.runner import EvalConfig as JConfig
from eval_harness.runner import EvalRunner as JRunner
from eval_harness.runner import load_ground_truth as j_load_ground_truth
from rust_local_rag_tpu_torch.evaluation import config as yaml_subset
from rust_local_rag_tpu_torch.evaluation import quality
from rust_local_rag_tpu_torch.evaluation.client import RAGClient, SearchResult, matches_gold_reference
from rust_local_rag_tpu_torch.evaluation.runner import EvalConfig, EvalRunner, load_ground_truth, write_reports
from test_torch_http import LANES, Conn, _JaxServer, _PortServer, req, wait_job

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "eval_harness", "configs", "*.yaml")))


def without_latency(report: dict) -> dict:
    """A report with what a run draws anew (clocks, latencies) taken out."""
    out = {k: v for k, v in report.items() if k not in ("started_at", "duration_s")}

    def strip(d):
        return {k: v for k, v in d.items() if not k.startswith("latency")}

    out["summary"] = strip(report["summary"])
    out["by_category"] = {k: strip(v) for k, v in report["by_category"].items()}
    out["by_difficulty"] = {k: strip(v) for k, v in report["by_difficulty"].items()}
    out["per_query"] = [strip(r) for r in report["per_query"]]
    return out


@pytest.fixture(scope="module")
def eval_servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    docs = root / "documents"
    generate_corpus(str(docs))
    gt = root / "queries.jsonl"
    generate_ground_truth(str(gt))
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
        assert wait_job(s, s.job_id, timeout=300)["status"] == "completed"
    yield made, str(gt)
    for s in made.values():
        s.stop()


def port_report(server, gt, mode="http", **cfg):
    base = f"http://127.0.0.1:{server.port}"
    config = EvalConfig(rag_endpoint=base, ground_truth_path=gt, connection_mode=mode, **cfg)
    client = RAGClient(base + ("/mcp" if mode == "mcp" else ""), mode=mode)
    assert client.health_check()
    try:
        return EvalRunner(config, client).run_evaluation(load_ground_truth(gt))
    finally:
        client.close()


def test_live_server_eval_equal_jax(eval_servers):
    """The port's twin of test_live_server_eval: the harness mechanics over
    the authored corpus (hash encoder, so no quality gate), on both servers."""
    servers, gt = eval_servers
    reports = {name: port_report(s, gt, page_tolerance=1) for name, s in servers.items()}
    for r in reports.values():
        assert r["summary"]["n_queries"] == 153 and len(r["per_query"]) == 168
        assert 0.0 <= r["summary"]["hit_rate_mean"] <= 1.0 and r["summary"]["rejection_success_rate"] is not None
        assert set(r["by_difficulty"]) <= {"easy", "medium", "hard"}
    a, b = without_latency(reports["port"]), without_latency(reports["jax"])
    for x, y in zip(a["per_query"], b["per_query"]):
        assert x == y
    assert a == b
    # per-request search_params reach the engine: lexical-only weights and
    # use_reranker=False drop the reranker fields, in both servers
    query = load_ground_truth(gt)[0].query
    body = {"query": query, "top_k": 3, "use_reranker": False, "weights": {"embedding": 0.0, "lexical": 1.0}}
    for s in servers.values():
        r = requests.post(f"http://127.0.0.1:{s.port}/search", json=body, timeout=30)
        assert r.status_code == 200 and r.json()["results"]
        assert all("reranker_score" not in row for row in r.json()["results"])


@pytest.mark.parametrize("mode", ["http", "mcp"])
@pytest.mark.parametrize("config", ["baseline", "embedding_only", "bm25_only"])
def test_port_harness_equals_eval_harness(eval_servers, mode, config):
    """The port's runner and client against eval_harness's on the port's
    server: the same config file, the same report."""
    servers, gt = eval_servers
    base = f"http://127.0.0.1:{servers['port'].port}"
    endpoint = base + ("/mcp" if mode == "mcp" else "")
    path = os.path.join(ROOT, "eval_harness", "configs", f"{config}.yaml")
    jcfg, cfg = JConfig.from_yaml(path), EvalConfig.from_yaml(path)
    assert vars(jcfg) == vars(cfg)
    for c in (jcfg, cfg):
        c.rag_endpoint, c.ground_truth_path, c.connection_mode = base, gt, mode
    jclient, client = JClient(endpoint, mode=mode), RAGClient(endpoint, mode=mode)
    assert jclient.health_check() and client.health_check()
    assert client.get_stats() == jclient.get_stats()
    want = JRunner(jcfg, jclient).run_evaluation(j_load_ground_truth(gt))
    got = EvalRunner(cfg, client).run_evaluation(load_ground_truth(gt))
    client.close()
    assert without_latency(got) == without_latency(want)
    assert len(got["per_query"]) == 168


def test_reports_written_as_the_harness_writes_them(eval_servers, tmp_path):
    from eval_harness.runner import write_reports as j_write_reports

    servers, gt = eval_servers
    report = port_report(servers["port"], gt, name="twin")
    write_reports(report, str(tmp_path / "port"))
    j_write_reports(report, str(tmp_path / "jax"))
    for ext in ("json", "md"):
        (a,), (b,) = glob.glob(str(tmp_path / "port" / f"*.{ext}")), glob.glob(str(tmp_path / "jax" / f"*.{ext}"))
        assert os.path.basename(a).startswith("eval_twin_") and open(a).read() == open(b).read()


def test_client_errors_match_the_harness():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{s.getsockname()[1]}"
    for mode in ("http", "mcp"):
        assert RAGClient(dead, mode=mode).health_check() is JClient(dead, mode=mode).health_check() is False
        for client in (RAGClient(dead, mode=mode), JClient(dead, mode=mode)):
            with pytest.raises(ConnectionError):
                client.search("anything")
    r = SearchResult(chunk_id="", document="Guide.PDF", page=4, text="", score=1.0)
    assert matches_gold_reference(r, "guide.pdf", 5) and not matches_gold_reference(r, "guide.pdf", 6)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_reader_equals_yaml(path):
    with open(path, encoding="utf-8") as f:
        assert yaml_subset.load(path) == yaml.safe_load(f)


@pytest.mark.parametrize("text", [
    "a: 1\nb: -2.5\nc: 1_000\nd: .5\ne: 'it''s # not a comment'\nf: \"tab\\there\"\n",
    "# only a comment\nname: \"x\"  # trailing\nnested:\n  deep:\n    x: yes\n    y: off\n  z: ~\nlast:\n",
    "t: True\nu: NULL\nv: 0\nw: 007\nx: 1e3\ny: 1.0e+3\nz: plain text here\n",
])
def test_config_reader_scalars_equal_yaml(text):
    assert yaml_subset.parse(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["- a\n- b\n", "a: [1, 2]\n", "a: {b: 1}\n", "a: |\n  text\n", "just text\n"])
def test_config_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        yaml_subset.parse(text)


def test_lane_of_each_body():
    assert {k: quality.lane_of(v) for k, v in LANES.items()} == {
        "hot": "hot", "mmr": "mmr_hot", "judged": "judged", "object": "object (MMR)"}
    lanes = {os.path.basename(p)[:-5]: quality.lane_of(yaml_subset.load(p)["search_params"]) for p in CONFIGS}
    assert lanes == {"baseline": "object (MMR)", "baseline_heldout": "object (MMR)",
                     "baseline_thirdparty": "object (MMR)", "bm25_only": "mmr_hot", "embedding_only": "mmr_hot"}
    assert set(quality.REFERENCE_REPORTS) == set(lanes)
    for f in quality.REFERENCE_REPORTS.values():
        assert os.path.exists(os.path.join(ROOT, "eval_harness", "reports", f))


def test_compare_lists_each_differing_row():
    row = lambda q, h, m: {"query_id": q, "is_rejection": False, "hit_rate": h, "mrr": m}  # noqa: E731
    ref = {"per_query": [row("Q1", 1.0, 1.0), row("Q2", 1.0, 0.5), row("Q3", 0.0, 0.0)]}
    got = {"per_query": [row("Q1", 1.0, 1.0), row("Q2", 1.0, 0.25), row("Q4", 1.0, 1.0)]}
    assert [(d["query_id"], d["port"], d["jax"]) for d in quality.compare(got, ref)] == [
        ("Q2", {"hit_rate": 1.0, "mrr": 0.25}, {"hit_rate": 1.0, "mrr": 0.5}),
        ("Q3", None, {"hit_rate": 0.0, "mrr": 0.0}), ("Q4", {"hit_rate": 1.0, "mrr": 1.0}, None)]


# ------------------------------------------------- quality, both packages ----


def recording(cls, answers: dict):
    """cls (a RAGClient) whose searches record their answers by query."""

    class Recording(cls):
        def search(self, query, top_k=5, params=None):
            resp = super().search(query, top_k, params)
            answers[query] = [(r.document, r.page, r.text) for r in resp.results]
            return resp

    return Recording


def _jax_quality(work, gt, out, answers):
    """The JAX server (python -m rust_local_rag_tpu on the CPU) with the
    committed assets over the same corpus, evaluated by eval_harness's
    runner with each config."""
    docs = os.path.join(work, "docs")
    generate_corpus(docs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, DATA_DIR=os.path.join(work, "data"), DOCUMENTS_DIR=docs, LOG_DIR=os.path.join(work, "logs"),
               MCP_HTTP_BIND=f"127.0.0.1:{port}", RAG_TPU_RERANK_MODEL="tpu-reranker", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT)
    env.pop("RAG_TPU_NO_DEFAULT_ASSETS", None)
    base = f"http://127.0.0.1:{port}"
    proc = subprocess.Popen([sys.executable, "-m", "rust_local_rag_tpu"], env=env, cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 300
        while not JClient(base).health_check():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.5)
        requests.post(f"{base}/reindex", timeout=30)
        while requests.get(f"{base}/jobs/active", timeout=30).json() is not None:
            time.sleep(0.5)
        for name in ("baseline", "embedding_only", "bm25_only"):
            cfg = JConfig.from_yaml(os.path.join(ROOT, "eval_harness", "configs", f"{name}.yaml"))
            cfg.rag_endpoint = base
            answers[name] = {}
            client = recording(JClient, answers[name])(base)
            out[name] = JRunner(cfg, client).run_evaluation(j_load_ground_truth(gt))
    finally:
        proc.terminate()
        proc.wait(timeout=60)


@pytest.mark.slow  # ~160 s on a CPU: two servers, two encoders over 779 chunks, 3 x 168 queries
def test_quality_with_committed_assets_equal_jax(tmp_path, monkeypatch):
    """evaluation.quality on the CPU against the JAX server on the same
    corpus and queries, query by query: every row equal, except where the
    two servers returned the same chunks in another order (then hit_rate
    is equal and only the ranks move). The encoders' bf16 activations
    differ in their last bits between XLA and PyTorch on the CPU (held to
    2e-2 in tests/test_torch_encoder.py), so MMR's picks among
    near-equal candidates can swap; such rows are printed."""
    gt = str(tmp_path / "queries.jsonl")
    generate_ground_truth(gt)
    jax_out, jax_answers, port_answers = {}, {}, {}
    t = threading.Thread(target=_jax_quality, args=(str(tmp_path / "jax"), gt, jax_out, jax_answers))
    t.start()
    real_evaluate = quality.evaluate

    def evaluate(name, *a, **kw):
        port_answers[name] = {}
        monkeypatch.setattr(quality, "RAGClient", recording(RAGClient, port_answers[name]))
        return real_evaluate(name, *a, **kw)

    monkeypatch.setattr(quality, "evaluate", evaluate)
    port = quality.run_quality(str(tmp_path / "reports"), device="cpu", log=lambda line: None)
    t.join(600)
    assert set(jax_out) == set(port["configs"]) == {"baseline", "embedding_only", "bm25_only"}
    assert port["stats"]["chunks"] == 779 and port["stats"]["reranker_model"] == "tpu-reranker"
    queries = {q.query_id: q.query for q in load_ground_truth(gt)}
    reordered = []
    for name, row in port["configs"].items():
        (path,) = glob.glob(str(tmp_path / "reports" / f"eval_{name}_*.json"))
        with open(path) as f:
            report = json.load(f)
        assert len(report["per_query"]) == 168 and row["summary"]["n_queries"] == 153
        for d in quality.compare(report, jax_out[name]):
            a, b = port_answers[name][queries[d["query_id"]]], jax_answers[name][queries[d["query_id"]]]
            assert d["port"]["hit_rate"] == d["jax"]["hit_rate"] and sorted(a) == sorted(b) and a != b, (name, d)
            reordered.append((name, d["query_id"], d["port"]["mrr"], d["jax"]["mrr"]))
    print("rows with the same chunks in another order:", reordered)
