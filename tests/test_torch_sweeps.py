"""The port's live sweeps (rust_local_rag_tpu_torch/tools/sweep_*.py over
tools/sweep_common.py) against the JAX scripts they port, on the CPU.

  * points: each JAX script's main runs with its server, its HTTP client
    (requests), its YAML writer's consumer (eval_harness.run) and the
    corpus generator replaced by recorders (scripts/ itself is not
    edited), so the points it would evaluate (names in order, and each
    config's search_params as baseline.yaml updated with the point, read
    back with yaml) are captured; the port's point list must give the same
    names in the same order and, through its own config reader
    (evaluation/config.py), the same search_params exactly, for the
    default argv and a custom one;
  * one live point: the port's eval_server on the CPU (`python -m
    rust_local_rag_tpu_torch`, the hash encoder and the hash judge) over
    the eval corpus's 31 authored documents and the dev queries, and
    run_points' summary of the point must equal evaluation.runner's own
    run of the same config against the same server, exactly.
"""

import importlib.util
import json
import os
import subprocess
import sys
import types

import pytest
import yaml

from rust_local_rag_tpu_torch.evaluation.client import RAGClient
from rust_local_rag_tpu_torch.evaluation.runner import EvalRunner, load_ground_truth
from rust_local_rag_tpu_torch.tools import (
    sweep_blend,
    sweep_common,
    sweep_gate,
    sweep_hybrid_weights,
    sweep_qfloor,
    sweep_rejection,
    sweep_rerank_weight,
    sweep_unseen,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [
    ("sweep_blend", sweep_blend, []), ("sweep_blend", sweep_blend, ["off,0.0,0.05,0.1"]),
    ("sweep_gate", sweep_gate, []), ("sweep_gate", sweep_gate, ["0.0,0.06", "0.0,0.25,0.3,0.35"]),
    ("sweep_qfloor", sweep_qfloor, []), ("sweep_qfloor", sweep_qfloor, ["0,0.06", "0,0.05,0.1,0.2,0.3"]),
    ("sweep_rejection", sweep_rejection, []), ("sweep_rejection", sweep_rejection, ["0.02,0.04,0.06"]),
    ("sweep_unseen", sweep_unseen, []), ("sweep_unseen", sweep_unseen, ["0.5,0.6,0.7", "0.5,0.6"]),
    ("sweep_hybrid_weights", sweep_hybrid_weights, []), ("sweep_rerank_weight", sweep_rerank_weight, []),
]


class _Answer:
    def __init__(self, payload):
        self.status_code, self._payload = 200, payload

    def json(self):
        return self._payload


class _Proc:
    returncode = 0

    def poll(self):
        return None

    def terminate(self):
        pass

    def wait(self, timeout=None):
        return 0

    def kill(self):
        pass


def _load(name, monkeypatch):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, name, mod)
    spec.loader.exec_module(mod)
    return mod


def jax_points(name, argv, monkeypatch, tmp_path):
    """[(name, search_params)] the JAX script would evaluate."""
    seen = []

    def eval_main(args):
        cfg = yaml.safe_load(open(args[args.index("--config") + 1]))
        seen.append((cfg["name"], cfg["search_params"]))
        out = args[args.index("--out") + 1]
        with open(os.path.join(out, f"eval_{cfg['name']}_0.json"), "w") as f:
            json.dump({"summary": {"hit_rate_mean": 0.0, "mrr_mean": 0.0, "rejection_success_rate": 0.0}}, f)
        return 0

    requests = types.ModuleType("requests")
    requests.RequestException = OSError
    requests.get = lambda url, **kw: _Answer(None if url.endswith("/jobs/active") else {})
    requests.post = lambda url, **kw: _Answer({})
    monkeypatch.setitem(sys.modules, "requests", requests)
    monkeypatch.setitem(sys.modules, "eval_harness.run", types.SimpleNamespace(main=eval_main))
    monkeypatch.setattr(subprocess, "Popen", lambda *a, **kw: _Proc())
    from eval_harness import corpus

    monkeypatch.setattr(corpus, "generate_corpus", lambda *a, **kw: [])
    monkeypatch.setattr(corpus, "generate_ground_truth", lambda *a, **kw: 0)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    _load("sweep_common", monkeypatch)
    mod = _load(name, monkeypatch)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    assert mod.main() == 0
    return seen


@pytest.mark.parametrize("name,port,argv", CASES, ids=lambda x: x if isinstance(x, str) else None)
def test_points_equal_jax(name, port, argv, monkeypatch, tmp_path, capsys):
    want = jax_points(name, argv, monkeypatch, tmp_path)
    got = port.points(*argv)
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) > 0
    assert [sweep_common.point_config(n, sp).search_params for n, sp in got] == [sp for _, sp in want]


def test_parse_keeps_the_jax_argv():
    assert sweep_common.parse(["0.1,0.2", "--device", "cpu"], "", "a", "b") == (["0.1,0.2", None], "cpu")
    assert sweep_common.parse(["--device", "cpu", "0.5"], "", "a") == (["0.5"], "cpu")


@pytest.fixture
def authored_corpus(monkeypatch):
    """The eval corpus's 31 authored documents (no distractors)."""
    from eval_harness import corpus

    full = corpus.generate_corpus
    monkeypatch.setattr(corpus, "generate_corpus", lambda d, with_distractors=True: full(d, with_distractors=False))
    for k in ("ENCODER_WEIGHTS", "RERANKER_WEIGHTS", "TOKENIZER_PATH", "RAG_TPU_FUSED_ATTN", "SWEEP_KEEP"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RAG_TPU_FAKE_ENCODER", "1")
    monkeypatch.setenv("RAG_TPU_FAKE_ENCODER_DIM", "128")
    monkeypatch.setenv("RAG_TPU_FAKE_RERANKER", "1")


def test_live_point_equals_the_runner(authored_corpus, capsys):
    name, sp = sweep_rejection.points("0.06")[0]
    with sweep_common.eval_server("sweep_test_", "cpu") as (base, gt, work):
        stats = RAGClient(base).get_stats()
        assert stats["documents"] == 31 and stats["chunks"] > 0
        got = sweep_common.run_points(base, gt, work, [(name, sp)])
        client = RAGClient(base)
        try:
            report = EvalRunner(sweep_common.point_config(name, sp), client).run_evaluation(load_ground_truth(gt))
        finally:
            client.close()
        reports = os.listdir(os.path.join(work, "reports"))
        assert any(f.startswith(f"eval_{name}_") and f.endswith(".json") for f in reports)
    assert not os.path.exists(work)
    assert got == {name: sweep_common.summary_of(report)}
    assert report["summary"]["n_queries"] == 153 and report["search_params"]["rejection_threshold"] == 0.06
    out = capsys.readouterr().out
    assert f"{name}: {got[name]}" in out and "indexed:" in out
