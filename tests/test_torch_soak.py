"""The port's soak (tools/soak.py) against the port's server on the CPU,
hermetic (the hash encoder and the hash judge), over the eval corpus's
first authored documents.

For a few seconds the soak's searchers, mutator (rewriting one document
and reindexing, so its chunks are replaced under live reads), stats poller
and SSE listener run at once; there must be zero errors (every search 200
with well-formed results, every job completed, no drift of the document
count) and the final revision must be served. The JAX script
(scripts/soak.py, on requests) must also pass against the same server:
the port serves what the JAX soak checks.
"""

import importlib.util
import os
import sys

import pytest

from rust_local_rag_tpu_torch.evaluation.quality import corpus_server
from rust_local_rag_tpu_torch.tools import soak

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = 6


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from eval_harness import corpus

    mp = pytest.MonkeyPatch()
    for k in ("ENCODER_WEIGHTS", "RERANKER_WEIGHTS", "TOKENIZER_PATH", "RAG_TPU_FUSED_ATTN"):
        mp.delenv(k, raising=False)
    mp.setenv("RAG_TPU_FAKE_ENCODER", "1")
    mp.setenv("RAG_TPU_FAKE_ENCODER_DIM", "128")
    mp.setenv("RAG_TPU_FAKE_RERANKER", "1")
    work = tmp_path_factory.mktemp("soak")
    docs, data, logs = (str(work / d) for d in ("documents", "data", "logs"))
    for d in (docs, data, logs):
        os.makedirs(d)
    all_docs = str(work / "all")
    for name in sorted(corpus.generate_corpus(all_docs, with_distractors=False))[:DOCS]:
        os.replace(os.path.join(all_docs, name), os.path.join(docs, name))
    try:
        with corpus_server(docs, data, logs, "cpu", log=lambda _: None) as (base, client, started):
            assert started["stats"]["documents"] == DOCS
            yield base, docs
    finally:
        mp.undo()


def test_soak_holds_its_invariants(server):
    base, docs = server
    out = soak.soak(base, 6.0, documents=docs)
    assert out["errors"] == []
    c = out["counts"]
    assert c["search"] > 20 and c["reindex"] >= 2 and c["rewrites"] >= 1 and c["stats"] >= 3
    assert out["final_revision"] is True
    assert sorted(os.listdir(docs))[-1] == soak.SOAK_DOC


def test_soak_main_prints_its_counts(server, capsys):
    assert soak.main([server[0], "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("counts: {'search': ") and out[1] == "errors: [] (total 0)"


def test_jax_soak_passes_against_the_port(server, monkeypatch):
    spec = importlib.util.spec_from_file_location("soak_under_test", os.path.join(ROOT, "scripts", "soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["soak.py", server[0], "2"])
    assert mod.main() == 0
