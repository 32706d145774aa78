"""The port's engine decompositions (tools/dispatch_profile.py,
tools/server_profile.py) against the JAX engine whose stages their
scripts time (scripts/exp_dispatch_profile.py, exp_server_profile.py),
on the CPU at a small size.

The scripts build a 1.25M-chunk engine when imported, so they are not
loaded: the JAX side is the JAX RagEngine's own _prep_queries,
_prep_lexical, dispatch_search, fetch_columnar and search_batch, which
the scripts call, over the same seeded rows and Zipf texts (the port's
bench_server.zipf_texts are the script's bench_server._zipf_texts) with
the hash encoder, as tests/test_torch_scale_check.py fills both engines.
The scripts' labels and query lists are read from their source with ast.

Tolerances, each with its reason:
  * query embeddings: 1e-6 (the same hash vectors, normalised in f32 by
    numpy on both sides);
  * BM25 hits: the same slot sets, scores within rel 1e-5 (the native
    index's float sums, as tests/test_torch_native_bm25.py);
  * the hot lane's rows: the same slot sets, scores within 1e-5 (the
    blend of the f32 cosine and the normalised BM25 in another order).
"""

import ast
import io
import json
import os
import tempfile
from contextlib import redirect_stdout

import numpy as np
import pytest

from rust_local_rag_tpu_torch import bench_server
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService
from rust_local_rag_tpu_torch.models.fake_encoder import HashEncoder
from rust_local_rag_tpu_torch.server.serializer import ResponseSerializer
from rust_local_rag_tpu_torch.tools import dispatch_profile, server_profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 6000
DIM = 768
K = dispatch_profile.K
QB = 16


def _script_tree(name):
    with open(os.path.join(ROOT, "scripts", f"{name}.py"), encoding="utf-8") as f:
        return ast.parse(f.read())


def _rows(n):
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n, DIM)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def engines():
    """(port engine, JAX engine) over the same N rows and Zipf texts."""
    from rust_local_rag_tpu.engine.chunk_store import ChunkMeta as JMeta
    from rust_local_rag_tpu.engine.rag_engine import RagEngine as JEngine
    from rust_local_rag_tpu.models import EmbeddingService as JService
    from rust_local_rag_tpu.models import HashEncoder as JHash

    texts, emb = bench_server.zipf_texts(N), _rows(N)
    fields = [dict(id=f"c{i}", document_name=f"doc{i % 977}.pdf", text=texts[i], chunk_index=i,
                   page_number=1 + i % 40) for i in range(N)]
    with tempfile.TemporaryDirectory() as tmp:
        port = RagEngine(os.path.join(tmp, "port"), EmbeddingService(HashEncoder(DIM, "profile")), device="cpu")
        port.add_chunks([ChunkMeta(**f) for f in fields], emb)
        jeng = JEngine(os.path.join(tmp, "jax"), JService(JHash(dim=DIM, model_name="profile")))
        metas = [JMeta(**f) for f in fields]
        for m, slot in zip(metas, jeng.store.add_chunks(metas, emb)):
            jeng.lexical_index.add_chunk(m.id, m.text, slot)
        yield port, jeng


def test_zipf_helpers_equal_the_jax_benchs():
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_server_under_test", os.path.join(ROOT, "scripts",
                                                                                          "bench_server.py"))
    jb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jb)
    assert bench_server.zipf_texts(500) == jb._zipf_texts(500)
    assert bench_server.zipf_queries(QB) == jb._zipf_queries(QB)


def _same_rows(got_slots, got_vals, want_slots, want_vals, rel=0.0, atol=0.0):
    for gs, gv, ws, wv in zip(got_slots, got_vals, want_slots, want_vals):
        g = {int(s): float(v) for s, v in zip(gs, gv) if s >= 0}
        w = {int(s): float(v) for s, v in zip(ws, wv) if s >= 0}
        assert g.keys() == w.keys()
        assert [g[s] for s in w] == pytest.approx(list(w.values()), rel=rel, abs=atol)


@pytest.fixture(scope="module")
def stages(engines):
    port, jeng = engines
    qs = bench_server.zipf_queries(QB)
    ser = ResponseSerializer(lambda: port.store)
    ser.preregister_all()
    col = port.fetch_columnar(port.dispatch_search(qs, K))
    return qs, {label: fn for label, fn, _ in dispatch_profile.stages(port, qs, K, ser, col)}, col


@pytest.mark.parametrize("label", ["prep_queries (tok+enc disp)", "prep_queries + sync", "prep_queries + block"])
def test_prep_queries_stage_matches_jax(engines, stages, label):
    _, jeng = engines
    qs, fns, _ = stages
    got = np.asarray(fns[label]())
    want = np.asarray(jeng._prep_queries(qs, len(qs)))
    assert got.shape == want.shape == (QB, DIM)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_prep_lexical_stage_matches_jax(engines, stages):
    _, jeng = engines
    qs, fns, _ = stages
    (gs, gv), (ws, wv) = fns["prep_lexical"](), jeng._prep_lexical(qs, K, len(qs))
    assert gs.shape == ws.shape
    assert (gs >= 0).sum() > QB  # the queries' terms hit the index
    _same_rows(gs, gv, ws, wv, rel=1e-5)


@pytest.mark.parametrize("label", ["dispatch_search (no fetch)", "dispatch_search + sync", "dispatch+fetch"])
def test_dispatch_stages_match_jax(engines, stages, label):
    port, jeng = engines
    qs, fns, _ = stages
    got = fns[label]()
    if label != "dispatch+fetch":
        got = port.fetch_columnar(got)
    want = jeng.fetch_columnar(jeng.dispatch_search(qs, K))
    for f in ("vals", "emb", "lex"):
        _same_rows(got.slots[:QB], getattr(got, f)[:QB], want.slots[:QB], getattr(want, f)[:QB], atol=1e-5)
    assert got.floor == want.floor


def test_serialize_stage_gives_the_jax_engines_results(engines, stages):
    _, jeng = engines
    qs, fns, col = stages
    bodies = fns["serialize batch"]()
    want = jeng.fetch_columnar(jeng.dispatch_search(qs, K))
    assert len(bodies) == QB
    for qi, body in enumerate(bodies):
        got = {r["chunk_id"]: r["score"] for r in json.loads(body)["results"]}
        ref = {r.chunk_id: r.score for r in jeng.results_from_columnar(want, qi)}
        assert got.keys() == ref.keys() and len(got) == K
        assert [got[c] for c in ref] == pytest.approx(list(ref.values()), abs=1e-5)


def _script_labels():
    """The first argument of every t("...") call of the script, and the
    pipelined line's label."""
    tree = _script_tree("exp_dispatch_profile")
    labels = [n.args[0].value for n in ast.walk(tree) if isinstance(n, ast.Call)
              and getattr(n.func, "id", None) == "t" and isinstance(n.args[0], ast.Constant)]
    consts = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    return labels + [c for c in consts if c.startswith("pipelined iter")]


def test_decompose_prints_every_label_of_the_script(engines):
    port, _ = engines
    labels = _script_labels()
    assert len(labels) == 7 and "dispatch_search (no fetch)" in labels
    lines = []
    out = dispatch_profile.decompose(port, bench_server.zipf_queries(QB), reps=1, pipelined_reps=2,
                                     log=lines.append)
    for label in labels:
        assert any(line.startswith(label) for line in lines), label
    assert "dispatch_search + sync" in out and out["pipelined_qps"] > 0


def test_server_profile_queries_are_the_scripts():
    tree = _script_tree("exp_server_profile")
    comp = next(n for n in ast.walk(tree) if isinstance(n, ast.ListComp))
    want = eval(compile(ast.Expression(comp), "exp_server_profile", "eval"), {"range": range})
    assert server_profile.queries() == want and len(want) == server_profile.QUERIES


def test_server_profile_matches_jax_search_batch(engines):
    port, jeng = engines
    qs = server_profile.queries(8)
    lines = []
    out = server_profile.profile(port, qs, top_k=20, log=lines.append)
    assert lines[0] == "warmed" and lines[1].startswith("search_batch(8, k=20):")
    assert "cumulative" in lines[2] and "search_batch" in lines[2]
    assert out["answers"] == 8 and out["results_per_query"] == [20] * 8
    for a, b in zip(port.search_batch(qs, 20, use_reranker=False), jeng.search_batch(qs, 20, use_reranker=False)):
        assert [r.chunk_id for r in a] == [r.chunk_id for r in b]
        assert [r.score for r in a] == pytest.approx([r.score for r in b], abs=1e-5)


@pytest.mark.parametrize("argv,qb", [([], 512), (["64"], 64)])
def test_dispatch_profile_main_takes_the_scripts_batch_argument(monkeypatch, argv, qb):
    """argv[1] is the batch, 512 by default, over a 1,250,000-chunk engine,
    as in the script."""
    import types

    seen = {}
    eng = types.SimpleNamespace(embedding_service=types.SimpleNamespace(close=lambda: seen.setdefault("closed", 1)),
                                lexical_index=types.SimpleNamespace(compile_all=lambda: 0))
    monkeypatch.setattr(dispatch_profile, "build", lambda n, tmp, dev, log: seen.setdefault("n", n) and eng)
    monkeypatch.setattr(dispatch_profile, "decompose", lambda e, qs, log: seen.update(qs=qs) or {"ok": 1})
    with redirect_stdout(io.StringIO()):
        assert dispatch_profile.main(argv + ["--device", "cpu"]) == {"ok": 1}
    assert seen["n"] == 1_250_000 and seen["qs"] == bench_server.zipf_queries(qb) and seen["closed"]
