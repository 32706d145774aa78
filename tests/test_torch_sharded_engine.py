"""The port's sharded engine (RAG_TPU_SHARD_CORPUS / RAG_TPU_DATA_PARALLEL /
RAG_TPU_SLICES) against the JAX engine under the same environment, on
the CPU: counterparts of the 15 tests of tests/test_sharded_engine.py and
of tests/test_int8_exact.py's sharded escalation, plus the mesh's
warnings and fallbacks, the sharded store through every mutation, and
the batcher's lanes (a sharded engine serves every request on the object
lane, as the JAX engine does).

The JAX engines run on the JAX test platform's 8 virtual CPU devices
(tests/conftest.py), the port's on its 8-position CPU mesh
(parallel/mesh.CPU_DEVICES). Both populate the same rows with the same
hash encoder and the same BM25 hits (the pure-Python indexes,
RAG_TPU_NATIVE_BM25=0). Results are compared by chunk id: the same
ids in the same order (MMR and rankings without ties), scores within
SCORE_ATOL = 1e-5 (f32 sums in another order; tests/test_torch_ops.py).
"""

import logging
import os
from contextlib import contextmanager

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_local_rag_tpu.config import QueryWeights as JWeights
from rust_local_rag_tpu.engine.chunk_store import ChunkMeta as JMeta
from rust_local_rag_tpu.engine.chunk_store import ChunkStore as JStore
from rust_local_rag_tpu.engine.rag_engine import RagEngine as JEngine
from rust_local_rag_tpu.models.embedding_service import EmbeddingService as JService
from rust_local_rag_tpu.models.fake_encoder import HashEncoder
from rust_local_rag_tpu.models.reranker import FakeReranker
from rust_local_rag_tpu.models.reranker_service import RerankerService as JRerankerService
from rust_local_rag_tpu.parallel import sharded_search as jss
from rust_local_rag_tpu.parallel.mesh import build_mesh as jbuild_mesh
from rust_local_rag_tpu.server.batcher import SearchBatcher as JBatcher
from rust_local_rag_tpu.utils.rwlock import RwLock as JLock
from rust_local_rag_tpu_torch.config import QueryWeights as TWeights
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta as TMeta
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkStore as TStore
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine as TEngine
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService as TService
from rust_local_rag_tpu_torch.models.fake_encoder import HashEncoder as THashEncoder
from rust_local_rag_tpu_torch.models.reranker import FakeReranker as TFakeReranker
from rust_local_rag_tpu_torch.models.reranker_service import RerankerService as TRerankerService
from rust_local_rag_tpu_torch.parallel import mesh as tmesh
from rust_local_rag_tpu_torch.parallel import sharded_search as tss
from rust_local_rag_tpu_torch.server.batcher import SearchBatcher as TBatcher
from rust_local_rag_tpu_torch.utils.rwlock import RwLock as TLock

N, D = 4096, 64
SCORE_ATOL = 1e-5
QUERIES = ("synthetic alpha beta", "chunk 100", "zeta unknown")
SHARD_VARS = ("RAG_TPU_SHARD_CORPUS", "RAG_TPU_DATA_PARALLEL", "RAG_TPU_SLICES", "RAG_TPU_INT8_CORPUS")


@contextmanager
def _env(env):
    old = {k: os.environ.get(k) for k in (*SHARD_VARS, "RAG_TPU_NATIVE_BM25")}
    for k in SHARD_VARS:
        os.environ.pop(k, None)
    os.environ["RAG_TPU_NATIVE_BM25"] = "0"
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _pair(root, model, env=None, reranker=False):
    """(jax_engine, port_engine) under the same environment."""
    with _env(env or {}):
        j = JEngine(str(root / "jax"), JService(HashEncoder(dim=D, model_name=model)),
                    reranker=JRerankerService(FakeReranker()) if reranker else None)
        t = TEngine(str(root / "port"), TService(THashEncoder(dim=D, model_name=model)),
                    reranker=TRerankerService(TFakeReranker()) if reranker else None, device="cpu")
    return j, t


def _populate(eng, meta_cls, rng, n=N, bs=1024, every=37):
    """tests/test_sharded_engine.py's rows: n unit rows in blocks of bs,
    every `every`-th chunk's text in the lexical index."""
    for lo in range(0, n, bs):
        hi = min(lo + bs, n)
        emb = rng.standard_normal((hi - lo, D)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        metas = [meta_cls(id=f"c{i}", document_name=f"doc{i % 7}.pdf", text=f"synthetic chunk {i} alpha beta",
                          chunk_index=i, page_number=1) for i in range(lo, hi)]
        slots = eng.store.add_chunks(metas, emb)
        for m, s in list(zip(metas, slots))[::every]:
            eng.lexical_index.add_chunk(m.id, m.text, s)


def _fill(pair, seed, n=N, **kw):
    for eng, meta in zip(pair, (JMeta, TMeta)):
        _populate(eng, meta, np.random.default_rng(seed), n, **kw)
    return pair


def _rows(results):
    return [(r.chunk_id, r.score, r.embedding_score, r.lexical_score) for r in results]


def _same(got, want, what):
    """The same chunk ids in the same order, each score within SCORE_ATOL."""
    g, w = _rows(got), _rows(want)
    assert [r[0] for r in g] == [r[0] for r in w], what
    for a, b in zip(g, w):
        np.testing.assert_allclose([x if x is not None else np.nan for x in a[1:]],
                                   [x if x is not None else np.nan for x in b[1:]], rtol=0, atol=SCORE_ATOL,
                                   err_msg=f"{what} {a[0]}")


def _same_all(got, want, what):
    assert len(got) == len(want), what
    for qi, (a, b) in enumerate(zip(got, want)):
        _same(a, b, f"{what} query {qi}")


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The plain (unsharded) and the 4-shard engines of both packages."""
    root = tmp_path_factory.mktemp("sharded")
    plain = _fill(_pair(root / "plain", "shard-test"), 7)
    sharded = _fill(_pair(root / "shard", "shard-test", {"RAG_TPU_SHARD_CORPUS": "4"}), 7)
    assert sharded[0]._mesh is not None and sharded[1]._mesh is not None
    return plain, sharded


# -------------------------------------- tests/test_sharded_engine.py ----


def test_slab_is_row_sharded(engines):
    _, (j, t) = engines
    assert t.store.corpus().spec[0] == "corpus" == j.store.corpus().sharding.spec[0]
    assert t.store.valid_mask().spec[0] == "corpus"
    assert t._mesh.shape == {"corpus": 4} and t.store.corpus().n_shards == 4
    assert len(t.store.corpus().blocks()) == 4  # four shards on the one CPU
    # the slab in slot order, block by block, equals the JAX slab
    np.testing.assert_array_equal(t.store.corpus().full().numpy(), np.asarray(j.store.corpus()))
    np.testing.assert_array_equal(t.store.valid_mask().full().numpy(), np.asarray(j.store.valid_mask()))


def test_sharded_search_matches_unsharded(engines):
    (jp, tp), (js, ts) = engines
    for q in QUERIES:
        got = ts.search(q, 10)
        _same(got, js.search(q, 10), f"sharded vs JAX sharded: {q}")
        _same(got, tp.search(q, 10), f"sharded vs port unsharded: {q}")
        _same(got, jp.search(q, 10), f"sharded vs JAX unsharded: {q}")


def test_sharded_batch_and_diversity(engines):
    (_, tp), (js, ts) = engines
    qs = [f"synthetic query {i} alpha" for i in range(4)]
    got = ts.search_with_diversity_batch(qs, 8, 0.4)
    _same_all(got, js.search_with_diversity_batch(qs, 8, 0.4), "MMR vs JAX sharded")
    _same_all(got, tp.search_with_diversity_batch(qs, 8, 0.4), "MMR vs port unsharded")
    # 8 queries take the device MMR (_mmr_many) over rows gathered from shards
    qs8 = [f"synthetic query {i} alpha" for i in range(8)]
    _same_all(ts.search_with_diversity_batch(qs8, 5, 0.4), js.search_with_diversity_batch(qs8, 5, 0.4),
              "batched MMR vs JAX sharded")


def _int8_rows(n, seed, text="chunk {i} alpha"):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb, [dict(id=f"c{i}", document_name="d.pdf", text=text.format(i=i), chunk_index=i) for i in range(n)]


def _add(eng, meta_cls, emb, rows, lexical=False):
    metas = [meta_cls(**r) for r in rows]
    slots = eng.store.add_chunks(metas, emb)
    if lexical:
        for m, s in zip(metas, slots):
            eng.lexical_index.add_chunk(m.id, m.text, s)


def test_sharded_quantized_small_corpus_exact(tmp_path):
    """A candidate pool covering the corpus: the sharded int8 engine's
    f32-rescored ranking equals the unsharded int8 engine's and the JAX
    sharded int8 engine's."""
    emb, rows = _int8_rows(24, 3)
    _, tp = _pair(tmp_path / "p", "q-shard", {"RAG_TPU_INT8_CORPUS": "1"})
    js, ts = _pair(tmp_path / "s", "q-shard", {"RAG_TPU_INT8_CORPUS": "1", "RAG_TPU_SHARD_CORPUS": "4"})
    assert ts._mesh is not None and ts.store.quantized
    for eng, meta in ((tp, TMeta), (js, JMeta), (ts, TMeta)):
        _add(eng, meta, emb, rows)
    for q in ("chunk alpha", "chunk 5"):
        got = ts.search(q, 8)
        _same(got, tp.search(q, 8), f"int8 sharded vs unsharded: {q}")
        _same(got, js.search(q, 8), f"int8 sharded vs JAX: {q}")


def test_sharded_quantized_self_retrieval(tmp_path):
    """Candidate pool below the corpus: each stored vector retrieves itself
    first with score ~1 through the sharded int8 path, as in JAX."""
    emb, rows = _int8_rows(2048, 4, "chunk {i}")
    js, ts = _pair(tmp_path, "q-shard2", {"RAG_TPU_INT8_CORPUS": "1", "RAG_TPU_SHARD_CORPUS": "8"})
    _add(js, JMeta, emb, rows)
    _add(ts, TMeta, emb, rows)
    probe = emb[::500][:4]
    w = (1.0, 0.0)
    got = tss.sharded_hybrid_topk_quantized(
        torch.from_numpy(probe), ts.store.corpus(), ts.store.scales(), ts.store.l1(), ts.store.valid_mask(),
        torch.full((4, 512), -1, dtype=torch.int32), torch.zeros((4, 512)), torch.tensor(w[0]),
        torch.tensor(w[1]), 32, mesh=ts._mesh)
    want = jss.sharded_hybrid_topk_quantized(
        jnp.asarray(probe), js.store.corpus(), js.store.scales(), js.store.l1(), js.store.valid_mask(),
        jnp.full((4, 512), -1, dtype=jnp.int32), jnp.zeros((4, 512), dtype=jnp.float32), jnp.float32(w[0]),
        jnp.float32(w[1]), 32, mesh=js._mesh)
    top = got[3].numpy()[:, 0]
    assert (top == np.arange(0, 2000, 500)).all(), top
    assert np.allclose(got[1].numpy()[:, 0], 1.0, atol=2e-2)
    assert tuple(got[4].shape) == (4,)
    np.testing.assert_array_equal(got[3].numpy()[:, :4], np.asarray(want[3])[:, :4])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_sharded_embedding_candidates_match(engines):
    (_, tp), (js, ts) = engines
    got = ts.get_embedding_candidates("synthetic alpha beta", 6)
    assert [c.chunk_id for c in got] == [c.chunk_id for c in js.get_embedding_candidates("synthetic alpha beta", 6)]
    assert [c.chunk_id for c in got] == [c.chunk_id for c in tp.get_embedding_candidates("synthetic alpha beta", 6)]


def test_sharded_remove_document_stays_consistent(tmp_path):
    js, ts = _fill(_pair(tmp_path, "shard-rm", {"RAG_TPU_SHARD_CORPUS": "4"}), 7, n=1024)
    assert ts.search("synthetic alpha", 5)
    removed_j = js.store.remove_document("doc3.pdf")
    doomed = [m.id for _, m in ts.store.iter_meta() if m.document_name == "doc3.pdf"]
    assert ts.store.remove_ids(doomed) == removed_j > 0
    for cid in doomed:
        ts.lexical_index.remove_chunk(cid)
        js.lexical_index.remove_chunk(cid)
    after = ts.search("synthetic alpha", 5)
    assert after and all(r.document != "doc3.pdf" for r in after)
    _same(after, js.search("synthetic alpha", 5), "after removal vs JAX")
    assert ts.store.valid_mask().spec[0] == "corpus"
    np.testing.assert_array_equal(ts.store.valid_mask().full().numpy(), np.asarray(js.store.valid_mask()))


def test_composed_mesh_matches_unsharded(tmp_path, engines):
    """2 query replicas x 4 corpus shards on the 8 CPU positions."""
    (jp, tp), _ = engines
    jc, tc = _fill(_pair(tmp_path, "shard-test", {"RAG_TPU_SHARD_CORPUS": "4", "RAG_TPU_DATA_PARALLEL": "2"}), 7)
    assert tc._data_axis == jc._data_axis == "data" and tc._data_parallel == 2
    assert dict(zip(tc._mesh.axis_names, tc._mesh.devices.shape)) == {"data": 2, "corpus": 4}
    queries = [f"synthetic chunk {i * 131} alpha" for i in range(8)]
    got = tc.search_batch(queries, 10)
    _same_all(got, jc.search_batch(queries, 10), "composed vs JAX composed")
    _same_all(got, tp.search_batch(queries, 10), "composed vs port unsharded")
    # one query (padded to the replica count) and diversity
    one = tc.search(queries[0], 5)
    assert [r.chunk_id for r in one] == [r.chunk_id for r in got[0][:5]]
    _same(one, jc.search(queries[0], 5), "composed single vs JAX")
    _same_all(tc.search_with_diversity_batch(queries, 5, 0.4), jp.search_with_diversity_batch(queries, 5, 0.4),
              "composed MMR vs JAX unsharded")


@pytest.fixture(scope="module")
def sliced(tmp_path_factory):
    pair = _pair(tmp_path_factory.mktemp("sliced"), "slice-test", {"RAG_TPU_SHARD_CORPUS": "8",
                                                                    "RAG_TPU_SLICES": "2"})
    for eng in pair:
        assert eng._mesh is not None and eng._corpus_axes == ("slice", "corpus")
        assert dict(zip(eng._mesh.axis_names, eng._mesh.devices.shape)) == {"slice": 2, "corpus": 4}
    return _fill(pair, 7)


def test_sliced_slab_sharded_over_both_axes(sliced):
    j, t = sliced
    assert tuple(t.store.corpus().spec[0]) == ("slice", "corpus") == tuple(j.store.corpus().sharding.spec[0])
    assert t.store.corpus().n_shards == 8
    np.testing.assert_array_equal(t.store.corpus().full().numpy(), np.asarray(j.store.corpus()))


def test_sliced_search_matches_unsharded(engines, sliced):
    (_, tp), _ = engines
    js, ts = sliced
    for q in QUERIES:
        got = ts.search(q, 10)
        _same(got, js.search(q, 10), f"sliced vs JAX sliced: {q}")
        _same(got, tp.search(q, 10), f"sliced vs port unsharded: {q}")


def test_sliced_batch_and_diversity(engines, sliced):
    (jp, _), _ = engines
    js, ts = sliced
    qs = [f"synthetic query {i} alpha" for i in range(4)]
    got = ts.search_with_diversity_batch(qs, 8, 0.4)
    _same_all(got, js.search_with_diversity_batch(qs, 8, 0.4), "sliced MMR vs JAX sliced")
    _same_all(got, jp.search_with_diversity_batch(qs, 8, 0.4), "sliced MMR vs JAX unsharded")


def test_slices_must_divide_shards(tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        j, t = _pair(tmp_path, "slice-bad", {"RAG_TPU_SHARD_CORPUS": "8", "RAG_TPU_SLICES": "3"})
    assert t._corpus_axes == j._corpus_axes == "corpus"
    assert t._mesh is not None and t._mesh.shape == {"corpus": 8}
    warned = [r.getMessage() for r in caplog.records if "must divide" in r.getMessage()]
    assert len(warned) == 2 and warned[0] == warned[1]


def test_sliced_quantized_matches_flat_quantized(tmp_path):
    emb, rows = _int8_rows(64, 5)
    jf, tf = _pair(tmp_path / "f", "q-slice", {"RAG_TPU_INT8_CORPUS": "1", "RAG_TPU_SHARD_CORPUS": "8"})
    js, ts = _pair(tmp_path / "s", "q-slice", {"RAG_TPU_INT8_CORPUS": "1", "RAG_TPU_SHARD_CORPUS": "8",
                                               "RAG_TPU_SLICES": "2"})
    assert ts._corpus_axes == ("slice", "corpus") and ts.store.quantized
    for eng, meta in ((jf, JMeta), (tf, TMeta), (js, JMeta), (ts, TMeta)):
        _add(eng, meta, emb, rows)
    for q in ("chunk 7 alpha", "chunk 42 alpha"):
        got = ts.search(q, 8)
        _same(got, tf.search(q, 8), f"sliced int8 vs flat int8: {q}")
        _same(got, js.search(q, 8), f"sliced int8 vs JAX sliced int8: {q}")


def test_sliced_quantized_passes_composed_axes(tmp_path, monkeypatch):
    """The engine forwards corpus_axis=("slice", "corpus") to the
    quantized sharded search, so the hierarchical merge runs."""
    emb, rows = _int8_rows(32, 6, "chunk {i} beta")
    with _env({"RAG_TPU_INT8_CORPUS": "1", "RAG_TPU_SHARD_CORPUS": "8", "RAG_TPU_SLICES": "2"}):
        eng = TEngine(str(tmp_path), TService(THashEncoder(dim=D, model_name="q-spy")), device="cpu")
    _add(eng, TMeta, emb, rows)
    seen = {}
    real = tss.sharded_hybrid_topk_quantized

    def spy(*a, **kw):
        seen["corpus_axis"] = kw.get("corpus_axis", "corpus")
        return real(*a, **kw)

    monkeypatch.setattr(tss, "sharded_hybrid_topk_quantized", spy)
    assert eng.search("chunk 3 beta", 4)
    assert seen["corpus_axis"] == ("slice", "corpus")


def test_sliced_persistence_roundtrip(tmp_path):
    """A sliced engine's save is the unsharded format: the port's save
    reloads into an unsharded port engine and into the JAX engine, the
    JAX sliced engine's save into a sliced port engine, with the same
    rankings."""
    emb, rows = _int8_rows(64, 11)
    js, ts = _pair(tmp_path, "slice-persist", {"RAG_TPU_SHARD_CORPUS": "8", "RAG_TPU_SLICES": "2"})
    assert ts._corpus_axes == ("slice", "corpus")
    _add(js, JMeta, emb, rows, lexical=True)
    _add(ts, TMeta, emb, rows, lexical=True)
    want = ts.search("chunk 9 alpha", 5)
    _same(want, js.search("chunk 9 alpha", 5), "sliced before save vs JAX")
    ts.save_to_disk()
    js.save_to_disk()
    svc_t = TService(THashEncoder(dim=D, model_name="slice-persist"))
    svc_j = JService(HashEncoder(dim=D, model_name="slice-persist"))
    with _env({"RAG_TPU_NATIVE_BM25": "0"}):
        plain_t = TEngine(str(tmp_path / "port"), svc_t, device="cpu")
        plain_j = JEngine(str(tmp_path / "port"), svc_j)
    with _env({"RAG_TPU_SHARD_CORPUS": "8", "RAG_TPU_SLICES": "2"}):
        sliced_t = TEngine(str(tmp_path / "jax"), svc_t, device="cpu")
    assert plain_t._mesh is None and sliced_t._corpus_axes == ("slice", "corpus")
    for eng, what in ((plain_t, "port save, port unsharded"), (plain_j, "port save, JAX unsharded"),
                      (sliced_t, "JAX save, port sliced")):
        assert len(eng.store) == 64
        _same(eng.search("chunk 9 alpha", 5), want, what)
    emb_t, metas_t = ts.store.snapshot_host()
    emb_j, metas_j = js.store.snapshot_host()
    np.testing.assert_array_equal(emb_t, emb_j)
    assert [m.id for m in metas_t] == [m.id for m in metas_j]


# ----------------------------------- tests/test_int8_exact.py:185 ----


def _adversarial_corpus(n=4096, k_band=200, seed=3):
    """tests/test_int8_exact.py's corpus: k_band rows whose cosines to
    `base` sit in [0.7, 0.70002], narrower than the int8 query error."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(D).astype(np.float32)
    base /= np.linalg.norm(base)
    rows = []
    for i in range(n):
        noise = rng.standard_normal(D).astype(np.float32)
        noise -= noise @ base * base
        noise /= np.linalg.norm(noise)
        c = 0.7 + 2e-5 * rng.random() if i < k_band else 0.3 * rng.random()
        rows.append((c * base + np.sqrt(max(1 - c * c, 0.0)) * noise).astype(np.float32))
    return np.stack(rows), base


def test_sharded_escalation_exact(tmp_path):
    """The band's query fails its certificate on the sharded int8 engine,
    escalates through sharded_hybrid_topk_dequant_full, and equals a
    brute-force scan of the dequantised slab and the JAX sharded engine."""
    emb, base = _adversarial_corpus()
    js, ts = _pair(tmp_path, "int8-exact", {"RAG_TPU_INT8_CORPUS": "1", "RAG_TPU_SHARD_CORPUS": "8"})
    assert ts._mesh is not None
    rows = [dict(id=f"c{i}", document_name="d.pdf", text=f"adversarial row {i}", chunk_index=i)
            for i in range(emb.shape[0])]
    for eng, meta in ((js, JMeta), (ts, TMeta)):
        _add(eng, meta, emb, rows, lexical=True)
        eng.embedding_service._cache.put("adversarial probe", base)
    got = ts.search_batch(["adversarial probe"], 32, use_reranker=False)[0]
    assert ts.int8_escalations == 1
    values = ts.store.corpus().full().numpy().astype(np.float32)
    scales = ts.store.scales().full().numpy()[:, 0]
    scores = (values @ base) * scales
    scores[~ts.store.valid_mask().full().numpy()] = -np.inf
    true = set(np.argsort(-scores, kind="stable")[:32].tolist())
    assert {ts.store.slot_for_id(r.chunk_id) for r in got} == true
    want = js.search_batch(["adversarial probe"], 32, use_reranker=False)[0]
    assert {r.chunk_id for r in got} == {r.chunk_id for r in want}
    np.testing.assert_allclose(sorted(r.score for r in got), sorted(r.score for r in want), rtol=0, atol=SCORE_ATOL)
    # the object lane's MMR patches the escalated rows' similarities too
    _same(ts.search_with_diversity("adversarial probe", 8, 0.4, use_reranker=False),
          js.search_with_diversity("adversarial probe", 8, 0.4, use_reranker=False), "escalated MMR vs JAX")


# ------------------------------------------------ mesh construction ----


@pytest.mark.parametrize("env, want", [
    ({"RAG_TPU_SHARD_CORPUS": "16"}, None),  # more shards than devices: unsharded
    ({"RAG_TPU_DATA_PARALLEL": "2"}, None),  # replicas without shards: ignored
    ({"RAG_TPU_SHARD_CORPUS": "4", "RAG_TPU_DATA_PARALLEL": "4"}, {"corpus": 4}),  # 16 > 8: corpus only
    ({"RAG_TPU_SHARD_CORPUS": "1"}, None),
    ({"RAG_TPU_SHARD_CORPUS": "2", "RAG_TPU_DATA_PARALLEL": "2", "RAG_TPU_SLICES": "2"},
     {"data": 2, "slice": 2, "corpus": 1}),
    ({"RAG_TPU_SHARD_CORPUS": "8", "RAG_TPU_SLICES": "8"}, {"slice": 8, "corpus": 1}),
], ids=["too_many_shards", "dp_alone", "dp_beyond_devices", "one_shard", "all_three", "slices_only"])
def test_mesh_warnings_and_fallbacks_match_jax(tmp_path, caplog, env, want):
    """The JAX engine's warnings and fallbacks, message for message."""
    with caplog.at_level(logging.WARNING):
        j, t = _pair(tmp_path, "mesh-env", env)
    for eng in (j, t):
        got = None if eng._mesh is None else dict(zip(eng._mesh.axis_names, eng._mesh.devices.shape))
        assert got == want
    assert t._data_axis == j._data_axis and t._data_parallel == j._data_parallel
    assert t._corpus_axes == j._corpus_axes
    msgs = [r.getMessage() for r in caplog.records if r.levelno >= logging.WARNING and "RAG_TPU_" in r.getMessage()]
    assert len(msgs) % 2 == 0 and msgs[: len(msgs) // 2] == msgs[len(msgs) // 2:]


def test_engine_mesh_devices_come_from_available_devices(tmp_path, monkeypatch):
    """available_devices is the engine's one source of devices: replacing
    it (the smoke stands several shards on one card this way) shapes the
    mesh."""
    seen = []

    def four(device):
        seen.append(torch.device(device))
        return [torch.device("cpu")] * 4

    monkeypatch.setattr(tmesh, "available_devices", four)
    with _env({"RAG_TPU_SHARD_CORPUS": "8"}):
        t8 = TEngine(str(tmp_path / "a"), TService(THashEncoder(dim=D)), device="cpu")
    with _env({"RAG_TPU_SHARD_CORPUS": "4"}):
        t4 = TEngine(str(tmp_path / "b"), TService(THashEncoder(dim=D)), device="cpu")
    assert t8._mesh is None and t4._mesh.shape == {"corpus": 4}
    assert seen == [torch.device("cpu")] * 2


# ------------------------------------------------------ sharded store ----


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("layout", [((4,), ("corpus",), "corpus"), ((2, 4), ("slice", "corpus"), ("slice", "corpus")),
                                    ((2, 4), ("data", "corpus"), "corpus")], ids=["flat", "slices", "data"])
def test_sharded_store_matches_jax_through_mutations(layout, quantized):
    """Adds, frees, hole refills, growth (capacity 8 -> 32: slots move
    between shards), compaction and snapshots: the slab, mask, scales and
    l1 in slot order equal the JAX sharded store's bit for bit, and every
    shard's block is its row range."""
    sizes, names, axis = layout
    n_dev = int(np.prod(sizes))
    jm = jbuild_mesh(sizes, names, devices=jax.devices()[:n_dev])
    tm = tmesh.build_mesh(sizes, names, devices=[torch.device("cpu")] * n_dev)
    j = JStore(dim=D, initial_capacity=6, quantized=quantized, mesh=jm, corpus_axis=axis)
    t = TStore(D, initial_capacity=6, device="cpu", quantized=quantized, mesh=tm, corpus_axis=axis)
    assert t.capacity == j.capacity == 8
    rng = np.random.default_rng(12)
    step = 0

    def add(n):
        nonlocal step
        emb = rng.standard_normal((n, D)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        ids = [f"c{step}_{i}" for i in range(n)]
        step += 1
        assert (j.add_chunks([JMeta(id=c, document_name="d", text=c, chunk_index=0) for c in ids], emb)
                == t.add_chunks([TMeta(id=c, document_name="d", text=c, chunk_index=0) for c in ids], emb))
        return ids

    def check():
        names_ = ("corpus", "valid_mask") + (("scales", "l1") if quantized else ())
        for name in names_:
            a, b = getattr(t, name)(), getattr(j, name)()
            np.testing.assert_array_equal(a.full().numpy(), np.asarray(b), err_msg=name)
            for blk, s in a.blocks():
                np.testing.assert_array_equal(blk.numpy(), a.full().numpy()[s * a.rows:(s + 1) * a.rows])

    first = add(7)
    check()
    assert j.remove_ids(first[1:5]) == t.remove_ids(first[1:5]) == 4
    add(2)
    add(20)
    assert t.capacity == j.capacity == 32
    check()
    j.compact()
    t.compact()
    check()
    je, jmetas = j.snapshot_host()
    te, tmetas = t.snapshot_host()
    np.testing.assert_array_equal(te, je)
    assert [m.id for m in tmetas] == [m.id for m in jmetas]
    slots = torch.tensor([[0, 5], [24, 3]])
    want = np.asarray(j.corpus())[slots.numpy()].astype(np.float32)
    if quantized:
        want = want * np.asarray(j.scales())[slots.numpy()]
    np.testing.assert_array_equal(t.gather_rows(slots).float().numpy(), want)


# ---------------------------------------------------------- batcher ----


SHARDED_ENVS = {
    "shard4": {"RAG_TPU_SHARD_CORPUS": "4"},
    "composed": {"RAG_TPU_SHARD_CORPUS": "4", "RAG_TPU_DATA_PARALLEL": "2"},
    "sliced": {"RAG_TPU_SHARD_CORPUS": "8", "RAG_TPU_SLICES": "2"},
    "int8": {"RAG_TPU_SHARD_CORPUS": "4", "RAG_TPU_INT8_CORPUS": "1"},
}


@pytest.fixture(scope="module", params=list(SHARDED_ENVS))
def rerank_pair(tmp_path_factory, request):
    """Sharded engines of both packages with the FakeReranker under each
    sharded environment."""
    pair = _pair(tmp_path_factory.mktemp("rr"), "shard-rr", SHARDED_ENVS[request.param], reranker=True)
    assert pair[0]._mesh is not None and pair[1]._mesh is not None
    return _fill(pair, 9, n=2048, every=5)


LANES = {
    "hot": dict(diversity=0.0, use_reranker=False),
    "mmr": dict(diversity=0.3, use_reranker=False),
    "judged": dict(diversity=0.0, use_reranker=True, weights=(0.0, 1.0)),
    "object": dict(diversity=0.0, use_reranker=True),
    "object_mmr": dict(diversity=0.3, use_reranker=True),
}


@pytest.mark.parametrize("lane", list(LANES))
def test_batcher_sends_every_lane_down_the_object_lane(rerank_pair, lane, monkeypatch):
    """A sharded engine declines the columnar lanes (supports_columnar is
    False), so the batcher answers every request through
    search_with_diversity_batch, as the JAX batcher does; answers equal
    the JAX batcher's over the JAX sharded engine."""
    j, t = rerank_pair
    assert not t.supports_columnar() and not j.supports_columnar()
    assert not t.supports_columnar_mmr() and not t.supports_judged_columnar(TWeights(reranker=0.0, initial=1.0), True)
    assert t.dispatch_search(["x"], 5) is None and t.dispatch_search_mmr(["x"], 5, 0.3) is None
    p = dict(LANES[lane])
    wt = p.pop("weights", None)
    calls = []
    for name in ("dispatch_search", "dispatch_search_mmr", "judge_columnar"):
        monkeypatch.setattr(t, name, lambda *a, _n=name, **kw: calls.append(_n))
    real = t.search_with_diversity_batch
    monkeypatch.setattr(t, "search_with_diversity_batch",
                        lambda *a, **kw: calls.append("object") or real(*a, **kw))
    queries = [f"synthetic chunk {i * 17} alpha" for i in range(6)]
    tb, jb = TBatcher(t, TLock(), window_ms=30), JBatcher(j, JLock(), window_ms=30)
    try:
        tw = TWeights(reranker=wt[0], initial=wt[1]) if wt else None
        jw = JWeights(reranker=wt[0], initial=wt[1]) if wt else None
        got = [f.result(timeout=120) for f in [tb.submit(q, 5, p["diversity"], tw, use_reranker=p["use_reranker"])
                                               for q in queries]]
        want = [f.result(timeout=120) for f in [jb.submit(q, 5, p["diversity"], jw, use_reranker=p["use_reranker"])
                                                for q in queries]]
    finally:
        tb.stop()
        jb.stop()
    assert calls and set(calls) == {"object"}
    _same_all(got, want, f"{lane} lane vs JAX batcher")
