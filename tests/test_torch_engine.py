"""The port's engine and micro-batcher against the JAX engine and batcher.

Both engines ingest the same PDFs with the same deterministic hash
encoder, so their slabs hold identical f32 rows; both use the pure-Python
BM25 index (the port's is a copy of it). Results are compared by
(document, chunk_index): same sets, scores within SCORE_TOL (f32 dots of
unit vectors summed in another order, and XLA's CPU FMA contraction of
the blend: a few ulps), order free only among scores tied within it.
Slab capacity 65536 sends both through their score + segment-max branch
(Pallas in interpret mode, the port's plain version on the CPU).
"""

import threading

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import pdfgen
from rust_local_rag_tpu.engine.chunk_store import ChunkStore as JStore
from rust_local_rag_tpu.engine.rag_engine import RagEngine as JEngine
from rust_local_rag_tpu.models.embedding_service import EmbeddingService as JService
from rust_local_rag_tpu.models.fake_encoder import HashEncoder
from rust_local_rag_tpu.server.batcher import SearchBatcher as JBatcher
from rust_local_rag_tpu.utils.rwlock import RwLock as JLock
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkStore as TStore
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine as TEngine
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService as TService
from rust_local_rag_tpu_torch.ops import score_segmax as tss
from rust_local_rag_tpu_torch.server.batcher import SearchBatcher as TBatcher
from rust_local_rag_tpu_torch.utils.rwlock import RwLock as TLock

DIM = 64
SCORE_TOL = 1e-5

TOPICS = [
    "pump seal leak shaft impeller housing gasket",
    "valve actuator pressure relief setpoint spring",
    "motor bearing vibration temperature lubrication grease",
    "controller firmware alarm fault reset parameter",
    "filter strainer clogging differential pressure cleaning",
]


def _doc(i, rng):
    pages = []
    for p in range(3):
        paras = [f"SECTION {i}.{p}"]
        for _ in range(4):
            words = rng.choice(" ".join(TOPICS).split(), 60)
            sents = [" ".join(words[k : k + 12]).capitalize() + "." for k in range(0, 60, 12)]
            paras.append(f"{TOPICS[i % len(TOPICS)]} " + " ".join(sents))
        pages.append("\n\n".join(paras))
    return pdfgen.make_pdf(pages, compress=bool(i % 2))


QUERIES = [
    "pump seal leak",
    "valve pressure setpoint",
    "motor bearing grease temperature",
    "reset the controller alarm",
    "clogged strainer",
    "impeller housing",
    "firmware parameter fault",
    "words the corpus never saw",
    "relief spring",
    "vibration",
]


@pytest.fixture
def engines(tmp_path, monkeypatch, request):
    """(jax_engine, port_engine) over the same documents; the slab capacity
    is request.param (default 1024)."""
    monkeypatch.setenv("RAG_TPU_NATIVE_BM25", "0")
    capacity = getattr(request, "param", 1024)
    j = JEngine(str(tmp_path / "jax"), JService(HashEncoder(dim=DIM)))
    t = TEngine(str(tmp_path / "port"), TService(HashEncoder(dim=DIM)), device="cpu")
    j.store = JStore(dim=DIM, initial_capacity=capacity)
    t.store = TStore(DIM, initial_capacity=capacity, device="cpu")
    rng = np.random.default_rng(5)
    for i in range(6):
        data = _doc(i, rng)
        assert j.add_document(f"doc{i}.pdf", data) == t.add_document(f"doc{i}.pdf", data) > 0
    return j, t


def _rows(results):
    return [
        ((r.document, r.chunk_index), r.score, r.embedding_score, r.lexical_score)
        for r in results
    ]


def _same(got, want, what):
    """Same sets and scores within SCORE_TOL; a row on one side only must
    tie with the last score within SCORE_TOL."""
    assert len(got) == len(want), what
    if not got:
        return
    gs = sorted((r[1] for r in got), reverse=True)
    ws = sorted((r[1] for r in want), reverse=True)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_TOL, err_msg=what)
    g, w = {r[0]: r for r in got}, {r[0]: r for r in want}
    floor = min(gs[-1], ws[-1])
    for key in set(g) ^ set(w):
        assert (g.get(key) or w.get(key))[1] - floor <= SCORE_TOL, what
    for key in set(g) & set(w):
        np.testing.assert_allclose(g[key][1:], w[key][1:], rtol=0, atol=SCORE_TOL, err_msg=what)


def _through(batcher, queries, top_k, **kw):
    futs = [batcher.submit(q, top_k, 0.0, None, use_reranker=False, **kw) for q in queries]
    return [f.result(timeout=60) for f in futs]


@pytest.mark.parametrize("engines", [1024, 65536], indirect=True)
@pytest.mark.parametrize("top_k", [3, 10])
def test_batcher_hot_lane_matches_jax(engines, top_k):
    j, t = engines
    assert len(j.store) == len(t.store) and t.store.capacity == j.store.capacity
    jb = JBatcher(j, JLock(), window_ms=20)
    tb = TBatcher(t, TLock(), window_ms=20)
    try:
        want = _through(jb, QUERIES, top_k)
        got = _through(tb, QUERIES, top_k)
    finally:
        jb.stop()
        tb.stop()
    for q, a, b in zip(QUERIES, got, want):
        assert len(a) == top_k
        _same(_rows(a), _rows(b), q)


def test_search_batch_matches_jax_and_hot_lane(engines):
    j, t = engines
    want = j.search_batch(QUERIES, 5, use_reranker=False)
    got = t.search_batch(QUERIES, 5, use_reranker=False)
    for q, a, b in zip(QUERIES, got, want):
        _same(_rows(a), _rows(b), q)
    hot = t.results_from_columnar(t.fetch_columnar(t.dispatch_search(QUERIES[:1], 5)), 0)
    _same(_rows(hot), _rows(got[0]), "hot lane vs search_batch")
    a, b = got[0][0], want[0][0]
    assert (a.text, a.document, a.page_number, a.section, a.initial_score) == (
        b.text, b.document, b.page_number, b.section, b.initial_score
    )


@pytest.mark.parametrize(
    "kw",
    [
        {"rejection_threshold": 0.3},
        {"rejection_cosine_floor": 0.5},
        {"rejection_unseen_mass": 0.5, "rejection_unseen_cos": 0.9},
        {"rejection_unseen_mass": 0.5, "rejection_unseen_cos": 0.0},
    ],
)
def test_rejection_gates_match_jax(engines, kw):
    j, t = engines
    for q in QUERIES:
        pj = j.dispatch_search([q], 10, **kw)
        pt = t.dispatch_search([q], 10, **kw)
        a = t.results_from_columnar(t.fetch_columnar(pt), 0)
        b = j.results_from_columnar(j.fetch_columnar(pj), 0)
        _same(_rows(a), _rows(b), f"{q} {kw}")


def test_top_k_beyond_live_chunks(engines):
    j, t = engines
    n = len(t.store)
    a = t.search("pump", n + 50)
    b = j.search("pump", n + 50, use_reranker=False)
    assert len(a) == len(b) == n
    _same(_rows(a), _rows(b), "k > n")


@pytest.mark.parametrize("engines", [65536], indirect=True)
def test_kernel_branch_counts_only_cuda_launches(engines):
    """On CPU tensors the 65536-row slab takes the plain version: no launch."""
    _, t = engines
    assert t.store.capacity == 65536
    before = tss.score_segmax.launches
    t.search_batch(QUERIES[:2], 4)
    assert tss.score_segmax.launches == before


def test_reload_and_jax_index_interchange(engines, tmp_path):
    j, t = engines
    t.save_to_disk()
    j.save_to_disk()
    t2 = TEngine(t.data_dir, t.embedding_service, device="cpu")
    from_jax = TEngine(j.data_dir, t.embedding_service, device="cpu")
    assert len(t2.store) == len(from_jax.store) == len(t.store)
    want = t.search_batch(QUERIES, 5)
    for q, a, b, c in zip(QUERIES, t2.search_batch(QUERIES, 5), from_jax.search_batch(QUERIES, 5), want):
        _same(_rows(a), _rows(c), f"reload {q}")
        _same(_rows(b), _rows(c), f"jax npz {q}")
    assert t2.document_hashes == t.document_hashes == from_jax.document_hashes
    assert t2.get_stats() == {
        "documents": 6, "chunks": len(t.store), "status": "ready",
        "embedding_model": "fake-hash-encoder", "reranker_model": None, "search_mode": "exact",
    }


def test_add_document_replace_and_skip(engines):
    j, t = engines
    data = pdfgen.make_pdf(["SECTION\n\nA brand new pump manual replaces doc zero entirely. " * 8])
    assert t.add_document("doc0.pdf", data) == j.add_document("doc0.pdf", data) > 0
    assert t.add_document("doc0.pdf", data) == 0  # unchanged: hash skip
    assert len(t.store) == len(j.store)
    assert t.store.high_water == j.store.high_water  # freed slots were refilled
    assert sorted(t.list_documents()) == sorted(j.list_documents())
    for q in ("brand new pump manual", "valve"):
        _same(_rows(t.search(q, 5)), _rows(j.search(q, 5, use_reranker=False)), q)


def test_batcher_other_lanes_raise_and_empty_store(tmp_path):
    t = TEngine(str(tmp_path), TService(HashEncoder(dim=DIM)), device="cpu")
    b = TBatcher(t, TLock(), window_ms=1)
    try:
        assert b.search("anything", 5, 0.0, None, use_reranker=False) == []
        with pytest.raises(NotImplementedError, match="MMR"):
            b.search("anything", 5, 0.3, None, use_reranker=False)
        with pytest.raises(NotImplementedError, match="reranker"):
            b.search("anything", 5, 0.0, None, use_reranker=True)
    finally:
        b.stop()


def test_batcher_coalesces_concurrent_requests(engines):
    _, t = engines
    sizes = []
    dispatch = t.dispatch_search

    def recording(queries, *a, **kw):
        sizes.append(len(queries))
        return dispatch(queries, *a, **kw)

    t.dispatch_search = recording
    b = TBatcher(t, TLock(), window_ms=50, max_batch=4)
    results = {}
    try:
        threads = [
            threading.Thread(target=lambda q=q: results.setdefault(q, b.search(q, 3, 0.0, None, use_reranker=False)))
            for q in QUERIES
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    finally:
        b.stop()
    assert len(results) == len(QUERIES) and sum(sizes) == len(QUERIES)
    assert max(sizes) <= 4 and len(sizes) < len(QUERIES)
    assert torch.is_tensor(t.store.corpus())
