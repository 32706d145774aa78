"""The port's int8 capacity mode (RAG_TPU_INT8_CORPUS) against the JAX
package's: port twins of tests/test_int8_engine.py and
tests/test_int8_exact.py (without the sharded case), engine to engine.

Both engines ingest the same PDFs with the same hash encoder, so their
int8 stores must hold bit-identical values, scales and l1. Results are
compared by (document, chunk_index): same sets, scores within SCORE_TOL
= 1e-5 (f32 rescoring dots summed in another order and XLA's CPU FMA
contraction of the blend and of the certificate's upper bound, a few ulps,
carried through the rerank lanes' normalisations), order free only among
scores tied within it. The rerank lanes hold the JAX package's
FakeReranker in both engines' services, so the judge gives identical
logprobs. Slab capacity 65,536 sends the first stage through the
segmented selection, 1,024 through a full top-k. The adversarial band is
tests/test_int8_exact.py's, widened to 600 rows so that every lane's
candidate pool (up to 512 rows) lies inside it: a query whose
certificate must fail, so the engines escalate to the full-f32 lane,
which must equal a brute-force scan of the dequantised slab.
"""

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import pdfgen
from rust_local_rag_tpu.config import QueryWeights as JWeights
from rust_local_rag_tpu.engine.chunk_store import ChunkMeta as JMeta
from rust_local_rag_tpu.engine.chunk_store import ChunkStore as JStore
from rust_local_rag_tpu.engine.rag_engine import RagEngine as JEngine
from rust_local_rag_tpu.models.embedding_service import EmbeddingService as JService
from rust_local_rag_tpu.models.fake_encoder import HashEncoder
from rust_local_rag_tpu.models.reranker import FakeReranker
from rust_local_rag_tpu.models.reranker_service import RerankerService as JRerankerService
from rust_local_rag_tpu_torch.config import QueryWeights as TWeights
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta as TMeta
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkStore as TStore
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine as TEngine
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService as TService
from rust_local_rag_tpu_torch.models.fake_encoder import HashEncoder as THashEncoder
from rust_local_rag_tpu_torch.models.reranker_service import RerankerService as TRerankerService
from rust_local_rag_tpu_torch.server.batcher import SearchBatcher as TBatcher
from rust_local_rag_tpu_torch.utils.rwlock import RwLock as TLock

DIM = 64
SCORE_TOL = 1e-5
BAND_QUERY = "adversarial probe"

TOPICS = [
    "pump seal leak shaft impeller housing gasket",
    "valve actuator pressure relief setpoint spring",
    "motor bearing vibration temperature lubrication grease",
    "controller firmware alarm fault reset parameter",
    "filter strainer clogging differential pressure cleaning",
]

QUERIES = [
    "pump seal leak",
    "valve pressure setpoint",
    "motor bearing grease temperature",
    "reset the controller alarm",
    "clogged strainer",
    "impeller housing",
    "words the corpus never saw",
    "relief spring",
    "vibration",
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


def _pair(root, monkeypatch, int8=True, reranker=False, capacity=1024, docs=6):
    """(jax_engine, port_engine) over the same documents, int8 stores of
    `capacity` slots unless int8 is False."""
    monkeypatch.setenv("RAG_TPU_NATIVE_BM25", "0")
    if int8:
        monkeypatch.setenv("RAG_TPU_INT8_CORPUS", "1")
    else:
        monkeypatch.delenv("RAG_TPU_INT8_CORPUS", raising=False)
    j = JEngine(str(root / "jax"), JService(HashEncoder(dim=DIM)),
                reranker=JRerankerService(FakeReranker()) if reranker else None)
    t = TEngine(str(root / "port"), TService(THashEncoder(dim=DIM)),
                reranker=TRerankerService(FakeReranker()) if reranker else None, device="cpu")
    assert j.store.quantized is t.store.quantized is int8
    j.store = JStore(dim=DIM, initial_capacity=capacity, quantized=int8)
    t.store = TStore(DIM, initial_capacity=capacity, device="cpu", quantized=int8)
    rng = np.random.default_rng(5)
    for i in range(docs):
        data = _doc(i, rng)
        assert j.add_document(f"doc{i}.pdf", data) == t.add_document(f"doc{i}.pdf", data) > 0
    return j, t


@pytest.fixture(params=[1024, 65536], ids=["topk", "segmented"])
def engines(tmp_path, monkeypatch, request):
    return _pair(tmp_path, monkeypatch, capacity=request.param)


@pytest.fixture
def rerank_engines(tmp_path, monkeypatch):
    return _pair(tmp_path, monkeypatch, reranker=True, capacity=65536)


def _rows(results):
    return [
        ((r.document, r.chunk_index), r.score, r.embedding_score, r.lexical_score, r.reranker_score)
        for r in results
    ]


def _same(got, want, what, ordered=False):
    """Same result sets (or sequences, `ordered`), scores within SCORE_TOL;
    a row on one side only must tie with the last score."""
    assert len(got) == len(want), what
    if not got:
        return
    if ordered:
        assert [r[0] for r in got] == [r[0] for r in want], what
    gs = sorted((r[1] for r in got), reverse=True)
    ws = sorted((r[1] for r in want), reverse=True)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_TOL, err_msg=what)
    g, w = {r[0]: r for r in got}, {r[0]: r for r in want}
    floor = min(gs[-1], ws[-1])
    for key in set(g) ^ set(w):
        assert (g.get(key) or w.get(key))[1] - floor <= SCORE_TOL, what
    for key in set(g) & set(w):
        a = [x if x is not None else np.nan for x in g[key][1:]]
        b = [x if x is not None else np.nan for x in w[key][1:]]
        np.testing.assert_allclose(a, b, rtol=0, atol=SCORE_TOL, err_msg=what)


def _store_arrays(store, torch_store: bool):
    conv = (lambda x: x.cpu().numpy()) if torch_store else np.asarray
    return [conv(x) for x in (store.corpus(), store.scales(), store.l1(), store.valid_mask())]


def _assert_same_store(t_store, j_store):
    for name, a, b in zip(("values", "scales", "l1", "mask"), _store_arrays(t_store, True),
                          _store_arrays(j_store, False)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------- store ----


def test_store_bit_identical_through_every_mutation():
    """Values, scales and l1 equal the JAX store's bit for bit after adds,
    frees, hole refills, growth and compaction; snapshots dequantise
    identically."""
    rng = np.random.default_rng(11)

    def rows(n):
        m = rng.standard_normal((n, DIM)).astype(np.float32)
        m[0, :3] = [0.5, -1.5, 2.5]  # halves after scaling: round half to even
        return m / np.linalg.norm(m, axis=1, keepdims=True)

    j = JStore(dim=DIM, initial_capacity=16, quantized=True)
    t = TStore(DIM, initial_capacity=16, device="cpu", quantized=True)
    assert t.corpus().dtype == torch.int8 and t.quantized
    step = 0

    def add(n):
        nonlocal step
        emb = rows(n)
        ids = [f"c{step}_{i}" for i in range(n)]
        step += 1
        js = j.add_chunks([JMeta(id=c, document_name="d", text=c, chunk_index=i) for i, c in enumerate(ids)], emb)
        ts = t.add_chunks([TMeta(id=c, document_name="d", text=c, chunk_index=i) for i, c in enumerate(ids)], emb)
        assert js == ts
        return ids

    first = add(10)
    _assert_same_store(t, j)
    assert j.remove_ids(first[2:7]) == t.remove_ids(first[2:7]) == 5
    add(3)  # refills holes
    add(40)  # grows 16 -> 64
    assert t.capacity == j.capacity == 64
    _assert_same_store(t, j)
    j.compact()
    t.compact()
    _assert_same_store(t, j)
    je, jm = j.snapshot_host()
    te, tm = t.snapshot_host()
    np.testing.assert_array_equal(te, je)
    assert [m.id for m in tm] == [m.id for m in jm]
    np.testing.assert_array_equal(t.quantized_corpus().values.numpy(), np.asarray(j.quantized_corpus().values))
    plain = TStore(DIM, device="cpu")
    for fn in (plain.scales, plain.l1, plain.quantized_corpus):
        with pytest.raises(RuntimeError, match="not quantized"):
            fn()


def test_engine_store_bit_identical(engines):
    j, t = engines
    assert t.store.corpus().dtype == torch.int8 and len(t.store) == len(j.store)
    _assert_same_store(t.store, j.store)


# ---------------------------------------------------------------- lanes ----


def test_rankings_match_f32(tmp_path, monkeypatch):
    """tests/test_int8_engine.py::test_int8_rankings_match_f32 on the port."""
    _, t8 = _pair(tmp_path / "a", monkeypatch)
    _, t32 = _pair(tmp_path / "b", monkeypatch, int8=False)
    for query in QUERIES[:6]:
        r8, r32 = t8.search(query, 3, use_reranker=False), t32.search(query, 3, use_reranker=False)
        assert [(x.document, x.chunk_index) for x in r8] == [(x.document, x.chunk_index) for x in r32], query
        for a, b in zip(r8, r32):
            assert a.embedding_score == pytest.approx(b.embedding_score, abs=2e-2)


@pytest.mark.parametrize("top_k", [3, 10, 40])
def test_search_batch_and_hot_lane_match_jax(engines, top_k):
    j, t = engines
    want = j.search_batch(QUERIES, top_k, use_reranker=False)
    got = t.search_batch(QUERIES, top_k, use_reranker=False)
    for q, a, b in zip(QUERIES, got, want):
        _same(_rows(a), _rows(b), f"search_batch {q}")
    pj, pt = j.dispatch_search(QUERIES, top_k), t.dispatch_search(QUERIES, top_k)
    assert tuple(pt.out.shape) == (16, 5, pt.kb)  # the certificate is channel 4
    cj, ct = j.fetch_columnar(pj), t.fetch_columnar(pt)
    for qi, q in enumerate(QUERIES):
        _same(_rows(t.results_from_columnar(ct, qi)), _rows(j.results_from_columnar(cj, qi)), f"hot lane {q}")
    assert t.int8_escalations == 0


def test_mmr_takes_the_object_lane(engines):
    """An int8 store keeps MMR on the object lane (dequantised rows): no
    MMR hot lane, and the batcher's MMR request answers as
    search_with_diversity_batch does."""
    j, t = engines
    assert not t.supports_columnar_mmr() and not j.supports_columnar_mmr()
    assert t.dispatch_search_mmr(QUERIES, 5, 0.3) is None
    tb = TBatcher(t, TLock(), window_ms=20)
    try:
        futs = [tb.submit(q, 5, 0.3, None, use_reranker=False) for q in QUERIES]
        got = [f.result(timeout=60) for f in futs]
    finally:
        tb.stop()
    want = j.search_with_diversity_batch(QUERIES, 5, 0.3, use_reranker=False)
    for q, a, b in zip(QUERIES, got, want):
        _same(_rows(a), _rows(b), f"batcher MMR {q}", ordered=True)


@pytest.mark.parametrize("route", ["host", "batch_device", "device"])
def test_diversity_paths_match_jax(engines, monkeypatch, route):
    """The object lane's MMR on dequantised rows: the host greedy over the
    first stage's similarities (< 8 queries), _mmr_many (batched, forced
    with RAG_TPU_BATCH_DEVICE_MMR) and _mmr_one (RAG_TPU_DEVICE_MMR)."""
    j, t = engines
    if route == "host":
        monkeypatch.setenv("RAG_TPU_BATCH_DEVICE_MMR", "0")
    elif route == "batch_device":
        monkeypatch.setenv("RAG_TPU_BATCH_DEVICE_MMR", "1")
    else:
        monkeypatch.setattr(j, "_device_mmr", True)
        monkeypatch.setattr(t, "_device_mmr", True)
    for top_k in (2, 10):
        want = j.search_with_diversity_batch(QUERIES, top_k, 0.4, use_reranker=False)
        got = t.search_with_diversity_batch(QUERIES, top_k, 0.4, use_reranker=False)
        for q, a, b in zip(QUERIES, got, want):
            _same(_rows(a), _rows(b), f"{route} MMR {q} k{top_k}", ordered=True)


def test_rerank_lanes_match_jax(rerank_engines):
    """The object lane (0.7 / 0.3 blend), its MMR, and the judge-gated
    lane (reranker weight 0) through dispatch_search -> judge_columnar ->
    fetch_judged on the int8 first stage."""
    j, t = rerank_engines
    want = j.search_batch(QUERIES, 5)
    got = t.search_batch(QUERIES, 5)
    for q, a, b in zip(QUERIES, got, want):
        assert all(r.reranker_score is not None for r in a)
        _same(_rows(a), _rows(b), f"object {q}")
    res = t.search_with_diversity("pump seal leak", 3, 0.4)
    assert res and res[0].reranker_score is not None
    _same(_rows(res), _rows(j.search_with_diversity("pump seal leak", 3, 0.4)), "object MMR", ordered=True)
    gate = {"rejection_unseen_mass": 0.5, "rejection_unseen_cos": 0.45}
    jw, tw = JWeights(reranker=0.0, initial=1.0), TWeights(reranker=0.0, initial=1.0)
    assert t.supports_judged_columnar(tw, True)
    jc = j.fetch_judged(j.judge_columnar(j.dispatch_search(QUERIES, 5, jw), QUERIES, jw, **gate))
    tc = t.fetch_judged(t.judge_columnar(t.dispatch_search(QUERIES, 5, tw), QUERIES, tw, **gate))
    for qi, q in enumerate(QUERIES):
        _same(_rows(t.results_from_judged(tc, qi)), _rows(j.results_from_judged(jc, qi)), f"judged {q}")
    assert t.rerank_fallbacks == 0 and t.int8_escalations == 0


def test_get_embedding_candidates_match_jax(engines):
    j, t = engines
    for q in QUERIES[:4]:
        a, b = t.get_embedding_candidates(q, 7), j.get_embedding_candidates(q, 7)
        assert len(a) == len(b) == 7
        scores = [c.initial_score for c in a]
        assert scores == sorted(scores, reverse=True)
        key = lambda c: (c.document, c.text)  # noqa: E731
        assert {key(c) for c in a} == {key(c) for c in b}
        np.testing.assert_allclose(scores, [c.initial_score for c in b], atol=SCORE_TOL, rtol=0)


def test_stats_report_exact(engines):
    j, t = engines
    assert t.get_stats() == j.get_stats()
    assert t.get_stats()["search_mode"] == "exact"


# ----------------------------------------------------------- persistence ----


def test_persistence_round_trip_both_ways(tmp_path, monkeypatch):
    """A save dequantises and a load quantises again (renormalised rows can
    move a scale, and so l1, by an ulp). The port's reload of its own save
    equals the JAX package's reload of it bit for bit, and the other way
    round; answers hold across the reload within the int8 error budget
    (tests/test_int8_engine.py's 2e-3)."""
    j, t = _pair(tmp_path, monkeypatch)
    before = t.search("pump seal leak", 3, use_reranker=False)
    svc_t, svc_j = TService(THashEncoder(dim=DIM)), JService(HashEncoder(dim=DIM))
    for src in ("port", "jax"):
        t2 = TEngine(str(tmp_path / src), svc_t, device="cpu")
        j2 = JEngine(str(tmp_path / src), svc_j)
        assert t2.store.quantized and len(t2.store) == len(j2.store) == len(t.store)
        _assert_same_store(t2.store, j2.store)
    after = TEngine(str(tmp_path / "port"), svc_t, device="cpu").search("pump seal leak", 3, use_reranker=False)
    assert [(r.document, r.chunk_index) for r in before] == [(r.document, r.chunk_index) for r in after]
    np.testing.assert_allclose([r.score for r in before], [r.score for r in after], atol=2e-3)
    # a second load replaces the resident index (no duplicated ids) and
    # keeps the int8 store, as does a switch of the embedding model
    t2.load_from_disk()
    assert t2.store.quantized and len(t2.store) == len(t.store)
    t2.switch_embedding_model(TService(THashEncoder(dim=32, model_name="int8-other")))
    assert t2.store.quantized and t2.store.dim == 32 and len(t2.store) == 0


def test_int8_engine_without_card_raises(tmp_path, monkeypatch):
    """No fallback that hides the device: an int8 engine asked for the card
    raises where there is none."""
    monkeypatch.setenv("RAG_TPU_INT8_CORPUS", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TEngine(str(tmp_path), TService(THashEncoder(dim=DIM)))
    with pytest.raises(RuntimeError, match="cuda"):
        TStore(DIM, quantized=True)


# --------------------------------------------------------- exactness -------


def _adversarial_corpus(n=4000, k_band=600, seed=3):
    """tests/test_int8_exact.py's corpus with a band of k_band rows whose
    cosines to `base` sit in [0.7, 0.70002], narrower than the int8 query
    error bound."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(DIM).astype(np.float32)
    base /= np.linalg.norm(base)
    rows = []
    for i in range(n):
        noise = rng.standard_normal(DIM).astype(np.float32)
        noise -= noise @ base * base
        noise /= np.linalg.norm(noise)
        c = 0.7 + 2e-5 * rng.random() if i < k_band else 0.3 * rng.random()
        rows.append((c * base + np.sqrt(max(1 - c * c, 0.0)) * noise).astype(np.float32))
    return np.stack(rows), base


@pytest.fixture
def band(tmp_path, monkeypatch):
    """(jax_engine, port_engine, base) over the adversarial corpus, each
    with the band's query embedding in its query cache and its device
    query path off, so every lane reads the cached embedding."""
    monkeypatch.setenv("RAG_TPU_INT8_CORPUS", "1")
    monkeypatch.setenv("RAG_TPU_NATIVE_BM25", "0")
    emb, base = _adversarial_corpus()
    j = JEngine(str(tmp_path / "jax"), JService(HashEncoder(dim=DIM, model_name="int8-exact")))
    t = TEngine(str(tmp_path / "port"), TService(THashEncoder(dim=DIM, model_name="int8-exact")), device="cpu")
    for eng, meta in ((j, JMeta), (t, TMeta)):
        metas = [meta(id=f"c{i}", document_name="d.pdf", text=f"adversarial row {i}", chunk_index=i)
                 for i in range(emb.shape[0])]
        for m, s in zip(metas, eng.store.add_chunks(metas, emb)):
            eng.lexical_index.add_chunk(m.id, m.text, s)
        eng.embedding_service._cache.put(BAND_QUERY, base)
        eng.embedding_service.get_query_embeddings_device = lambda texts: None
    _assert_same_store(t.store, j.store)
    return j, t, base


def _assert_exact(eng, slots, scores, q, k):
    """The k slots are a top-k of the dequantised slab (a float64 scan),
    up to rows tied with the k-th true score within 1e-6 (a band of 600
    rows within 2e-5 leaves f32 summation orders room to swap neighbours),
    and their scores are the true ones within 1e-6."""
    values = eng.store.corpus().numpy().astype(np.float64)
    truth = (values @ q.astype(np.float64)) * eng.store.scales().numpy()[:, 0]
    truth[~eng.store.valid_mask().numpy()] = -np.inf
    kth = np.sort(truth)[::-1][k - 1]
    slots = np.asarray(list(slots))
    assert len(set(slots.tolist())) == len(slots) == k
    assert (truth[slots] >= kth - 1e-6).all()
    np.testing.assert_allclose(np.asarray(scores, np.float64), truth[slots], atol=1e-6, rtol=0)


def test_band_escalates_on_every_lane(band):
    j, t, base = band
    k = 32
    # the certificate fails on the band in both packages
    # (tests/test_torch_int8_ops.py), so each lane escalates once
    res = t.search_batch([BAND_QUERY], k, use_reranker=False)[0]
    _assert_exact(t, [t.store.slot_for_id(r.chunk_id) for r in res], [r.embedding_score for r in res], base, k)
    _same(_rows(res), _rows(j.search_batch([BAND_QUERY], k, use_reranker=False)[0]), "band search_batch")
    assert t.int8_escalations == 1
    col = t.fetch_columnar(t.dispatch_search([BAND_QUERY, "adversarial row 7"], k))
    _assert_exact(t, col.slots[0], col.emb[0], base, k)
    assert t.int8_escalations == 2
    jcol = j.fetch_columnar(j.dispatch_search([BAND_QUERY, "adversarial row 7"], k))
    for qi in range(2):
        _same(_rows(t.results_from_columnar(col, qi)), _rows(j.results_from_columnar(jcol, qi)), f"band hot {qi}")
    cands = t.get_embedding_candidates(BAND_QUERY, k)
    _assert_exact(t, [t.store.slot_for_id(c.chunk_id) for c in cands], [c.initial_score for c in cands], base, k)
    assert t.int8_escalations == 3
    # the MMR object lane's host route: the escalated query's candidate
    # similarities are patched with those of dequantised rows
    pooled, (sims, ranks) = t.search_batch([BAND_QUERY], 15, use_reranker=False, collect_sims=True)
    assert t.int8_escalations == 4
    slots = [t.store.slot_for_id(r.chunk_id) for r in pooled[0]]
    rows = t.store.corpus().numpy()[slots].astype(np.float32) * t.store.scales().numpy()[slots]
    at = [ranks[0][r.chunk_id] for r in pooled[0]]
    np.testing.assert_allclose(sims[0][np.ix_(at, at)], rows @ rows.T, atol=1e-6, rtol=0)
    got = t.search_with_diversity_batch([BAND_QUERY], 5, 0.3, use_reranker=False)[0]
    assert len(got) == 5 and t.int8_escalations == 5


def test_random_query_certifies(band):
    j, t, _ = band
    rng = np.random.default_rng(0)
    q = rng.standard_normal(DIM).astype(np.float32)
    q /= np.linalg.norm(q)
    t.embedding_service._cache.put("random probe", q)
    j.embedding_service._cache.put("random probe", q)
    res = t.search_batch(["random probe"], 32, use_reranker=False)[0]
    assert t.int8_escalations == 0
    _assert_exact(t, [t.store.slot_for_id(r.chunk_id) for r in res], [r.embedding_score for r in res], q, 32)
    _same(_rows(res), _rows(j.search_batch(["random probe"], 32, use_reranker=False)[0]), "random")
