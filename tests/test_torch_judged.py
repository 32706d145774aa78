"""The port's rerank-on lanes against the JAX engine and batcher: the
judge-gated lane (reranker weight 0, the shipped quality configuration)
and the object lane (search_batch at the reference's 0.7 / 0.3 blend),
with every rejection gate.

Both engines ingest the same PDFs with their own package's hash encoder
and hold their own package's FakeReranker inside their RerankerService
(numpy models, bit-identical across the packages), so the judge sees
identical prompts and gives identical yes/no logprobs; what is compared
is the engines' lanes around it. Slab capacity 65,536 sends both
first stages through their score + segment-max branch (Pallas in
interpret mode, the port's plain twin on the CPU).

Tolerance: SCORE_TOL = 1e-5 on every score (f32 dots of unit vectors
summed in another order and XLA's CPU FMA contraction of the blend, a few
ulps, carried through the judged normalisation and the blend); results are
keyed by (document, chunk_index), and a row on one side only must tie with
the last score within SCORE_TOL.
"""

import numpy as np
import pytest

import pdfgen
from rust_local_rag_tpu.config import QueryWeights as JWeights
from rust_local_rag_tpu.engine.chunk_store import ChunkStore as JStore
from rust_local_rag_tpu.engine.rag_engine import RagEngine as JEngine
from rust_local_rag_tpu.models.embedding_service import EmbeddingService as JService
from rust_local_rag_tpu.models.fake_encoder import HashEncoder
from rust_local_rag_tpu.models.reranker import FakeReranker
from rust_local_rag_tpu.models.reranker_service import RerankerService as JRerankerService
from rust_local_rag_tpu.server.batcher import SearchBatcher as JBatcher
from rust_local_rag_tpu.utils.rwlock import RwLock as JLock
from rust_local_rag_tpu_torch.config import QueryWeights as TWeights
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkStore as TStore
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine as TEngine
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService as TService
from rust_local_rag_tpu_torch.models.fake_encoder import HashEncoder as THashEncoder
from rust_local_rag_tpu_torch.models.reranker import FakeReranker as TFakeReranker
from rust_local_rag_tpu_torch.models.reranker_service import RerankerService as TRerankerService
from rust_local_rag_tpu_torch.server.batcher import SearchBatcher as TBatcher
from rust_local_rag_tpu_torch.utils.rwlock import RwLock as TLock

DIM = 64
SCORE_TOL = 1e-5
CAPACITY = 65536

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
    "zebra xylophone quasar pump",
]

# gate settings, each a case for both lanes. With this corpus and the hash
# judge the 2-way unseen gate rejects 3 queries, the judge-rescue term
# (0.6) spares 2 of them, the query floor rejects some, and the judge /
# cosine floors drop single rows.
GATES = [
    {},
    {"rejection_query_floor": 0.66},
    {"rejection_unseen_mass": 0.5, "rejection_unseen_cos": 0.45},
    {"rejection_unseen_mass": 0.5, "rejection_unseen_cos": 0.45, "rejection_unseen_judge": 0.6},
    {"rejection_threshold": 0.65, "rejection_cosine_floor": 0.3},
    {"rejection_threshold": 0.3},
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


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(jax_engine, port_engine), each with the FakeReranker in its own
    service, over the same documents."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAG_TPU_NATIVE_BM25", "0")
        root = tmp_path_factory.mktemp("judged")
        j = JEngine(str(root / "jax"), JService(HashEncoder(dim=DIM)), reranker=JRerankerService(FakeReranker()))
        t = TEngine(
            str(root / "port"), TService(THashEncoder(dim=DIM)),
            reranker=TRerankerService(TFakeReranker()), device="cpu",
        )
        j.store = JStore(dim=DIM, initial_capacity=CAPACITY)
        t.store = TStore(DIM, initial_capacity=CAPACITY, device="cpu")
        rng = np.random.default_rng(5)
        for i in range(6):
            data = _doc(i, rng)
            assert j.add_document(f"doc{i}.pdf", data) == t.add_document(f"doc{i}.pdf", data) > 0
    assert t.has_reranker() and t.get_reranker().model_name == "fake-reranker"
    return j, t


FIELDS = ("score", "embedding_score", "lexical_score", "initial_score", "reranker_score", "yes_logprob", "no_logprob")


def _rows(results):
    return [
        ((r.document, r.chunk_index), *[np.nan if getattr(r, f) is None else getattr(r, f) for f in FIELDS])
        for r in results
    ]


def _same(got, want, what):
    """Same rows and every field within SCORE_TOL (None only where the
    other side has None); a row on one side only must tie with the last
    score within SCORE_TOL."""
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


def _judged(engine, weights, queries, top_k, kw):
    pending = engine.dispatch_search(
        queries, top_k, weights, rejection_threshold=0.0, rejection_cosine_floor=0.0
    )
    pj = engine.judge_columnar(pending, queries, weights=weights, **kw)
    jc = engine.fetch_judged(pj)
    return [engine.results_from_judged(jc, qi) for qi in range(len(queries))], jc


@pytest.mark.parametrize("kw", GATES, ids=lambda kw: ",".join(k.replace("rejection_", "") for k in kw) or "none")
def test_judged_lane_matches_jax(engines, kw):
    j, t = engines
    assert t.supports_judged_columnar(TWeights(reranker=0.0, initial=1.0), True)
    assert not t.supports_judged_columnar(None, True) and not t.supports_judged_columnar(
        TWeights(reranker=0.0, initial=1.0), False
    )
    got, tjc = _judged(t, TWeights(reranker=0.0, initial=1.0), QUERIES, 5, kw)
    want, jjc = _judged(j, JWeights(reranker=0.0, initial=1.0), QUERIES, 5, kw)
    for q, a, b in zip(QUERIES, got, want):
        _same(_rows(a), _rows(b), f"{q} {kw}")
    # the columnar planes the results come from: judged yes-p, logprobs,
    # blend and the rejected (slot -1) rows, in first-stage order
    n = len(QUERIES)
    np.testing.assert_array_equal(tjc.col.slots[:n] < 0, np.asarray(jjc.col.slots)[:n] < 0)
    for name in ("rr", "yes", "no", "score"):
        np.testing.assert_allclose(getattr(tjc, name)[:n], getattr(jjc, name)[:n], rtol=0, atol=SCORE_TOL)
    # and the port's judged lane equals its own object lane at weight 0
    obj = t.search_batch(QUERIES, 5, TWeights(reranker=0.0, initial=1.0), **kw)
    for q, a, b in zip(QUERIES, got, obj):
        _same(_rows(a), _rows(b), f"judged vs object {q} {kw}")


@pytest.mark.parametrize("kw", GATES, ids=lambda kw: ",".join(k.replace("rejection_", "") for k in kw) or "none")
def test_object_lane_default_blend_matches_jax(engines, kw):
    j, t = engines
    got = t.search_batch(QUERIES, 5, None, **kw)
    want = j.search_batch(QUERIES, 5, None, **kw)
    for q, a, b in zip(QUERIES, got, want):
        _same(_rows(a), _rows(b), f"{q} {kw}")
    assert any(r.reranker_score is not None for res in got for r in res) or kw.get("rejection_query_floor")


def test_gates_fire_in_the_test_data(engines):
    """The gate cases above are not vacuous on this corpus."""
    _, t = engines
    w = TWeights(reranker=0.0, initial=1.0)
    counts = {}
    for i, kw in enumerate(GATES):
        res, _ = _judged(t, w, QUERIES, 5, kw)
        counts[i] = (sum(not r for r in res), sum(map(len, res)))
    assert counts[0] == (0, 5 * len(QUERIES))
    assert counts[1][0] > 0 and counts[2][0] == 3 and counts[3][0] == 1
    assert counts[4][1] < counts[0][1]


def test_unseen_gate_spares_the_judge_forward(engines):
    """With the judge-rescue term off, a query the 2-way unseen gate
    rejects gets no judge prompt at all (its slot row is invalidated
    before prompts are built)."""
    _, t = engines
    kw = GATES[2]
    pending = t.dispatch_search(QUERIES, 5, TWeights(reranker=0.0, initial=1.0))
    pj = t.judge_columnar(pending, QUERIES, weights=TWeights(reranker=0.0, initial=1.0), **kw)
    judged_queries = set(pj.flat_qi.tolist())
    rejected = {i for i, row in enumerate(pj.col.slots[: len(QUERIES)]) if (row < 0).all()}
    assert len(rejected) == 3 and not judged_queries & rejected


def test_top_k_beyond_pool_and_empty(engines, tmp_path):
    j, t = engines
    n = len(t.store)
    _same(_rows(t.search("pump", n + 5)), _rows(j.search("pump", n + 5)), "k > n")
    empty = TEngine(str(tmp_path), TService(THashEncoder(dim=DIM)), reranker=t.reranker, device="cpu")
    assert empty.search_batch(["x", "y"], 3) == [[], []]


def _burst(batcher, queries, top_k, weights, **kw):
    futs = [batcher.submit(q, top_k, 0.0, weights, **kw) for q in queries]
    return [f.result(timeout=120) for f in futs]


def test_batcher_routes_lanes_like_jax(engines):
    """The quality configuration goes to the judged lane, a non-zero
    reranker weight (the default 0.7 / 0.3) to the object lane, and both
    give what the JAX batcher gives."""
    j, t = engines
    calls = {"judged": 0, "general": 0}
    judge, general = t.judge_columnar, t.search_with_diversity_batch

    def judge_spy(*a, **kw):
        calls["judged"] += 1
        return judge(*a, **kw)

    def general_spy(*a, **kw):
        calls["general"] += 1
        return general(*a, **kw)

    t.judge_columnar, t.search_with_diversity_batch = judge_spy, general_spy
    jb = JBatcher(j, JLock(), window_ms=20)
    tb = TBatcher(t, TLock(), window_ms=20)
    quality = dict(rejection_threshold=0.0, rejection_unseen_mass=0.5, rejection_unseen_cos=0.45,
                   rejection_unseen_judge=0.6)
    try:
        got_q = _burst(tb, QUERIES, 5, TWeights(reranker=0.0, initial=1.0), **quality)
        judged_batches = calls["judged"]
        assert judged_batches > 0 and calls["general"] == 0
        got_o = _burst(tb, QUERIES, 5, TWeights(reranker=0.5, initial=0.5))
        got_d = _burst(tb, QUERIES, 5, None)
        assert calls["judged"] == judged_batches and calls["general"] >= 2
        want_q = _burst(jb, QUERIES, 5, JWeights(reranker=0.0, initial=1.0), **quality)
        want_o = _burst(jb, QUERIES, 5, JWeights(reranker=0.5, initial=0.5))
        want_d = _burst(jb, QUERIES, 5, None)
    finally:
        jb.stop()
        tb.stop()
        del t.judge_columnar, t.search_with_diversity_batch
    for got, want, what in ((got_q, want_q, "quality"), (got_o, want_o, "0.5/0.5"), (got_d, want_d, "default")):
        for q, a, b in zip(QUERIES, got, want):
            _same(_rows(a), _rows(b), f"{what} {q}")
    assert sum(not r for r in got_q) == 1
    assert tb.judged_fallbacks == 0 and t.rerank_fallbacks == 0


class _BrokenJudge(TFakeReranker):
    def score_prompts(self, prompts):
        raise RuntimeError("judge forward failed")


class _JBrokenJudge(FakeReranker):
    def score_prompts(self, prompts):
        raise RuntimeError("judge forward failed")


def test_judge_failures_fall_back_and_count(tmp_path, engines):
    """A failing judge: the judged lane falls back to the object lane
    (batcher.judged_fallbacks), which falls back to initial scores
    (engine.rerank_fallbacks) — the JAX package's semantics."""
    j, t = engines
    broken = TEngine(str(tmp_path), TService(THashEncoder(dim=DIM)),
                     reranker=TRerankerService(_BrokenJudge()), device="cpu")
    broken.store, broken.lexical_index = t.store, t.lexical_index
    jbroken = JEngine(str(tmp_path / "j"), JService(HashEncoder(dim=DIM)),
                      reranker=JRerankerService(_JBrokenJudge()))
    jbroken.store, jbroken.lexical_index = j.store, j.lexical_index
    tb = TBatcher(broken, TLock(), window_ms=5)
    jb = JBatcher(jbroken, JLock(), window_ms=5)
    try:
        got = _burst(tb, QUERIES[:3], 4, TWeights(reranker=0.0, initial=1.0))
        want = _burst(jb, QUERIES[:3], 4, JWeights(reranker=0.0, initial=1.0))
    finally:
        tb.stop()
        jb.stop()
    # one count per batch in each (the three requests may form 1-3 batches)
    assert tb.judged_fallbacks >= 1 and broken.rerank_fallbacks == tb.judged_fallbacks
    for q, a, b in zip(QUERIES, got, want):
        assert len(a) == 4 and all(r.reranker_score is None for r in a)
        _same(_rows(a), _rows(b), q)
