"""The port's MMR lane against the JAX package on the CPU: the similarity
ops, the greedy selection (host, single pool, batch), the hybrid stage's
candidate similarities and hybrid_topk_packed_mmr (N 1,024 and N 65,536,
the latter through the score + segment-max kernel's plain twin against
Pallas in interpret mode), the engine's MMR hot lane and its three
object-lane routes, and the batcher's routing.

Tolerances: f32 similarities and scores within 1e-5 (sums of D products
of unit vectors in other orders, and XLA's CPU FMA contraction of the
blend: a few ulps). Selections are compared exactly, index by index: the
data holds exact ties only between duplicate rows (duplicate candidates,
or duplicate chunks), where both sides compute identical numbers and take
the first index; at the hybrid and engine level, where the two packages
may order exactly tied candidates differently, a differing pick must be a
duplicate of the other side's (the same row, the same text).
"""

import os
from contextlib import contextmanager

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_local_rag_tpu.engine.chunk_store import ChunkMeta as JMeta
from rust_local_rag_tpu.engine.chunk_store import ChunkStore as JStore
from rust_local_rag_tpu.engine.rag_engine import RagEngine as JEngine
from rust_local_rag_tpu.engine.rag_engine import _normalize_vec as jnormalize
from rust_local_rag_tpu.models.embedding_service import EmbeddingService as JService
from rust_local_rag_tpu.models.fake_encoder import HashEncoder
from rust_local_rag_tpu.ops import hybrid as jhybrid
from rust_local_rag_tpu.ops import mmr as jmmr
from rust_local_rag_tpu.ops import similarity as jsim
from rust_local_rag_tpu.server.batcher import SearchBatcher as JBatcher
from rust_local_rag_tpu.utils.rwlock import RwLock as JLock
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta as TMeta
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkStore as TStore
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine as TEngine
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService as TService
from rust_local_rag_tpu_torch.ops import hybrid as thybrid
from rust_local_rag_tpu_torch.ops import mmr as tmmr
from rust_local_rag_tpu_torch.ops import similarity as tsim
from rust_local_rag_tpu_torch.ops.hybrid import unpack_topk
from rust_local_rag_tpu_torch.server.batcher import SearchBatcher as TBatcher
from rust_local_rag_tpu_torch.utils.rwlock import RwLock as TLock

TOL = 1e-5
DIM = 32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unit(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


# ------------------------------------------------------------ similarity ----


def test_similarity_ops_match_jax(rng):
    v = rng.standard_normal(DIM).astype(np.float32)
    m = rng.standard_normal((9, DIM)).astype(np.float32)
    m[3] = 0.0  # below the 1e-20 norm floor: left as it is
    c = _unit(rng, 50, DIM)
    lex = np.abs(rng.standard_normal((4, 50))).astype(np.float32)
    lex[2] = 0.0  # the f32::EPSILON floor
    pairs = [
        (tsim.normalize(_t(v)), jsim.normalize(jnp.asarray(v))),
        (tsim.normalize(_t(np.zeros(DIM, np.float32))), jsim.normalize(jnp.zeros(DIM))),
        (tsim.normalize_rows(_t(m)), jsim.normalize_rows(jnp.asarray(m))),
        (tsim.cosine_similarity(_t(v), _t(m[0])), jsim.cosine_similarity(jnp.asarray(v), jnp.asarray(m[0]))),
        (tsim.cosine_similarity(_t(v), _t(m[3])), jsim.cosine_similarity(jnp.asarray(v), jnp.asarray(m[3]))),
        (tsim.dense_scores(_t(c[:4]), _t(c)), jsim.dense_scores(jnp.asarray(c[:4]), jnp.asarray(c))),
        (tsim.blend_scores(_t(c[:4] @ c.T), _t(lex), 0.7, 0.3),
         jsim.blend_scores(jnp.asarray(c[:4] @ c.T), jnp.asarray(lex), 0.7, 0.3)),
        (tmmr.similarity_matrix(_t(c)), jmmr.similarity_matrix(jnp.asarray(c))),
        (tmmr.similarity_matrices(_t(c.reshape(5, 10, DIM))), jmmr.similarity_matrices(jnp.asarray(c.reshape(5, 10, DIM)))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)


# ------------------------------------------------------------ selection ----


def _pool(seed: int, p: int, lam: float, d: int = 16):
    """A candidate pool by descending relevance whose arithmetic is exact
    in f32 in any order: rows of multiples of 1/4 in [-1/2, 1/2] (every
    similarity is a multiple of 1/16), and for lambda in {0, 1/2, 1}
    relevance on a grid of 1/64 as well, so MMR values tie exactly
    wherever they tie in exact arithmetic, on both sides. Rows 2 and 5 are
    duplicates with equal relevance, as are rows 7 and 8."""
    rng = np.random.default_rng(seed)
    emb = (rng.integers(-2, 3, (p, d)) * 0.25).astype(np.float32)
    if lam in (0.0, 0.5, 1.0):
        rel = rng.integers(0, 64, p).astype(np.float32) / 64
    else:
        rel = rng.random(p).astype(np.float32)
    rel = np.sort(rel)[::-1].copy()
    if p > 8:
        emb[5], rel[5] = emb[2], rel[2]
        emb[8], rel[8] = emb[7], rel[7]
    return emb, rel


def _nonfinite(rel, kind):
    rel = rel.copy()
    if kind == "nan":
        rel[[0, 4]] = np.nan  # the first pick takes row 0 all the same
    elif kind == "inf":
        rel[3], rel[6] = np.inf, -np.inf
    return rel


@pytest.mark.parametrize("p, k", [(12, 5), (12, 16), (40, 10), (1, 3)])
@pytest.mark.parametrize("lam", [0.0, 0.3, 0.7, 1.0])
@pytest.mark.parametrize("kind", ["finite", "nan", "inf"])
def test_mmr_select_host_matches_jax(p, k, lam, kind):
    emb, rel = _pool(p * 7 + k, p, lam)
    rel = _nonfinite(rel, kind) if p > 6 else rel
    sims = emb @ emb.T
    if p > 3:
        sims[1, 3] = sims[3, 1] = np.nan  # a non-finite similarity stays out of the max
    got = tmmr.mmr_select_host(sims, rel, k, lam)
    assert got == jmmr.mmr_select_host(sims, rel, k, lam)
    assert got[0] == 0 and len(set(got)) == len(got) <= min(k, p)
    assert tmmr.mmr_select_host(np.zeros((0, 0), np.float32), rel[:0], k, lam) == []


@pytest.mark.parametrize("p, k, valid", [(12, 5, None), (12, 16, None), (16, 8, 11), (16, 8, 0), (40, 32, 33)])
@pytest.mark.parametrize("lam", [0.3, 0.5, 1.0])
@pytest.mark.parametrize("kind", ["finite", "nan", "inf"])
def test_mmr_select_matches_jax(p, k, valid, lam, kind):
    emb, rel = _pool(p + k, p, lam)
    rel = _nonfinite(rel, kind)
    jv = None if valid is None else jnp.int32(valid)
    want = np.asarray(jmmr.mmr_select(jnp.asarray(emb), jnp.asarray(rel), k, lam, valid_count=jv))
    got = tmmr.mmr_select(_t(emb), _t(rel), k, lam, valid_count=valid)
    assert got.dtype == torch.int32 and tuple(got.shape) == (k,)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "finite" and valid != 0:
        # the device loop and the host greedy agree on the same pool
        n = p if valid is None else valid
        host = tmmr.mmr_select_host(emb[:n] @ emb[:n].T, rel[:n], k, lam)
        assert got.numpy()[: len(host)].tolist() == host and (got.numpy()[len(host):] == -1).all()


def test_mmr_select_batch_matches_jax():
    q, p, k = 5, 24, 10
    counts = np.array([24, 24, 24, 10, 0], np.int32)
    for lam in (0.0, 0.3, 0.5, 1.0):
        pools = [_pool(s, p, lam) for s in range(q)]
        emb = np.stack([e for e, _ in pools])
        rel = np.stack([r for _, r in pools])
        rel[1] = _nonfinite(rel[1], "nan")
        rel[2] = _nonfinite(rel[2], "inf")
        emb[3, 10:] = 7.0  # padding rows past the valid prefix: never picked, never in a max
        want = np.asarray(jmmr.mmr_select_batch(jnp.asarray(emb), jnp.asarray(rel), k, lam, jnp.asarray(counts)))
        got = tmmr.mmr_select_batch(_t(emb), _t(rel), k, lam, _t(counts))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy()[4] == -1).all() and (got.numpy()[3][got.numpy()[3] >= 0] < 10).all()


def test_bf16_rows_are_scored_in_f32():
    """A bf16 pool is taken to f32 before the products: the selection of
    the bf16 pool equals that of its f32 image."""
    emb, rel = _pool(3, 40, 0.5)
    bf = _t(emb).to(torch.bfloat16)
    a = tmmr.mmr_select(bf, _t(rel), 12, 0.5)
    b = tmmr.mmr_select(bf.float(), _t(rel), 12, 0.5)
    assert torch.equal(a, b)
    want = jmmr.mmr_select(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16), jnp.asarray(rel), 12, 0.5)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want))


# ---------------------------------------------------------------- hybrid ----


def _hybrid_case(seed, n, q, d=DIM, n_lex=60):
    """Unit corpus with exact duplicate rows near each query (tied
    candidates), 10% of slots freed, and sparse lexical hits, some on the
    duplicates."""
    rng = np.random.default_rng(seed)
    corpus = _unit(rng, n, d)
    src = rng.choice(n // 2, q, replace=False)
    queries = corpus[src] + 0.3 * _unit(rng, q, d)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    for i, s in enumerate(src):
        corpus[n // 2 + i] = corpus[s]  # a duplicate of each query's source row
    mask = rng.random(n) > 0.1
    mask[src] = True
    mask[n // 2 + np.arange(q)] = True
    lex_slots = np.full((q, 512), -1, np.int32)
    lex_vals = np.zeros((q, 512), np.float32)
    for i in range(q):
        slots = rng.choice(n, n_lex, replace=False).astype(np.int32)
        slots[0] = src[i]
        lex_slots[i, :n_lex] = slots
        lex_vals[i, :n_lex] = rng.random(n_lex).astype(np.float32) * 8
    return queries.astype(np.float32), corpus, mask, lex_slots, lex_vals


def _same_picks(t_idx, j_idx, corpus, what):
    """Index by index equal, or the two picks are duplicate rows."""
    for a, b in zip(t_idx.tolist(), j_idx.tolist()):
        assert a == b or (a >= 0 and b >= 0 and np.array_equal(corpus[a], corpus[b])), (what, a, b)


def test_hybrid_topk_with_sims_matches_jax():
    queries, corpus, mask, lex_slots, lex_vals = _hybrid_case(1, 1024, 4)
    j = jhybrid.hybrid_topk(jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask), jnp.asarray(lex_slots),
                            jnp.asarray(lex_vals), jnp.float32(0.7), jnp.float32(0.3), 32, with_sims=True)
    t = thybrid.hybrid_topk(_t(queries), _t(corpus), _t(mask), _t(lex_slots), _t(lex_vals),
                            torch.tensor(0.7), torch.tensor(0.3), 32, with_sims=True)
    assert len(t) == 5 and tuple(t[4].shape) == (4, 32, 32)
    for qi in range(4):
        _same_picks(t[3][qi], np.asarray(j[3])[qi], corpus, "idx")
    for a, b in zip(t[:3] + (t[4],), j[:3] + (j[4],)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)


@pytest.mark.parametrize("n", [1024, 65536])
@pytest.mark.parametrize("floor", [0.0, 0.25])
@pytest.mark.parametrize("pool_k, out_k", [(32, 16), (128, 128)])
def test_hybrid_topk_packed_mmr_matches_jax(n, floor, pool_k, out_k):
    q = 4
    queries, corpus, mask, lex_slots, lex_vals = _hybrid_case(n + pool_k, n, q)
    assert thybrid.uses_score_segmax(n) == (n == 65536)
    want = np.asarray(jhybrid.hybrid_topk_packed_mmr(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask), jnp.asarray(lex_slots), jnp.asarray(lex_vals),
        jnp.float32(0.7), jnp.float32(0.3), jnp.float32(0.3), jnp.float32(floor), pool_k, out_k,
    ))
    got = thybrid.hybrid_topk_packed_mmr(
        _t(queries), _t(corpus), _t(mask), _t(lex_slots), _t(lex_vals),
        torch.tensor(0.7), torch.tensor(0.3), 0.3, floor, pool_k, out_k,
    )
    assert got.dtype == torch.int32 and tuple(got.shape) == (q, 4, out_k)
    tv, te, tl, ti = unpack_topk(got.numpy(), q, out_k)
    jv, je, jl, ji = unpack_topk(want, q, out_k)
    for qi in range(q):
        _same_picks(ti[qi], ji[qi], corpus, f"query {qi}")
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    fin = np.isfinite(jv)
    for a, b in ((tv, jv), (te, je), (tl, jl)):
        np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=TOL)
    if floor > 0.0:
        assert (te[fin] >= floor).all()
    assert not np.isin(ti[ti >= 0], np.flatnonzero(~mask)).any()


# ---------------------------------------------------------------- engine ----

VOCAB = [f"term{i}" for i in range(120)] + ["pump", "valve", "seal", "bearing", "motor", "filter"]


def _chunks(seed=3, n=260):
    """Seeded chunk texts of Zipf-weighted words (informative BM25), with
    exact duplicate chunks (tied candidates)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.1
    p /= p.sum()
    rng.shuffle(p)
    texts = [" ".join(rng.choice(VOCAB, rng.integers(6, 30), p=p)) for _ in range(n)]
    for a, b in ((10, 11), (40, 41), (42, 43), (100, 101)):
        texts[b] = texts[a]
    return texts


QUERIES = ["pump valve", "seal bearing term3", "motor filter", "term1 term2 term5", "term7",
           "words never indexed", "pump", "term0 term9 seal", "valve term11", "bearing bearing"]


def _engine_pair(tmp_path, capacity=1024):
    """(jax_engine, port_engine) holding the same chunks at the same slots."""
    j = JEngine(str(tmp_path / "jax"), JService(HashEncoder(dim=DIM)))
    t = TEngine(str(tmp_path / "port"), TService(HashEncoder(dim=DIM)), device="cpu")
    j.store = JStore(dim=DIM, initial_capacity=capacity)
    t.store = TStore(DIM, initial_capacity=capacity, device="cpu")
    texts = _chunks()
    enc = HashEncoder(dim=DIM)
    emb = np.stack([jnormalize(enc.encode_one(x)) for x in texts])
    ids = [f"chunk-{i:04d}" for i in range(len(texts))]
    jm = [JMeta(id=c, document_name=f"d{i // 50}", text=x, chunk_index=i % 50) for i, (c, x) in enumerate(zip(ids, texts))]
    tm = [TMeta(id=c, document_name=f"d{i // 50}", text=x, chunk_index=i % 50) for i, (c, x) in enumerate(zip(ids, texts))]
    for m, slot in zip(jm, j.store.add_chunks(jm, emb)):
        j.lexical_index.add_chunk(m.id, m.text, slot)
    assert t.add_chunks(tm, emb) == list(range(len(texts)))
    return j, t


@pytest.fixture
def pair(tmp_path, monkeypatch, request):
    """The engine pair with the environment of request.param set first
    (the engines read RAG_TPU_DEVICE_MMR when they are made)."""
    for key in ("RAG_TPU_DEVICE_MMR", "RAG_TPU_BATCH_DEVICE_MMR"):
        monkeypatch.delenv(key, raising=False)
    for key, val in getattr(request, "param", {}).items():
        monkeypatch.setenv(key, val)
    return _engine_pair(tmp_path)


def _rows(results):
    return [(r.text, r.score, r.embedding_score, r.lexical_score) for r in results]


def _same_ordered(got, want, what):
    """The same texts in the same order (duplicate chunks share a text),
    scores within TOL."""
    assert [r[0] for r in got] == [r[0] for r in want], what
    if got:
        np.testing.assert_allclose(np.array([r[1:] for r in got], dtype=np.float64),
                                   np.array([r[1:] for r in want], dtype=np.float64), rtol=0, atol=TOL, err_msg=what)


@pytest.mark.parametrize("top_k, div", [(5, 0.3), (10, 0.7), (3, 1.0), (7, 0.7)])
@pytest.mark.parametrize("kw", [{}, {"rejection_cosine_floor": 0.2}])
def test_mmr_hot_lane_matches_jax(pair, top_k, div, kw):
    """The port's MMR hot lane gives the JAX engine's object-lane answers
    (the reference's MMR over a pool of max(3 top_k, top_k + 10)), and its
    own object lane's; the lexical request is sized by the pool, as in the
    JAX hot lane."""
    j, t = pair
    pj = j.dispatch_search_mmr(QUERIES, top_k, div, **kw)
    pt = t.dispatch_search_mmr(QUERIES, top_k, div, **kw)
    assert pt.lex_slots.shape == pj.lex_slots.shape
    ct = t.fetch_columnar(pt)
    want = j.search_with_diversity_batch(QUERIES, top_k, div, use_reranker=False, **kw)
    own = t.search_with_diversity_batch(QUERIES, top_k, div, use_reranker=False, **kw)
    for qi, q in enumerate(QUERIES):
        got = _rows(t.results_from_columnar(ct, qi))
        _same_ordered(got, _rows(want[qi]), q)
        _same_ordered(got, _rows(own[qi]), f"own object lane {q}")


def test_jax_hot_lane_takes_the_bucketed_pool(pair):
    """A fault of the JAX hot lane the port does not copy: it runs MMR over
    the pool's bucket (32 candidates for top_k 7's pool of 21), so it can
    pick candidates its object lane never considers, while the port's hot
    lane agrees with both object lanes."""
    j, t = pair
    top_k, div = 7, 0.7
    cj = j.fetch_columnar(j.dispatch_search_mmr(QUERIES, top_k, div))
    ct = t.fetch_columnar(t.dispatch_search_mmr(QUERIES, top_k, div))
    obj = j.search_with_diversity_batch(QUERIES, top_k, div, use_reranker=False)
    jax_hot = [[r.text for r in j.results_from_columnar(cj, qi)] for qi in range(len(QUERIES))]
    port_hot = [[r.text for r in t.results_from_columnar(ct, qi)] for qi in range(len(QUERIES))]
    want = [[r.text for r in res] for res in obj]
    assert port_hot == want
    assert sum(a != b for a, b in zip(jax_hot, want)) >= 1


ROUTES = {
    "host": {},
    "many": {"RAG_TPU_BATCH_DEVICE_MMR": "1"},
    "one": {"RAG_TPU_DEVICE_MMR": "1"},
}


@pytest.mark.parametrize("pair", list(ROUTES.values()), ids=list(ROUTES), indirect=True)
@pytest.mark.parametrize("top_k, div", [(5, 0.3), (10, 0.7)])
def test_object_lane_routes_match_jax(pair, top_k, div):
    j, t = pair
    calls = {"one": 0, "many": 0}
    one, many = t._mmr_one, t._mmr_many
    t._mmr_one = lambda *a: calls.__setitem__("one", calls["one"] + 1) or one(*a)
    t._mmr_many = lambda *a: calls.__setitem__("many", calls["many"] + 1) or many(*a)
    want = j.search_with_diversity_batch(QUERIES[:5], top_k, div, use_reranker=False)
    got = t.search_with_diversity_batch(QUERIES[:5], top_k, div, use_reranker=False)
    route = "one" if t._device_mmr else ("many" if os.environ.get("RAG_TPU_BATCH_DEVICE_MMR") else "host")
    assert calls == {"one": 5 * (route == "one"), "many": int(route == "many")}
    for q, a, b in zip(QUERIES, got, want):
        _same_ordered(_rows(a), _rows(b), f"{route} {q}")
    # the one-query form, and a batch of 8 (which takes _mmr_many by default)
    _same_ordered(_rows(t.search_with_diversity(QUERIES[0], top_k, div, use_reranker=False)),
                  _rows(j.search_with_diversity(QUERIES[0], top_k, div, use_reranker=False)), "single")
    for q, a, b in zip(QUERIES, t.search_with_diversity_batch(QUERIES[:8], top_k, div, use_reranker=False),
                       j.search_with_diversity_batch(QUERIES[:8], top_k, div, use_reranker=False)):
        _same_ordered(_rows(a), _rows(b), f"batch of 8 {q}")


def test_mmr_one_host_split_matches_jax(pair):
    """_mmr_one without RAG_TPU_DEVICE_MMR: similarities on the device, the
    greedy scan on the host."""
    j, t = pair
    pooled_t = t.search_batch(QUERIES[:3], 30, use_reranker=False)
    pooled_j = j.search_batch(QUERIES[:3], 30, use_reranker=False)
    for q, a, b in zip(QUERIES, pooled_t, pooled_j):
        _same_ordered(_rows(t._mmr_one(a, 8, 0.4)), _rows(j._mmr_one(b, 8, 0.4)), q)
    assert t._mmr_one([], 8, 0.4) == [] and t._mmr_many([[], []], 8, 0.4) == [[], []]


def test_search_batch_collect_sims_matches_jax(pair):
    j, t = pair
    (rt, (st, mt)), (rj, (sj, mj)) = (
        e.search_batch(QUERIES[:4], 12, use_reranker=False, collect_sims=True) for e in (t, j)
    )
    for qi in range(4):
        _same_ordered(_rows(rt[qi]), _rows(rj[qi]), QUERIES[qi])
        text = {r.chunk_id: r.text for r in rt[qi]}
        # the similarity of every pair of returned chunks, by candidate row
        for a in rt[qi]:
            for b in rt[qi]:
                sa = st[qi][mt[qi][a.chunk_id], mt[qi][b.chunk_id]]
                sb = sj[qi][mj[qi][a.chunk_id], mj[qi][b.chunk_id]] if a.chunk_id in mj[qi] and b.chunk_id in mj[qi] \
                    else None
                if sb is not None:
                    assert abs(sa - sb) <= TOL, (text[a.chunk_id], text[b.chunk_id])
    empty = TEngine(str(t.data_dir) + "_empty", t.embedding_service, device="cpu")
    assert empty.search_batch(["x"], 5, collect_sims=True) == ([[]], None)


def test_warmup_runs_every_lane(pair):
    """warmup compiles every BM25 snapshot first, then runs the object
    lane's three MMR forms and the two hot lanes."""
    _, t = pair
    seen = []
    for name in ("_mmr_many", "dispatch_search", "dispatch_search_mmr", "search_batch"):
        fn = getattr(t, name)
        setattr(t, name, lambda *a, _fn=fn, _name=name, **kw: seen.append(_name) or _fn(*a, **kw))
    compile_all = t.lexical_index.compile_all
    t.lexical_index.compile_all = lambda: seen.append(("compiled", compile_all())) or seen[-1][1]
    t.warmup()
    assert seen[0][0] == "compiled" and seen[0][1] > 0
    assert {"_mmr_many", "dispatch_search", "dispatch_search_mmr", "search_batch"} <= set(seen[1:])
    assert compile_all() == 0  # nothing left to compile


# --------------------------------------------------------------- batcher ----


class _DepthLock(TLock):
    """The port's RwLock, recording how deep the read side is held."""

    def __init__(self):
        super().__init__()
        self.depth, self.seen = 0, []

    @contextmanager
    def read(self, timeout=None):
        with super().read(timeout):
            self.depth += 1
            try:
                yield
            finally:
                self.depth -= 1


def test_batcher_routes_diversity_to_the_mmr_lane(pair):
    j, t = pair
    calls = {"mmr": 0, "general": 0}
    dispatch, general = t.dispatch_search_mmr, t.search_with_diversity_batch

    def rec_mmr(*a, **kw):
        calls["mmr"] += 1
        return dispatch(*a, **kw)

    def rec_general(*a, **kw):
        calls["general"] += 1
        return general(*a, **kw)

    t.dispatch_search_mmr, t.search_with_diversity_batch = rec_mmr, rec_general
    jb, tb = JBatcher(j, JLock(), window_ms=20), TBatcher(t, TLock(), window_ms=20)
    try:
        # the JAX batcher's own MMR lane, at a top_k whose pool (30) is not
        # below its bucket's reach in this corpus, and the JAX object lane
        jax_lane = [f.result(timeout=60) for f in [jb.submit(q, 10, 0.3, None, use_reranker=False) for q in QUERIES]]
        got = [f.result(timeout=60) for f in [tb.submit(q, 10, 0.3, None, use_reranker=False) for q in QUERIES]]
    finally:
        jb.stop()
        tb.stop()
    assert calls["mmr"] >= 1 and calls["general"] == 0
    want = j.search_with_diversity_batch(QUERIES, 10, 0.3, use_reranker=False)
    for q, a, b, c in zip(QUERIES, got, want, jax_lane):
        _same_ordered(_rows(a), _rows(b), q)
        _same_ordered(_rows(a), _rows(c), f"JAX batcher {q}")


def test_mmr_lane_declines_on_empty_store_outside_the_lock(tmp_path):
    t = TEngine(str(tmp_path), TService(HashEncoder(dim=DIM)), device="cpu")
    lock = _DepthLock()
    general = t.search_with_diversity_batch

    def rec_general(*a, **kw):
        lock.seen.append(lock.depth)
        return general(*a, **kw)

    t.search_with_diversity_batch = rec_general
    b = TBatcher(t, lock, window_ms=1)
    try:
        assert b.search("anything", 5, 0.3, None, use_reranker=False) == []
    finally:
        b.stop()
    # the lane declined and the general lane took the batch holding the
    # read lock once, its own: the MMR lane had released it
    assert t.dispatch_search_mmr(["anything"], 5, 0.3) is None
    assert lock.seen == [1]
