"""Port parity for the f32 FMA body of score + segment-max (f32 queries on an
f32 slab at Q > 16: query tiles of 32, 64 and 128): the plain versions
against the JAX Pallas kernels in interpret mode at the tiles' edges, the
hybrid first stage at a Q 64 batch on an f32 slab, and a 64-query burst
through the port's SearchBatcher at max batch 64 against the JAX
batcher's. On the CPU every wrapper takes its plain version; the kernel
itself is held to the same plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pdfgen
from rust_local_rag_tpu.engine.chunk_store import ChunkStore as JStore
from rust_local_rag_tpu.engine.rag_engine import RagEngine as JEngine
from rust_local_rag_tpu.models.embedding_service import EmbeddingService as JService
from rust_local_rag_tpu.models.fake_encoder import HashEncoder as JHashEncoder
from rust_local_rag_tpu.ops import hybrid as jhybrid
from rust_local_rag_tpu.ops.pallas_topk import (
    fused_score_segmax as jax_fused_score_segmax,
    fused_score_segmax_masked,
)
from rust_local_rag_tpu.server.batcher import SearchBatcher as JBatcher
from rust_local_rag_tpu.utils.rwlock import RwLock as JLock
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkStore as TStore
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine as TEngine
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService as TService
from rust_local_rag_tpu_torch.models.fake_encoder import HashEncoder as THashEncoder
from rust_local_rag_tpu_torch.ops import hybrid as thybrid
from rust_local_rag_tpu_torch.ops.score_segmax import SEG, fused_score_segmax, score_segmax
from rust_local_rag_tpu_torch.server.batcher import SearchBatcher as TBatcher
from rust_local_rag_tpu_torch.utils.rwlock import RwLock as TLock
from test_torch_score_segmax_wide import _exact_bf16_case

# Both sides sum D products of unit vectors in f32 (Pallas at HIGHEST
# precision) in different orders; each sum is within D * 2^-24 of the exact
# dot, so they differ by at most 2 * D * 2^-24: 7.7e-6 at D 64, 9.3e-5 at
# D 776.
SCORE_ATOL = {64: 1e-5, 776: 1e-4}

# the body's query tiles are 32, 64 and 128 queries: each edge and one past
WIDE_Q = (17, 32, 64, 65, 128, 129)
# (N, D): a small slab, and the serving slab at a depth ragged against the
# body's 32-deep stages. N 65,920 is no multiple of the Pallas kernels'
# 8-tile group (1,024 rows at the smallest tile), so it is held to a float64
# product instead (test_f32_plain_at_ragged_n).
SHAPES = ((16384, 64), (65536, 776))
BLOCK_N = 1024


def _unit(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _freed(rng, n):
    mask = rng.random(n) > 0.2
    mask[SEG : 3 * SEG] = False  # whole segments freed: their max is -inf
    return mask


@pytest.mark.parametrize("n, d", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("q", WIDE_Q)
def test_f32_masked_plain_matches_pallas(rng, q, n, d):
    """The masked entry on CPU tensors (its plain version, what the f32
    body is held to on the card) against fused_score_segmax_masked."""
    queries, corpus, mask = _unit(rng, q, d), _unit(rng, n, d), _freed(rng, n)
    j_scores, j_segmax_t = fused_score_segmax_masked(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask), block_n=BLOCK_N
    )
    before = score_segmax.launches
    t_scores, t_segmax = score_segmax(_t(queries), _t(corpus), _t(mask))
    assert score_segmax.launches == before  # CPU tensors: the plain version
    j_scores, t_scores, t_segmax = np.asarray(j_scores), t_scores.numpy(), t_segmax.numpy()
    assert t_scores.dtype == np.float32 and t_scores.shape == (q, n) and t_segmax.shape == (q, n // SEG)
    assert np.array_equal(np.isneginf(j_scores), np.isneginf(t_scores))
    assert np.isneginf(t_scores[:, ~mask]).all() and np.isneginf(t_segmax[:, 1:3]).all()
    fin = np.isfinite(j_scores)
    np.testing.assert_allclose(t_scores[fin], j_scores[fin], rtol=0, atol=SCORE_ATOL[d])
    np.testing.assert_allclose(t_segmax, np.asarray(j_segmax_t).T, rtol=0, atol=SCORE_ATOL[d])
    # the segment max is the max of the port's own scores, exactly
    assert np.array_equal(t_segmax, t_scores.reshape(q, n // SEG, SEG).max(axis=2))


@pytest.mark.parametrize("n, d", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("q", WIDE_Q)
def test_f32_unmasked_plain_matches_pallas(rng, q, n, d):
    """The unmasked entry on CPU tensors against fused_score_segmax (its
    maxima come back transposed)."""
    queries, corpus = _unit(rng, q, d), _unit(rng, n, d)
    j_scores, j_segmax_t = jax_fused_score_segmax(jnp.asarray(queries), jnp.asarray(corpus), block_n=BLOCK_N)
    before = fused_score_segmax.launches
    t_scores, t_segmax = fused_score_segmax(_t(queries), _t(corpus))
    assert fused_score_segmax.launches == before
    t_scores, t_segmax = t_scores.numpy(), t_segmax.numpy()
    assert t_segmax.shape == (q, n // SEG) and np.isfinite(t_scores).all()
    np.testing.assert_allclose(t_scores, np.asarray(j_scores), rtol=0, atol=SCORE_ATOL[d])
    np.testing.assert_allclose(t_segmax, np.asarray(j_segmax_t).T, rtol=0, atol=SCORE_ATOL[d])
    assert np.array_equal(t_segmax, t_scores.reshape(q, n // SEG, SEG).max(axis=2))


@pytest.mark.parametrize("q", (17, 129))
def test_f32_plain_at_ragged_n(rng, q):
    """N 65,920 (515 segments, not a multiple of the 132 SMs' stride nor
    of the Pallas kernels' group), D 776: both entries against the float64
    product, the freed slots and segments at -inf."""
    n, d = 65920, 776
    queries, corpus, mask = _unit(rng, q, d), _unit(rng, n, d), _freed(rng, n)
    want = queries.astype(np.float64) @ corpus.astype(np.float64).T
    scores, segmax = score_segmax(_t(queries), _t(corpus), _t(mask))
    scores, segmax = scores.numpy(), segmax.numpy()
    assert np.array_equal(np.isneginf(scores), np.broadcast_to(~mask, (q, n)))
    np.testing.assert_allclose(scores[:, mask], want[:, mask], rtol=0, atol=SCORE_ATOL[776])
    assert np.array_equal(segmax, scores.reshape(q, n // SEG, SEG).max(axis=2))
    scores, segmax = fused_score_segmax(_t(queries), _t(corpus))
    np.testing.assert_allclose(scores.numpy(), want, rtol=0, atol=SCORE_ATOL[776])
    np.testing.assert_allclose(segmax.numpy(), want.reshape(q, n // SEG, SEG).max(axis=2), rtol=0,
                               atol=SCORE_ATOL[776])


@pytest.mark.parametrize("w_e, w_l", [(0.5, 0.25), (0.7, 0.3)])
def test_hybrid_topk_packed_q64_f32_slab_matches_jax(rng, w_e, w_l):
    """A Q 64 batch (RAG_TPU_BATCH_MAX=64) on the default f32 slab at
    N 65,536: the packed planes against the JAX package's (its Pallas
    branch in interpret mode, the port's kernel branch). The slab's values
    are multiples of 2^-8 and the queries' of 2^-9, so every score is exact
    in f32 in any summation order: the index, embedding and lexical planes
    are bit-identical; the combined plane too at power-of-two weights, and
    within one ulp otherwise (XLA's CPU backend contracts the blend into one
    FMA, as tests/test_torch_ops.py pins)."""
    n, d, q, k = 65536, 64, 64, 16
    queries, corpus, mask, lex_slots, lex_vals = _exact_bf16_case(rng, n, d, q)
    assert thybrid.uses_score_segmax(n)
    w_e, w_l = np.float32(w_e), np.float32(w_l)
    j = np.asarray(jhybrid.hybrid_topk_packed(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask),
        jnp.asarray(lex_slots), jnp.asarray(lex_vals), jnp.float32(w_e), jnp.float32(w_l), k,
    ))
    t = thybrid.hybrid_topk_packed(
        _t(queries), _t(corpus), _t(mask), _t(lex_slots), _t(lex_vals), torch.tensor(w_e), torch.tensor(w_l), k,
    )
    assert t.dtype == torch.int32 and tuple(t.shape) == (q, 4, k)
    t = t.numpy()
    np.testing.assert_array_equal(t[:, 1:], j[:, 1:])
    if w_e == 0.5:
        np.testing.assert_array_equal(t[:, 0], j[:, 0])
    else:
        assert np.abs(t[:, 0].astype(np.int64) - j[:, 0]).max() <= 1  # 1 ulp
    assert not np.isin(t[:, 3, :], np.flatnonzero(~mask)).any()


DIM = 64
CAPACITY = 65536  # the slab at which both first stages take their score + segment-max branch
BURST = 64
BURST_TOL = 1e-5  # as tests/test_torch_judged.py: f32 dots summed in another order, through the blend
WORDS = ("pump seal leak shaft impeller housing gasket valve actuator pressure relief setpoint spring motor "
         "bearing vibration temperature lubrication grease controller firmware alarm fault reset parameter "
         "filter strainer clogging differential cleaning").split()


def _pdf(rng, i):
    pages = []
    for p in range(3):
        sents = [" ".join(rng.choice(WORDS, 12)).capitalize() + "." for _ in range(20)]
        pages.append(f"SECTION {i}.{p}\n\n" + " ".join(sents))
    return pdfgen.make_pdf(pages)


def test_batcher_q64_burst_on_f32_slab_matches_jax(rng, tmp_path, monkeypatch):
    """RAG_TPU_BATCH_MAX=64 on an f32 engine: a 64-query hot-lane burst is
    one Q 64 batch in the port (the f32 body's 64-query tile on the card)
    and answers what the JAX batcher answers, row for row."""
    monkeypatch.setenv("RAG_TPU_NATIVE_BM25", "0")
    j = JEngine(str(tmp_path / "jax"), JService(JHashEncoder(dim=DIM)))
    t = TEngine(str(tmp_path / "port"), TService(THashEncoder(dim=DIM)), device="cpu")
    j.store = JStore(dim=DIM, initial_capacity=CAPACITY)
    t.store = TStore(DIM, initial_capacity=CAPACITY, device="cpu")
    for i in range(6):
        data = _pdf(rng, i)
        assert j.add_document(f"doc{i}.pdf", data) == t.add_document(f"doc{i}.pdf", data) > 0
    assert t.store.corpus().dtype == torch.float32 and t.store.corpus().shape[0] == CAPACITY
    queries = [" ".join(rng.choice(WORDS, 3)) for _ in range(BURST)]
    sizes = []
    dispatch = t.dispatch_search

    def recording(qs, *a, **kw):
        sizes.append(len(qs))
        return dispatch(qs, *a, **kw)

    t.dispatch_search = recording
    tb = TBatcher(t, TLock(), window_ms=2000, max_batch=BURST)
    jb = JBatcher(j, JLock(), window_ms=2000, max_batch=BURST)
    try:
        got = [f.result(timeout=300) for f in [tb.submit(q, 10, 0.0, None, use_reranker=False) for q in queries]]
        want = [f.result(timeout=300) for f in [jb.submit(q, 10, 0.0, None, use_reranker=False) for q in queries]]
    finally:
        tb.stop()
        jb.stop()
    assert sizes == [BURST]
    for q, a, b in zip(queries, got, want):
        assert len(a) == len(b) > 0, q
        ga = sorted(((r.document, r.chunk_index), r.score) for r in a)
        gb = sorted(((r.document, r.chunk_index), r.score) for r in b)
        floor = min(min(s for _, s in ga), min(s for _, s in gb))
        da, db = dict(ga), dict(gb)
        for key in set(da) ^ set(db):  # a row on one side only ties with the last score
            assert (da.get(key) if key in da else db[key]) - floor <= BURST_TOL, q
        for key in set(da) & set(db):
            assert abs(da[key] - db[key]) <= BURST_TOL, q
            ra = next(r for r in a if (r.document, r.chunk_index) == key)
            rb = next(r for r in b if (r.document, r.chunk_index) == key)
            for f in ("embedding_score", "lexical_score", "initial_score"):
                assert abs(getattr(ra, f) - getattr(rb, f)) <= BURST_TOL, (q, f)
