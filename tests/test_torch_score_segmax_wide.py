"""Port parity for the tensor-core body of score + segment-max (Q > 16 on
bf16 slabs, bf16 queries at any Q): the three-term split of f32 queries,
the plain versions against the JAX Pallas kernels in interpret mode at the
body's query tiles, the hybrid first stage at a Q 64 batch on a bf16 slab,
and the wrapper's query types. On the CPU every wrapper takes its plain
version; the kernel itself is held to the same plain versions on the card
by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_local_rag_tpu.ops import hybrid as jhybrid
from rust_local_rag_tpu.ops.pallas_topk import (
    fused_score_segmax as jax_fused_score_segmax,
    fused_score_segmax_masked,
)
from rust_local_rag_tpu_torch.ops import hybrid as thybrid
from rust_local_rag_tpu_torch.ops.score_segmax import (
    SEG,
    fused_score_segmax,
    fused_score_segmax_plain,
    score_segmax,
    score_segmax_plain,
    score_segmax_terms_plain,
    split_terms_plain,
)

# Both sides sum D exact products of unit vectors in f32 in different
# orders, each within D * 2^-24 of the exact dot: 2 * 64 * 6e-8 < 1e-5.
SCORE_ATOL = 1e-5

# the tensor-core body's query tiles: 64 queries up to Q 64, 128 beyond
WIDE_Q = (32, 64, 128, 129)


def _unit(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(x):
    return torch.tensor(np.asarray(x, dtype=np.uint32).view(np.float32))


def test_split_terms_recover_the_queries_exactly(rng):
    """h + m + l = q with no residual, for seeded unit-normalised rows,
    powers of two, values halfway between two bf16 numbers (round to even
    goes down for 1 + 2^-8, up for 1 + 3 * 2^-8) and the largest f32 whose
    bf16 rounding stays finite."""
    rows = _t(_unit(rng, 64, 768))
    special = torch.cat([
        torch.tensor([1.0, 0.5, -8.0, 2.0**-10, 2.0**-100, 0.0, -0.0]),
        _bits([0x3F808000, 0x3F818000, 0xBF808000, 0x3F800001, 0x3F80FFFF, 0x7F7F7FFF]),
    ])
    for q in (rows, special[None, :]):
        terms = split_terms_plain(q)
        assert terms.dtype == torch.bfloat16 and tuple(terms.shape) == (3, *q.shape)
        h, m, l = (t.float() for t in terms)
        assert torch.equal(q - h - m - l, torch.zeros_like(q))
        assert torch.equal(h + m + l, q)
    # the ties: round to nearest even, the residual exactly one half-ulp
    h, m, l = (t.float() for t in split_terms_plain(special[None, 7:9]))
    assert h.tolist() == [[1.0, 1.0 + 2.0**-6]]
    assert m.tolist() == [[2.0**-8, -(2.0**-8)]] and l.tolist() == [[0.0, 0.0]]


@pytest.mark.parametrize("q", WIDE_Q)
def test_three_term_product_matches_plain(rng, q):
    """The three bf16 x bf16 -> f32 products, summed, against the plain f32
    product of the f32 queries and the widened slab; with bf16 queries the
    one-term product is the plain one exactly."""
    n, d = 4096, 64
    queries = _t(_unit(rng, q, d))
    corpus = _t(_unit(rng, n, d)).to(torch.bfloat16)
    mask = _t(rng.random(n) > 0.2)
    mask[:SEG] = False
    got, got_max = score_segmax_terms_plain(queries, corpus, mask)
    want, want_max = score_segmax_plain(queries, corpus, mask)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    live = torch.isfinite(want)
    torch.testing.assert_close(got[live], want[live], rtol=0, atol=SCORE_ATOL)
    assert torch.equal(got_max, got.view(q, n // SEG, SEG).amax(dim=2))
    torch.testing.assert_close(got_max[:, 1:], want_max[:, 1:], rtol=0, atol=SCORE_ATOL)
    qb = queries.to(torch.bfloat16)
    one, one_max = score_segmax_terms_plain(qb, corpus)
    two, two_max = fused_score_segmax_plain(qb, corpus)
    assert torch.equal(one, two) and torch.equal(one_max, two_max)


def _wide_case(rng, q, query_dtype):
    n, d = 16384, 64
    queries = _unit(rng, q, d)
    corpus = _unit(rng, n, d)
    jq = jnp.asarray(queries).astype(jnp.dtype(query_dtype))
    jc = jnp.asarray(corpus).astype(jnp.bfloat16)
    tq = _t(queries).to(getattr(torch, query_dtype))
    tc = _t(corpus).to(torch.bfloat16)
    return n, jq, jc, tq, tc


@pytest.mark.parametrize("query_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q", WIDE_Q)
def test_wide_masked_plain_matches_pallas(rng, q, query_dtype):
    """The masked entry's plain version (what the tensor-core body is held
    to on the card) against fused_score_segmax_masked, bf16 slab."""
    n, jq, jc, tq, tc = _wide_case(rng, q, query_dtype)
    mask = rng.random(n) > 0.2
    mask[: 2 * SEG] = False  # whole segments freed: their max is -inf
    j_scores, j_segmax_t = fused_score_segmax_masked(jq, jc, jnp.asarray(mask), block_n=1024)
    before = score_segmax.launches
    t_scores, t_segmax = score_segmax(tq, tc, _t(mask))
    assert score_segmax.launches == before  # CPU tensors: the plain version
    j_scores = np.asarray(j_scores)
    t_scores = t_scores.numpy()
    assert np.array_equal(np.isneginf(j_scores), np.isneginf(t_scores))
    assert np.isneginf(t_scores[:, ~mask]).all()
    fin = np.isfinite(j_scores)
    np.testing.assert_allclose(t_scores[fin], j_scores[fin], rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(t_segmax.numpy(), np.asarray(j_segmax_t).T, rtol=0, atol=SCORE_ATOL)
    assert np.array_equal(t_segmax.numpy(), t_scores.reshape(q, n // SEG, SEG).max(axis=2))


@pytest.mark.parametrize("query_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q", WIDE_Q)
def test_wide_unmasked_plain_matches_pallas(rng, q, query_dtype):
    """The unmasked entry's plain version against fused_score_segmax (its
    maxima come back transposed), bf16 slab."""
    n, jq, jc, tq, tc = _wide_case(rng, q, query_dtype)
    j_scores, j_segmax_t = jax_fused_score_segmax(jq, jc, block_n=2048)
    before = fused_score_segmax.launches
    t_scores, t_segmax = fused_score_segmax(tq, tc)
    assert fused_score_segmax.launches == before
    assert tuple(t_segmax.shape) == (q, n // SEG) and np.isfinite(t_scores.numpy()).all()
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores), rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(t_segmax.numpy(), np.asarray(j_segmax_t).T, rtol=0, atol=SCORE_ATOL)


def _exact_bf16_case(rng, n, d, q, lex_width=512, n_lex=40):
    """A bf16 slab whose scores are exact in f32 in any summation order and
    distinct per query: query i is 2^(i % 3) (e_a + 2^-9 e_b) for its own
    column pair (a, b) = (2 (i % (d/2)), 2 (i % (d/2)) + 1), and each pair
    of columns holds k1 2^-8 and k2 2^-8 (k1, k2 in [-128, 128), bf16
    exact) with every (k1, k2) once over the n = 65,536 rows, so a score is
    2^(i % 3 - 17) (512 k1 + k2)."""
    corpus = np.zeros((n, d), np.float32)
    for p in range(d // 2):
        pair = rng.permutation(n)
        corpus[:, 2 * p] = (pair // 256 - 128) * 2.0**-8
        corpus[:, 2 * p + 1] = (pair % 256 - 128) * 2.0**-8
    queries = np.zeros((q, d), np.float32)
    for i in range(q):
        a = 2 * (i % (d // 2))
        queries[i, a] = 2.0 ** (i % 3)
        queries[i, a + 1] = 2.0 ** (i % 3 - 9)
    mask = np.ones(n, bool)
    lex_slots = np.full((q, lex_width), -1, np.int32)
    lex_vals = np.zeros((q, lex_width), np.float32)
    for i in range(q):
        top = np.argsort(-(corpus @ queries[i]))[:5]
        mask[top[1]] = False  # free a slot next to the top hits
        mask[top[0] + 1 if top[0] + 1 < n else top[0] - 1] = False
        slots = rng.choice(n, n_lex, replace=False).astype(np.int32)
        slots[:3] = top[[0, 2, 3]]  # lexical hits that are also dense hits
        slots[3] = top[1]  # a lexical hit on a freed slot
        lex_slots[i, :n_lex] = slots
        lex_vals[i, :n_lex] = rng.random(n_lex).astype(np.float32) * 10
    return queries, corpus, mask, lex_slots, lex_vals


@pytest.mark.parametrize("w_e, w_l", [(0.5, 0.25), (0.7, 0.3)])
def test_hybrid_topk_packed_q64_bf16_slab_matches_jax(rng, w_e, w_l):
    """A Q 64 batch (RAG_TPU_BATCH_MAX=64) on a bf16 slab at N 65,536: the
    packed planes against the JAX package's (its Pallas branch in interpret
    mode, the port's kernel branch). Index, embedding and lexical planes
    are bit-identical; the combined plane too at power-of-two weights, and
    within one ulp otherwise (XLA's CPU backend contracts the blend into
    one FMA, as tests/test_torch_ops.py pins)."""
    n, d, q, k = 65536, 64, 64, 16
    queries, corpus, mask, lex_slots, lex_vals = _exact_bf16_case(rng, n, d, q)
    assert thybrid.uses_score_segmax(n)
    w_e, w_l = np.float32(w_e), np.float32(w_l)
    j = np.asarray(jhybrid.hybrid_topk_packed(
        jnp.asarray(queries), jnp.asarray(corpus).astype(jnp.bfloat16), jnp.asarray(mask),
        jnp.asarray(lex_slots), jnp.asarray(lex_vals), jnp.float32(w_e), jnp.float32(w_l), k,
    ))
    tc = _t(corpus).to(torch.bfloat16)
    assert torch.equal(tc.float(), _t(corpus))  # the slab is bf16-exact
    t = thybrid.hybrid_topk_packed(
        _t(queries), tc, _t(mask), _t(lex_slots), _t(lex_vals), torch.tensor(w_e), torch.tensor(w_l), k,
    )
    assert t.dtype == torch.int32 and tuple(t.shape) == (q, 4, k)
    t = t.numpy()
    np.testing.assert_array_equal(t[:, 1:], j[:, 1:])
    if w_e == 0.5:
        np.testing.assert_array_equal(t[:, 0], j[:, 0])
    else:
        assert np.abs(t[:, 0].astype(np.int64) - j[:, 0]).max() <= 1  # 1 ulp
    assert not np.isin(t[:, 3, :], np.flatnonzero(~mask)).any()


def test_wrapper_query_types(rng):
    """bf16 queries are taken on a bf16 slab (one term on the card) and
    refused on an f32 slab; other query types are refused."""
    queries = _t(_unit(rng, 20, 16))
    corpus = _t(_unit(rng, 1024, 16))
    mask = torch.ones(1024, dtype=torch.bool)
    qb, cb = queries.to(torch.bfloat16), corpus.to(torch.bfloat16)
    s, m = score_segmax(qb, cb, mask)
    ps, pm = score_segmax_plain(qb, cb, mask)
    assert torch.equal(s, ps) and torch.equal(m, pm)
    s, m = fused_score_segmax(qb, cb)
    assert torch.equal(s, ps) and torch.equal(m, pm)
    for bad_q, bad_c in ((qb, corpus), (queries.half(), cb), (queries.double(), corpus)):
        with pytest.raises(TypeError):
            score_segmax(bad_q, bad_c, mask)
        with pytest.raises(TypeError):
            fused_score_segmax(bad_q, bad_c)
    with pytest.raises(TypeError):
        score_segmax(queries, corpus.half(), mask)
