"""Port parity: score + segment-max, segmented exact top-k and the hybrid
first stage against the JAX package, on the CPU.

The JAX side runs the Pallas kernel in interpret mode (tests/conftest.py
sets RAG_TPU_PALLAS_INTERPRET); the port's wrapper takes its plain version
because the tensors lie on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_local_rag_tpu.ops import fast_topk as jfast
from rust_local_rag_tpu.ops import hybrid as jhybrid
from rust_local_rag_tpu.ops.pallas_topk import fused_score_segmax_masked
from rust_local_rag_tpu_torch.ops import fast_topk as tfast
from rust_local_rag_tpu_torch.ops import hybrid as thybrid
from rust_local_rag_tpu_torch.ops.score_segmax import (
    SEG,
    score_segmax,
    score_segmax_plain,
)

# Tolerance of the f32 score comparisons: both sides sum D products of
# unit vectors in f32 in different orders, so each is within D * 2^-24 of
# the exact dot (|sum| <= |q| |c| = 1); 2 * 64 * 6e-8 < 1e-5 at D = 64.
SCORE_ATOL = 1e-5


def _unit(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("corpus_dtype", ["float32", "bfloat16"])
def test_score_segmax_plain_matches_pallas_masked(rng, corpus_dtype):
    q, n, d = 8, 16384, 64
    queries = _unit(rng, q, d)
    corpus = _unit(rng, n, d)
    mask = rng.random(n) > 0.2
    mask[: 2 * SEG] = False  # whole segments freed: their max is -inf
    jc = jnp.asarray(corpus).astype(jnp.dtype(corpus_dtype))
    j_scores, j_segmax_t = fused_score_segmax_masked(
        jnp.asarray(queries), jc, jnp.asarray(mask), block_n=1024
    )
    tc = _t(corpus).to(getattr(torch, corpus_dtype))
    t_scores, t_segmax = score_segmax_plain(_t(queries), tc, _t(mask))
    j_scores = np.asarray(j_scores)
    t_scores = t_scores.numpy()
    assert np.array_equal(np.isneginf(j_scores), np.isneginf(t_scores))
    assert np.isneginf(t_scores[:, ~mask]).all()
    fin = np.isfinite(j_scores)
    if corpus_dtype == "float32":
        np.testing.assert_allclose(t_scores[fin], j_scores[fin], rtol=0, atol=SCORE_ATOL)
        np.testing.assert_allclose(
            t_segmax.numpy(), np.asarray(j_segmax_t).T, rtol=0, atol=SCORE_ATOL
        )
    else:
        # the Pallas bf16 branch runs DEFAULT precision (bf16 passes for
        # the f32 queries); the port widens the bf16 slab exactly and sums
        # in f32, so the two differ by the queries' bf16 rounding:
        # |q - bf16(q)| . c <= 2^-8 |q| |c|
        np.testing.assert_allclose(t_scores[fin], j_scores[fin], rtol=0, atol=2.0**-8)
    # the segment max is the max of the port's own scores, exactly
    assert np.array_equal(t_segmax.numpy(), t_scores.reshape(q, n // SEG, SEG).max(axis=2))


def test_score_segmax_cpu_wrapper_is_plain_and_uncounted(rng):
    q, n, d = 3, 1024, 16
    queries = _t(_unit(rng, q, d))
    corpus = _t(_unit(rng, n, d))
    mask = _t(rng.random(n) > 0.5)
    before = score_segmax.launches
    s, m = score_segmax(queries, corpus, mask)
    ps, pm = score_segmax_plain(queries, corpus, mask)
    assert torch.equal(s, ps) and torch.equal(m, pm)
    assert score_segmax.launches == before  # CPU runs are no launches


@pytest.mark.parametrize(
    "bad, err",
    [
        (lambda q, c, m: (q, c[:1000], m[:1000]), ValueError),  # N % 128
        (lambda q, c, m: (q, c[:, :8], m), ValueError),  # D mismatch
        (lambda q, c, m: (q, c, m.float()), TypeError),  # mask dtype
        (lambda q, c, m: (q[0], c, m), ValueError),  # rank
        (lambda q, c, m: (q.to("meta"), c.to("meta"), m.to("meta")), ValueError),
    ],
)
def test_score_segmax_rejects_bad_inputs(rng, bad, err):
    q = _t(_unit(rng, 2, 16))
    c = _t(_unit(rng, 1024, 16))
    m = torch.ones(1024, dtype=torch.bool)
    with pytest.raises(err):
        score_segmax(*bad(q, c, m))


@pytest.mark.parametrize("k", [1, 10, 100])
def test_segmented_select_from_matches_jax(rng, k):
    q, nt, t = 4, 64, 128
    scores = rng.standard_normal((q, nt * t)).astype(np.float32)
    segmax = scores.reshape(q, nt, t).max(axis=2)
    jv, ji = jfast.segmented_select_from(jnp.asarray(scores), jnp.asarray(segmax), k, num_segments=16)
    tv, ti = tfast.segmented_select_from(_t(scores), _t(segmax), k, num_segments=16)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n, k", [(70000, 10), (65536, 100), (300, 5), (4, 8)])
def test_segmented_exact_topk_scores_matches_jax(rng, n, k):
    scores = rng.standard_normal((3, n)).astype(np.float32)
    scores[:, ::7] = -np.inf
    jv, ji = jfast.segmented_exact_topk_scores(jnp.asarray(scores), k)
    tv, ti = tfast.segmented_exact_topk_scores(_t(scores), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    fin = np.isfinite(np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy()[fin], np.asarray(ji)[fin])


def _exact_case(rng, n, d, q, lex_width=512, n_lex=40):
    """Corpus whose scores are exact in f32 in any summation order: each
    query is 2^e times a basis vector, and each corpus column holds
    distinct multiples of 2^-16, so every score is a distinct product of
    a power of two and one corpus entry (no ties, no rounding)."""
    corpus = np.zeros((n, d), np.float32)
    for j in range(d):
        corpus[:, j] = (rng.permutation(n) - n // 2).astype(np.float32) * 2.0**-16
    queries = np.zeros((q, d), np.float32)
    for i in range(q):
        queries[i, i % d] = 2.0 ** (i % 3)
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


@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("w_e, w_l", [(0.5, 0.25), (0.7, 0.3)])
def test_hybrid_topk_packed_bit_identical_kernel_branch(rng, k, w_e, w_l):
    """Packed planes against the JAX package's at N = 65536 (its Pallas
    branch, the port's kernel branch), freed slots next to top hits.

    Index, embedding and lexical planes are bit-identical. The combined
    plane is bit-identical when the weights are powers of two; with other
    weights it may differ in the last bit, because XLA's CPU backend
    contracts w_e * emb + w_l * lex into one FMA (one rounding fewer)
    while PyTorch rounds each product. The selection is unaffected here:
    the index plane is identical in both cases."""
    n, d, q = 65536, 8, 4
    queries, corpus, mask, lex_slots, lex_vals = _exact_case(rng, n, d, q)
    assert thybrid.uses_score_segmax(n)
    w_e, w_l = np.float32(w_e), np.float32(w_l)
    j = np.asarray(jhybrid.hybrid_topk_packed(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask),
        jnp.asarray(lex_slots), jnp.asarray(lex_vals),
        jnp.float32(w_e), jnp.float32(w_l), k,
    ))
    t = thybrid.hybrid_topk_packed(
        _t(queries), _t(corpus), _t(mask), _t(lex_slots), _t(lex_vals),
        torch.tensor(w_e), torch.tensor(w_l), k,
    )
    assert t.dtype == torch.int32 and tuple(t.shape) == (q, 4, k)
    t = t.numpy()
    np.testing.assert_array_equal(t[:, 1:], j[:, 1:])
    if w_e == 0.5:
        np.testing.assert_array_equal(t[:, 0], j[:, 0])
    else:
        assert np.abs(t[:, 0].astype(np.int64) - j[:, 0]).max() <= 1  # 1 ulp
    assert not np.isin(t[:, 3, :], np.flatnonzero(~mask)).any()


def test_hybrid_branches_agree(rng):
    """The kernel branch (N = 65536) and the plain segmented branch
    (N = 65536 + 128, not a multiple of 16384) select the same rows."""
    n, d, q, k = 65536, 8, 4, 32
    queries, corpus, mask, lex_slots, lex_vals = _exact_case(rng, n, d, q)
    pad_corpus = np.concatenate([corpus, np.zeros((SEG, d), np.float32)])
    pad_mask = np.concatenate([mask, np.zeros(SEG, bool)])
    assert not thybrid.uses_score_segmax(n + SEG)
    args = (_t(lex_slots), _t(lex_vals), torch.tensor(0.7), torch.tensor(0.3), k)
    a = thybrid.hybrid_topk_packed(_t(queries), _t(corpus), _t(mask), *args)
    b = thybrid.hybrid_topk_packed(_t(queries), _t(pad_corpus), _t(pad_mask), *args)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1000, 4096])
def test_hybrid_topk_small_slab_matches_jax(rng, n):
    """Below 65536 both packages take a plain top-k; random unit vectors,
    so scores agree to SCORE_ATOL and index sets exactly."""
    d, q, k = 32, 5, 8
    corpus = _unit(rng, n, d)
    queries = _unit(rng, q, d)
    mask = rng.random(n) > 0.1
    lex_slots = np.full((q, 512), -1, np.int32)
    lex_vals = np.zeros((q, 512), np.float32)
    for i in range(q):  # distinct hits per query, as BM25 gives them
        lex_slots[i, :20] = rng.permutation(n)[:20]
        lex_vals[i, :20] = rng.random(20) * 5
    jv, je, jl, ji = jhybrid.hybrid_topk(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask),
        jnp.asarray(lex_slots), jnp.asarray(lex_vals), jnp.float32(0.7), jnp.float32(0.3), k,
    )
    tv, te, tl, ti = thybrid.hybrid_topk(
        _t(queries), _t(corpus), _t(mask), _t(lex_slots), _t(lex_vals),
        torch.tensor(0.7), torch.tensor(0.3), k,
    )
    for qi in range(q):
        assert set(ti[qi].tolist()) == set(np.asarray(ji)[qi].tolist())
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_hybrid_fewer_valid_than_k():
    corpus = np.eye(4, 8, dtype=np.float32)
    corpus = np.concatenate([corpus, np.zeros((124, 8), np.float32)])
    mask = np.zeros(128, bool)
    mask[:3] = True
    queries = corpus[:1].copy()
    lex_slots = np.full((1, 512), -1, np.int32)
    lex_vals = np.zeros((1, 512), np.float32)
    v, e, l, i = thybrid.hybrid_topk(
        _t(queries), _t(corpus), _t(mask), _t(lex_slots), _t(lex_vals),
        torch.tensor(0.7), torch.tensor(0.3), 8,
    )
    assert sorted(i[0, :3].tolist()) == [0, 1, 2]
    assert i[0, 3:].tolist() == [-1] * 5
    assert torch.isneginf(v[0, 3:]).all()


def test_unpack_and_lex_helpers_match_jax(rng):
    arr = rng.integers(-(2**31), 2**31 - 1, size=(4, 4, 16), dtype=np.int64).astype(np.int32)
    for a, b in zip(thybrid.unpack_topk(arr, 3, 10), jhybrid.unpack_topk(arr, 3, 10)):
        np.testing.assert_array_equal(a, b)
    for r in (1, 50, 512, 513, 2048, 5000):
        assert thybrid.lex_width_for(r) == jhybrid.lex_width_for(r)
    assert thybrid.LEX_WIDTH_BUCKETS == jhybrid.LEX_WIDTH_BUCKETS
    pairs = [("a", 3.0), ("zz", 2.0), ("b", 1.5)]
    slot_for = {"a": 7, "b": 9}.get
    for x, y in zip(
        thybrid.pack_sparse_lex(pairs, slot_for, width=4),
        jhybrid.pack_sparse_lex(pairs, slot_for, width=4),
    ):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(TypeError):
        thybrid.unpack_topk(arr.astype(np.float32), 1, 1)


def test_jax_stays_on_cpu():
    assert jax.devices()[0].platform == "cpu"
