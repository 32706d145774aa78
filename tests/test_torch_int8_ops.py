"""The port's int8 first stage (ops/hybrid.hybrid_topk_quantized, its
packed form and hybrid_topk_dequant_full) against the JAX package's, on
the same seeded numpy inputs: D 64, N 4,000 (a full top-k selects the
pool) and N 65,536 (the segmented selection), slots freed across the slab,
lexical hits that repeat dense winners, point at freed slots or pad, and a
zero query row (the batch's padding).

Tolerances and why:
  * int32 scores: equal (exact integer sums);
  * p1 = s * q_scale * scale_i: bit-identical (the int32 sums are below
    2^24, so they widen exactly, and both multiply in the same order);
  * the upper bound u = p1 + eps: within 2 ulp of |p1| + |eps|. XLA's
    CPU fusion contracts both additions into FMAs (eps's `* 1.001 + 1e-6`
    and `p1 + eps`), torch rounds each product first: two roundings of
    each side differ. An ulp of u itself is no measure, because p1 and eps
    cancel where u is near 0;
  * rescored, combined and normalised lexical planes and the candidate
    similarities: within 1e-6 (f32 dots of 64 terms summed in another
    order; XLA's FMA contraction of the blend);
  * result sets equal, except a slot that ties within 1e-6 with the k-th
    score; certificates equal wherever the k-th rescored pool score lies
    farther than 1e-6 from tau (the cut). On these seeds no query lies
    that close: the band test below is where certificates fail.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_local_rag_tpu.ops import hybrid as jh
from rust_local_rag_tpu.ops.quantized import quantize_corpus as j_quantize
from rust_local_rag_tpu_torch.ops import hybrid as th

D = 64
Q = 6
TOL = 1e-6
W_E, W_L = 0.7, 0.3


def _unit(rng, n, d=D):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _data(n: int, lex_width: int = 512):
    """Seeded int8 corpus (the JAX package's quantisation) with l1, a mask,
    queries and lexical hits, as numpy arrays."""
    rng = np.random.default_rng(n)
    corpus = _unit(rng, n)
    qc = j_quantize(jnp.asarray(corpus))
    values, scales = np.array(qc.values), np.array(qc.scales)
    l1 = (scales[:, 0] * np.abs(values).astype(np.float32).sum(axis=1)).astype(np.float32)
    mask = rng.random(n) > 0.05
    mask[128:256] = False  # a wholly freed segment
    queries = _unit(rng, Q)
    queries[-1] = 0.0  # a padded batch row
    dense = queries @ (values.astype(np.float32) * scales).T
    lex_slots = np.full((Q, lex_width), -1, np.int32)
    lex_vals = np.zeros((Q, lex_width), np.float32)
    for qi in range(Q - 1):
        top = np.argsort(-np.where(mask, dense[qi], -np.inf))[:5]  # dense winners again
        freed = np.flatnonzero(~mask)[:3]
        other = rng.choice(n, 40, replace=False)
        hits = np.unique(np.concatenate([top, freed, other]))
        rng.shuffle(hits)
        lex_slots[qi, : len(hits)] = hits
        lex_vals[qi, : len(hits)] = rng.random(len(hits)).astype(np.float32) * 8
    return values, scales, l1, mask, queries, lex_slots, lex_vals


def _jax_args(d):
    values, scales, l1, mask, queries, ls, lv = d
    return (jnp.asarray(queries), jnp.asarray(values), jnp.asarray(scales), jnp.asarray(l1), jnp.asarray(mask),
            jnp.asarray(ls), jnp.asarray(lv), jnp.float32(W_E), jnp.float32(W_L))


def _port_args(d):
    values, scales, l1, mask, queries, ls, lv = (torch.from_numpy(np.array(x)) for x in d)
    return (queries, values, scales, l1, mask, ls, lv, torch.tensor(W_E), torch.tensor(W_L))


def _drop_l1(args):
    return args[:3] + args[4:]


def _same_rows(got, want, what):
    """(vals, emb, lex, idx) planes of both packages: per query the same
    slots (a slot on one side only ties with that side's k-th score) and
    the three score planes within TOL on the common slots."""
    gv, ge, gl, gi = (np.asarray(x) for x in got[:4])
    wv, we, wl, wi = (np.asarray(x) for x in want[:4])
    assert gi.shape == wi.shape, what
    for r in range(gi.shape[0]):
        g = {int(s): (gv[r, j], ge[r, j], gl[r, j]) for j, s in enumerate(gi[r]) if s >= 0}
        w = {int(s): (wv[r, j], we[r, j], wl[r, j]) for j, s in enumerate(wi[r]) if s >= 0}
        assert len(g) == len(w), (what, r)
        for side, other, plane in ((g, w, gv[r]), (w, g, wv[r])):
            last = plane[plane > -np.inf].min() if (plane > -np.inf).any() else -np.inf
            for s, row in side.items():
                assert s in other or row[0] - last <= TOL, (what, r, s)
        for s in g.keys() & w.keys():
            np.testing.assert_allclose(g[s], w[s], atol=TOL, rtol=0, err_msg=f"{what} row {r} slot {s}")
        np.testing.assert_array_equal(np.isneginf(gv[r]), np.isneginf(wv[r]))


@jax.jit
def _jax_phase1(queries, values, scales, l1, valid_mask):
    """rust_local_rag_tpu/ops/hybrid.py:514-527, the lines of
    hybrid_topk_quantized that make the int32 scores, p1 and u, jitted as
    the package jits them (the function returns none of the three)."""
    q32 = queries.astype(jnp.float32)
    q_absmax = jnp.max(jnp.abs(q32), axis=1, keepdims=True)
    q_scale = jnp.maximum(q_absmax, 1e-10) / 127.0
    q_int8 = jnp.clip(jnp.round(q32 / q_scale), -127, 127).astype(jnp.int8)
    scores_i32 = jax.lax.dot_general(
        q_int8, values, dimension_numbers=(((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
    )
    emb = scores_i32.astype(jnp.float32) * q_scale * scales[:, 0][None, :]
    eps = (q_scale * 0.5) * l1[None, :] * 1.001 + 1e-6
    upper = jnp.where(valid_mask[None, :], emb + eps, -jnp.inf)
    return scores_i32, emb, eps, upper


@pytest.mark.parametrize("n", [4000, 65536])
def test_phase1_planes(n):
    d = _data(n)
    values, scales, l1, mask, queries = d[:5]
    js, jp1, jeps, ju = (np.asarray(x) for x in _jax_phase1(queries, values, scales, l1, mask))
    q, v, sc, l1_t, m = (torch.from_numpy(np.array(x)) for x in (queries, values, scales, l1, mask))
    q_int8, _ = th.quantize_rows(q)
    np.testing.assert_array_equal(th.int8_scores(q_int8, v).numpy(), js)
    p1, q_scale = th._int8_p1(q, v, sc)
    np.testing.assert_array_equal(p1.numpy(), jp1)
    u = th._int8_upper(p1, q_scale, l1_t, m).numpy()
    np.testing.assert_array_equal(np.isneginf(u), np.isneginf(ju))
    live = np.isfinite(ju)
    ulp = np.spacing((np.abs(jp1) + np.abs(jeps))[live])
    assert (np.abs(u[live] - ju[live]) <= 2 * ulp).all()


def _margins(d, k, c):
    """k-th rescored pool score minus tau per query, from the port's upper
    bounds and a float64 rescore (to tell a certificate that may
    legitimately differ by rounding, |margin| <= TOL)."""
    values, scales, l1, mask, queries = d[:5]
    q, v, sc, l1_t, m = (torch.from_numpy(np.array(x)) for x in (queries, values, scales, l1, mask))
    p1, q_scale = th._int8_p1(q, v, sc)
    u = th._int8_upper(p1, q_scale, l1_t, m).numpy()
    deq = values.astype(np.float64) * scales
    out = []
    for r in range(u.shape[0]):
        order = np.argsort(-u[r], kind="stable")[:c]
        pool = order[np.isfinite(u[r][order])]
        tau = -np.inf if mask.sum() <= c else u[r][order[-1]]
        kth = np.sort(deq[pool] @ queries[r].astype(np.float64))[::-1][min(k, len(pool)) - 1]
        out.append(kth - tau)
    return np.array(out)


@pytest.mark.parametrize("n", [4000, 65536])
@pytest.mark.parametrize("k,candidates", [(16, 0), (128, 0), (16, 2048)])
@pytest.mark.parametrize("with_sims", [False, True])
def test_hybrid_topk_quantized_matches_jax(n, k, candidates, with_sims):
    d = _data(n)
    want = jh.hybrid_topk_quantized(*_jax_args(d), k, with_sims=with_sims, candidates=candidates)
    got = th.hybrid_topk_quantized(*_port_args(d), k, with_sims=with_sims, candidates=candidates)
    assert len(got) == len(want) == (6 if with_sims else 5)
    assert got[3].dtype == torch.int32 and got[4].dtype == torch.bool
    _same_rows(got, want, f"n{n} k{k}")
    c = candidates if candidates > 0 else min(th._next_pow2(4 * k), n)
    margin = _margins(d, k, c)
    far = np.abs(margin) > TOL
    np.testing.assert_array_equal(got[4].numpy()[far], np.asarray(want[4])[far])
    np.testing.assert_array_equal(got[4].numpy()[far], margin[far] >= 0)
    if with_sims:
        gi, wi = got[3].numpy(), np.asarray(want[3])
        for r in range(Q):
            if np.array_equal(gi[r], wi[r]):
                np.testing.assert_allclose(got[5][r].numpy(), np.asarray(want[5])[r], atol=TOL, rtol=0)


@pytest.mark.parametrize("n", [4000, 65536])
def test_packed_layout(n):
    d = _data(n)
    k = 16
    want = np.asarray(jh.hybrid_topk_quantized_packed(*_jax_args(d), k))
    got = th.hybrid_topk_quantized_packed(*_port_args(d), k)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (Q, 5, k)
    planes = th.hybrid_topk_quantized(*_port_args(d), k)
    got = got.numpy()
    assert (got[:, 4, :] == planes[4].numpy()[:, None]).all()
    np.testing.assert_array_equal(got[:, 4, :], want[:, 4, :])
    vals, emb, lex, idx = th.unpack_topk(got, Q, k)
    np.testing.assert_array_equal(idx, planes[3].numpy())
    np.testing.assert_array_equal(vals, planes[0].numpy())
    _same_rows((vals, emb, lex, idx), jh.unpack_topk(want, Q, k), f"packed n{n}")


@pytest.mark.parametrize("n", [4000, 65536])
@pytest.mark.parametrize("with_sims", [False, True])
def test_dequant_full_matches_jax(n, with_sims):
    d = _data(n)
    k = 32
    want = jh.hybrid_topk_dequant_full(*_drop_l1(_jax_args(d)), k, with_sims=with_sims)
    got = th.hybrid_topk_dequant_full(*_drop_l1(_port_args(d)), k, with_sims=with_sims)
    assert len(got) == len(want)
    _same_rows(got, want, f"dequant_full n{n}")
    if with_sims:
        gi, wi = got[3].numpy(), np.asarray(want[3])
        for r in range(Q):
            if np.array_equal(gi[r], wi[r]):
                np.testing.assert_allclose(got[4][r].numpy(), np.asarray(want[4])[r], atol=TOL, rtol=0)


def test_dequant_full_row_blocks(monkeypatch):
    """The escalation widens the slab a block of rows at a time: blocks of
    1,000 rows (the last one short) give the one-block answer."""
    d = _data(4000)
    whole = th.hybrid_topk_dequant_full(*_drop_l1(_port_args(d)), 32)
    monkeypatch.setattr(th, "DEQUANT_BLOCK_ROWS", 1000)
    blocked = th.hybrid_topk_dequant_full(*_drop_l1(_port_args(d)), 32)
    _same_rows(blocked, whole, "row blocks")


def _adversarial_corpus(n=4000, k_band=200, seed=3):
    """tests/test_int8_exact.py's corpus: 200 rows whose true cosines to one
    direction sit in [0.7, 0.70002], a band narrower than the int8 query
    quantisation error, and 3,800 rows at cosine < 0.3."""
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


def test_adversarial_band_fails_the_certificate_in_both():
    emb, base = _adversarial_corpus()
    qc = j_quantize(jnp.asarray(emb))
    values, scales = np.array(qc.values), np.array(qc.scales)
    l1 = (scales[:, 0] * np.abs(values).astype(np.float32).sum(axis=1)).astype(np.float32)
    mask = np.ones(len(emb), bool)
    lex = (np.full((1, 512), -1, np.int32), np.zeros((1, 512), np.float32))
    rng = np.random.default_rng(0)
    rand = _unit(rng, 1)[0]
    for q, certifies in ((base, False), (rand, True)):
        d = (values, scales, l1, mask, q[None, :], *lex)
        jflag = bool(np.asarray(jh.hybrid_topk_quantized(*_jax_args(d)[:-2], jnp.float32(1.0), jnp.float32(0.0),
                                                         32)[4])[0])
        tflag = bool(th.hybrid_topk_quantized(*_port_args(d)[:-2], torch.tensor(1.0), torch.tensor(0.0), 32)[4][0])
        assert jflag == tflag == certifies
    # the escalation lane answers the band exactly in both packages: a top-32
    # of a float64 scan of the dequantised rows (up to rows tied with its
    # 32nd score within TOL), with the true scores within TOL
    d = (values, scales, l1, mask, base[None, :], *lex)
    truth = (values.astype(np.float64) @ base.astype(np.float64)) * scales[:, 0]
    kth = np.sort(truth)[::-1][31]
    t = th.hybrid_topk_dequant_full(*_drop_l1(_port_args(d))[:-2], torch.tensor(1.0), torch.tensor(0.0), 32)
    j = jh.hybrid_topk_dequant_full(*_drop_l1(_jax_args(d))[:-2], jnp.float32(1.0), jnp.float32(0.0), 32)
    for idx, vals in ((t[3].numpy()[0], t[0].numpy()[0]), (np.asarray(j[3])[0], np.asarray(j[0])[0])):
        assert len(set(idx.tolist())) == 32 and (truth[idx] >= kth - TOL).all()
        np.testing.assert_allclose(vals, truth[idx], atol=TOL, rtol=0)
