"""The port's ops/quantized.py against rust_local_rag_tpu/ops/quantized.py
on the same seeded numpy inputs.

Tolerances: quantize_corpus and gather_dequantized are bit-identical (the
same f32 operations, one rounding each, round half to even in both);
int8_scores is exact (int32 sums of int8 products). quantized_topk's
rescored values are f32 dots of 64 terms summed in another order (XLA's
CPU dot against torch.bmm): within 1e-6, with the same index sets except
for a slot that ties within 1e-6 with the k-th score.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_local_rag_tpu.ops import quantized as jq
from rust_local_rag_tpu_torch.ops import quantized as tq

TIE_TOL = 1e-6


def _unit(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


@pytest.mark.parametrize("n,d,seed", [(1, 8, 0), (100, 64, 1), (333, 20, 2), (4000, 768, 3)])
def test_quantize_corpus_bit_identical(n, d, seed):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32) * rng.uniform(1e-3, 10, (n, 1)).astype(np.float32)
    corpus[0, :] = 0.0  # absmax 0: the 1e-10 floor
    if n > 2:
        # exact halves after scaling: round half to even in both packages
        corpus[1, :4] = np.array([127.0, 0.5, 1.5, -2.5], np.float32)
    want = jq.quantize_corpus(jnp.asarray(corpus))
    got = tq.quantize_corpus(torch.from_numpy(corpus))
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


def test_gather_dequantized_bit_identical():
    rng = np.random.default_rng(4)
    corpus = _unit(rng, 500, 64)
    want_q = jq.quantize_corpus(jnp.asarray(corpus))
    values, scales = np.array(want_q.values), np.array(want_q.scales)
    slots = rng.integers(0, 500, (3, 7)).astype(np.int32)
    want = np.asarray(jq.gather_dequantized(jnp.asarray(values), jnp.asarray(scales), jnp.asarray(slots)))
    got = tq.gather_dequantized(torch.from_numpy(values), torch.from_numpy(scales), torch.from_numpy(slots))
    assert got.shape == (3, 7, 64) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q,n,d", [(1, 40, 64), (3, 5, 20), (8, 16, 16), (9, 17, 24), (17, 100, 768), (64, 4096, 768)])
def test_int8_scores_exact_at_the_cards_shapes(q, n, d, monkeypatch):
    """Exact int32 sums, and every _int_mm call gets a shape the card's
    cuBLASLt int8 GEMM takes (M > 16, K and N multiples of 8, both
    operands K-major), whatever Q, N and D are; a slab whose N and D are
    multiples of 8 goes in as it is (no copy)."""
    seen = []
    int_mm = torch._int_mm

    def checking(a, b):
        seen.append((tuple(a.shape), tuple(b.shape), a.stride(1), b.stride(0), b.data_ptr()))
        return int_mm(a, b)

    monkeypatch.setattr(torch, "_int_mm", checking)
    rng = np.random.default_rng(q * 1000 + n)
    v = rng.integers(-127, 128, (n, d)).astype(np.int8)
    qs = rng.integers(-127, 128, (q, d)).astype(np.int8)
    values = torch.from_numpy(v)
    got = tq.int8_scores(torch.from_numpy(qs), values)
    assert got.dtype == torch.int32 and tuple(got.shape) == (q, n)
    np.testing.assert_array_equal(got.numpy(), qs.astype(np.int64) @ v.astype(np.int64).T)
    ((m, k), (k2, nn), a_k_stride, b_k_stride, b_ptr), = seen
    assert m > 16 and k % 8 == 0 and k2 == k and nn % 8 == 0
    assert a_k_stride == 1 and b_k_stride == 1
    assert (b_ptr == values.data_ptr()) == (n % 8 == 0 and d % 8 == 0)


@pytest.mark.parametrize("n,candidates", [(4000, 512), (65536, 128)])
def test_quantized_topk_matches_jax(n, candidates):
    """N 4,000: the selection covers every segment (a full top-k); N 65,536
    at 128 candidates: the segmented selection."""
    rng = np.random.default_rng(n)
    corpus = _unit(rng, n, 64)
    queries = _unit(rng, 4, 64)
    k = 10
    qc = jq.quantize_corpus(jnp.asarray(corpus))
    jv, ji = (np.asarray(x) for x in jq.quantized_topk(jnp.asarray(queries), qc, k, candidates=candidates))
    tqc = tq.QuantizedCorpus(torch.from_numpy(np.array(qc.values)), torch.from_numpy(np.array(qc.scales)))
    tv, ti = tq.quantized_topk(torch.from_numpy(queries), tqc, k, candidates=candidates)
    assert ti.dtype == torch.int32
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_allclose(tv, jv, atol=TIE_TOL, rtol=0)
    for r in range(4):
        # a slot on one side only must tie with that side's k-th score
        for vals, idx, other in ((tv[r], ti[r], ji[r]), (jv[r], ji[r], ti[r])):
            for v, slot in zip(vals, idx):
                assert slot in other or v - vals[-1] <= TIE_TOL, (r, slot)
    # rescored values are f32 dots against the dequantised rows
    deq = np.asarray(qc.values, np.float32) * np.asarray(qc.scales)
    for r in range(4):
        np.testing.assert_allclose(tv[r], deq[ti[r]] @ queries[r], atol=1e-6, rtol=0)
