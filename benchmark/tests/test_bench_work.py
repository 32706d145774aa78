"""The operations and bytes the roofline and MFU metrics count, against
hand counts."""

import pytest

from harness import work


def test_score_segmax_bound_f32_q16():
    # 65,536 x 768 f32 rows read, 16 x 768 f32 queries, a 65,536-byte mask,
    # 16 x 65,536 f32 scores and 16 x 512 f32 segment maxima written
    nbytes = 65536 * 768 * 4 + 16 * 768 * 4 + 65536 + 16 * 65536 * 4 + 16 * 512 * 4
    assert work.score_segmax_bound(16, 65536, 768, 4, 4) == pytest.approx(nbytes / 3.35e12)
    assert work.score_segmax_bound(16, 65536, 768, 4, 4) * 1e3 == pytest.approx(0.0614, abs=1e-4)


def test_score_segmax_bound_rounds_rows_to_the_segment_and_counts_operations():
    assert work.score_segmax_bound(1, 129, 8, 4, 4) == work.score_segmax_bound(1, 256, 8, 4, 4)
    # f32 slab, Q 64: 2 x 64 x 65,536 x 768 operations at 67 TFLOP/s bound it
    assert work.score_segmax_bound(64, 65536, 768, 4, 4) == pytest.approx(2 * 64 * 65536 * 768 / 67e12)
    # bf16 slab, f32 queries, Q 512: three bf16 products at 989 TFLOP/s
    assert work.score_segmax_bound(512, 1245184, 768, 2, 4) == pytest.approx(3 * 2 * 512 * 1245184 * 768 / 989e12)


def test_attention_bound():
    # B 128, H 8, L 256, Dh 64, every token valid: q, k, v, out in bf16
    t = work.attention_bound(8, 64, [256] * 128)
    assert t == pytest.approx(4 * 128 * 256 * 8 * 64 * 2 / 3.35e12)
    assert t * 1e3 == pytest.approx(0.0401, abs=1e-4)
    # one long sequence is bound by its operations: 4 x pairs x H x Dh at 989 TFLOP/s
    n = 4096
    assert work.attention_bound(1, 64, [n]) == pytest.approx(4 * n * n * 64 / 989e12)
    assert work.attention_bound(1, 64, [n], causal=True) == pytest.approx(4 * (n * (n + 1) // 2) * 64 / 989e12)


def test_transformer_flops_by_hand():
    cfg = {"dim": 4, "ffn_dim": 6, "depth": 2}
    n = 3
    per_layer = 2 * n * (4 * 4 * 4 + 3 * 4 * 6) + 4 * n * n * 4
    assert work.transformer_flops(cfg, n) == 2 * per_layer
    causal = 2 * n * (4 * 4 * 4 + 3 * 4 * 6) + 4 * 6 * 4
    assert work.transformer_flops(cfg, n, causal=True, head=10) == 2 * causal + 2 * 4 * 10
