"""The port's exact top-k profiles (experiments/profile_topk.py, qscale.py,
qscale2.py, blockn.py) against the JAX functions their scripts call
(scripts/profile_topk.py, exp_qscale.py, exp_qscale2.py, exp_blockn.py),
on the same seeded inputs at a small shape.

The scripts run at full size when imported (all but profile_topk), so
they are not loaded: the JAX side is the same composition of
rust_local_rag_tpu.ops.pallas_topk's fused_score_segmax (in Pallas
interpret mode, as tests/conftest.py sets it) and lax.top_k that the
script's stages compute, and pallas_segmented_topk at the scripts'
(Q, S, block_n) points. The port runs on CPU tensors, where its kernel
wrapper takes the plain version (chip_smoke.py holds the kernel to that
on the card).

Tolerances, each with its reason:
  * scores, segment maxima and the values the stages sum: SCORE_ATOL, as
    in tests/test_torch_experiments.py (both sides sum the same exact
    bf16 products in f32, in another order; |error| <= D eps sum|terms|);
  * selected segments and the small stages' indices: exact (selection
    over scores that agree to that tolerance; these seeds have no
    near-tie there);
  * indices at the scripts' points (Q up to 512, k 100): equal, except
    where two rows' scores tie within SCORE_ATOL and the two sides' sums
    order them differently (assert_same_topk: each differing slot holds
    rows whose float64 scores are within SCORE_ATOL; 2 of 51,200 slots at
    Q 512).
"""

import io
import os
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_local_rag_tpu.ops.pallas_topk import fused_score_segmax as jax_fused, pallas_segmented_topk
from rust_local_rag_tpu_torch.experiments import blockn, common, profile_topk, qscale, qscale2
from rust_local_rag_tpu_torch.ops.score_segmax import segmented_topk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_ATOL = 2e-4
SEG = 128
CPU = torch.device("cpu")


def bf16(rng, shape):
    """(torch bf16, jnp bf16) holding the same standard-normal values."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def jax_stages(s_keep, k):
    """scripts/profile_topk.py's stages over the JAX kernel, as the script
    writes them inside its main()."""
    def st_matmul(qs, c):
        return jnp.einsum("qd,nd->qn", qs, c, preferred_element_type=jnp.float32)[:, :8]

    def st_kernel(qs, c):
        scores, segmax_t = jax_fused(qs, c)
        return scores[:, :8] + segmax_t[:8].T[:, :8]

    def st_segtopk(qs, c):
        scores, segmax_t = jax_fused(qs, c)
        _, seg_idx = jax.lax.top_k(segmax_t.T, s_keep)
        return scores[:, :8] + seg_idx[:, :8]

    def st_gather(qs, c):
        scores, segmax_t = jax_fused(qs, c)
        _, seg_idx = jax.lax.top_k(segmax_t.T, s_keep)
        q, nt = qs.shape[0], c.shape[0] // SEG
        cand = jnp.take_along_axis(scores.reshape(q, nt, SEG), seg_idx[:, :, None], axis=1)
        return cand[:, :8, 0]

    def st_final(qs, c):
        scores, segmax_t = jax_fused(qs, c)
        _, seg_idx = jax.lax.top_k(segmax_t.T, s_keep)
        q, nt = qs.shape[0], c.shape[0] // SEG
        cand = jnp.take_along_axis(scores.reshape(q, nt, SEG), seg_idx[:, :, None], axis=1)
        vals, flat = jax.lax.top_k(cand.reshape(q, s_keep * SEG), k)
        seg_of = jnp.take_along_axis(seg_idx, flat // SEG, axis=1)
        return vals + seg_of[:, :1], (vals, seg_of * SEG + flat % SEG)

    return {"matmul": st_matmul, "kernel": st_kernel, "segtopk": st_segtopk, "gather": st_gather, "final": st_final}


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(5)
    c_t, c_j = bf16(rng, (16384, 64))
    q_t, q_j = bf16(rng, (8, 64))
    return q_t, q_j, c_t, c_j


@pytest.mark.parametrize("stage", ["matmul", "kernel", "segtopk", "gather", "final"])
def test_profile_topk_stage_matches_jax(small, stage):
    q_t, q_j, c_t, c_j = small
    s_keep, k = 16, 10
    want = jax_stages(s_keep, k)[stage](q_j, c_j)
    if stage == "final":
        want, (wv, wi) = want
        gv, gi = profile_topk.pipeline(q_t, c_t, s_keep, k)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=SCORE_ATOL, rtol=0)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    got = profile_topk.stages(s_keep, k)[stage](q_t, c_t)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32), atol=SCORE_ATOL, rtol=0)


def test_profile_topk_segment_choice_is_exact(small):
    q_t, q_j, c_t, c_j = small
    _, segmax_t = jax_fused(q_j, c_j)
    _, want = jax.lax.top_k(segmax_t.T, 16)
    _, sm = profile_topk.fused_score_segmax(q_t, c_t)
    np.testing.assert_array_equal(profile_topk.segment_ids(sm, 16).numpy(), np.asarray(want))


# (Q, S, block_n, N) of each script's exactness check and points: exp_qscale
# (Q 512, block_n picked), exp_qscale2 (Q 512 at 1,024, and its sweep's Q),
# exp_blockn (Q 128 at each block_n, S 128 and 100); N a multiple of
# block_n x 8, as the TPU kernel needs
POINTS = [(512, 128, None, 16384), (512, 128, 1024, 16384), (256, 128, 2048, 16384), (128, 128, 2048, 16384),
          (128, 128, 4096, 32768), (128, 128, 8192, 65536), (128, 128, 1024, 16384), (128, 100, 2048, 16384)]


def assert_same_topk(gv, gi, wv, wi, q, c):
    """Values within SCORE_ATOL; indices equal but where the two picks'
    float64 scores tie within SCORE_ATOL (and at most 1% of slots)."""
    np.testing.assert_allclose(gv, wv, atol=SCORE_ATOL, rtol=0)
    rows, cols = np.nonzero(gi != wi)
    q64, c64 = q.double().numpy(), c.double().numpy()
    a = np.einsum("id,id->i", q64[rows], c64[gi[rows, cols]])
    b = np.einsum("id,id->i", q64[rows], c64[wi[rows, cols]])
    assert np.all(np.abs(a - b) <= SCORE_ATOL), np.abs(a - b).max()
    assert len(rows) <= 0.01 * gi.size


@pytest.mark.parametrize("q,s,blk,n", POINTS)
def test_segmented_topk_matches_pallas_segmented_topk(q, s, blk, n):
    rng = np.random.default_rng(q + s + n)
    c_t, c_j = bf16(rng, (n, 64))
    q_t, q_j = bf16(rng, (q, 64))
    wv, wi = pallas_segmented_topk(q_j, c_j, 100, num_segments=s, block_n=blk)
    gv, gi = segmented_topk(q_t, c_t, 100, num_segments=s)
    assert_same_topk(gv.numpy(), gi.numpy(), np.asarray(wv), np.asarray(wi), q_t, c_t)


@pytest.mark.parametrize("q", qscale.EXACT_Q)
def test_qscale_exactness_check(q, monkeypatch):
    """The module's own check at Q 512 and 1,024 on the CPU: the selection
    equals torch.topk of the (plain) scores, and the plain plane agrees."""
    monkeypatch.setattr(qscale, "EXACT_N", 16384)
    monkeypatch.setattr(qscale, "D", 64)
    r = qscale.exactness(q, CPU)
    assert r["values"] and r["indices"] and r["max_abs_err"] == 0.0 and r["outside_top_k"] == 0


def test_check_topk_sees_a_wrong_answer():
    rng = np.random.default_rng(1)
    c, _ = bf16(rng, (4096, 64))
    q, _ = bf16(rng, (4, 64))
    v, i = segmented_topk(q, c, 10, num_segments=16)
    assert common.check_topk(v, i, q, c, 1e-4) == {"max_abs_err": 0.0, "max_rel_err": 0.0, "outside_top_k": 0}
    worse = torch.topk(common.fused_score_segmax_plain(q, c)[0], 20, dim=1)
    bad = common.check_topk(worse.values[:, 10:], worse.indices[:, 10:].int(), q, c, 1e-4)
    assert bad["outside_top_k"] > 0


def test_tensor_core_unit_mirrors_the_kernel_source():
    """common.tensor_core_unit's constants are csrc/score_segmax.cu's, and
    its units are the ones the source's comment gives (6 stages of 32 KB
    or 5 of 40 KB for one term, 3 of 64 KB or 4 of 56 KB for three)."""
    with open(os.path.join(ROOT, "rust_local_rag_tpu_torch", "csrc", "score_segmax.cu"), encoding="utf-8") as f:
        src = f.read()
    for name, value in (("W_QROWS", common.W_QROWS), ("W_ROW", common.W_ROW), ("SMEM_MAX", common.SMEM_MAX)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(value)
    assert "W_RING_MAX = SMEM_MAX - 1024 - 6 * 16" in src and ": 6;" in src
    one, three = common.tensor_core_unit(128), common.tensor_core_unit(128, 3)
    assert (one["stages"], one["unit_queries"], one["unit_rows"]) == (6, 128, 128)
    assert (three["stages"], common.tensor_core_unit(64)["stages"], common.tensor_core_unit(64, 3)["stages"]) == (3, 5, 4)
    assert one["smem_bytes"] == 197_728 and "197,728 B" in qscale2.__doc__.replace("\n", " ")
    assert [common.tensor_core_unit(q)["query_tiles"] for q in (1, 64, 65, 512, 1024)] == [1, 1, 1, 4, 8]


def _run(mod, monkeypatch, **shape):
    for m in (mod, qscale):
        for k, v in shape.items():
            if hasattr(m, k):
                monkeypatch.setattr(m, k, v)
    monkeypatch.setattr(common, "STEPS", 1)
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = mod.main(device=CPU)
    return out, buf.getvalue()


def test_profile_topk_main_prints_the_scripts_json_line(monkeypatch):
    monkeypatch.setenv("BENCH_N", "16384")
    monkeypatch.setattr(profile_topk, "D", 64)
    monkeypatch.setattr(profile_topk, "Q", 8)
    out, text = _run(profile_topk, monkeypatch)
    assert list(out) == ["matmul_ms", "kernel_ms", "segtopk_ms", "gather_ms", "final_ms"]
    assert '"final_ms": NaN' in text.splitlines()[-1]


def test_qscale_main_checks_and_sweeps(monkeypatch):
    out, text = _run(qscale, monkeypatch, N=16384, D=64, EXACT_N=16384, SWEEP_Q=(128, 1024))
    assert "Q=512 exact: True True" in text and "Q=1024 exact: True True" in text
    assert "Q=1024:" in text and "8 query tile(s)" in text


def test_qscale2_main_keeps_the_scripts_points(monkeypatch):
    out, text = _run(qscale2, monkeypatch, N=16384, D=64, EXACT_N=16384)
    for q, blk in qscale2.POINTS:
        assert f"Q={q} blk={blk}:" in text
    assert "Q=512 blk=1024 exact: True True" in text and "qps ratio" in text


def test_blockn_main_keeps_the_scripts_points(monkeypatch):
    out, text = _run(blockn, monkeypatch, N=16384, D=64)
    assert list(out) == list(blockn.POINTS)
    for blk, s in blockn.POINTS:
        assert f"grid blk={blk} S={s}:" in text
