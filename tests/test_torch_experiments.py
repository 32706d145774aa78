"""The port's experiment modules (rust_local_rag_tpu_torch/experiments/)
against the TPU kernels of the JAX scripts they port (scripts/exp_*.py),
on the same seeded inputs at a small shape.

Each script is loaded by path, its shape globals set small, and its `pl`
replaced by a namespace whose pallas_call runs in Pallas interpret mode on
the CPU (pltpu.InterpretParams); scripts/ itself is not edited. The
scripts set jax_compilation_cache_dir when imported; the loader puts the
two cache settings back at once. The port's side runs on CPU tensors, so
each wrapper takes its kernel's plain version (the kernels themselves are
held to those on the card by chip_smoke.py).

Tolerances, each with its reason:
  * segment maxima of the same f32 scores, the read probe's heads and
    sums, the selection over the same scores: exact (max and integer sums
    do not depend on order; a head is a copy);
  * scores and segment maxima of the product: SCORE_ATOL, since both sides
    sum the same exact bf16 products in f32 in another order (XLA's CPU
    dot against torch's; |error| <= D eps sum|terms|, below 2e-4 at D 128
    with standard-normal inputs; 1.2e-5 was seen).
"""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rust_local_rag_tpu_torch.experiments import (
    common,
    dma_probe,
    isolate2,
    isolate_kernel,
    split2,
    split_pipeline,
    stream_kernel,
)
from rust_local_rag_tpu_torch.ops.segmax import segmax
from rust_local_rag_tpu_torch.ops.stream_probe import read_probe, resident_dot_segmax, stream_segmax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_ATOL = 2e-4
INTERPRET_PL = types.SimpleNamespace(
    **{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")},
)
INTERPRET_PL.pallas_call = functools.partial(pl.pallas_call, interpret=pltpu.InterpretParams())


def load_script(name: str, **shape):
    """scripts/exp_<name>.py with its shape globals set (and the ones
    derived from them recomputed) and its pallas_call in interpret mode."""
    saved = (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs)
    spec = importlib.util.spec_from_file_location(f"exp_{name}_under_test", os.path.join(ROOT, "scripts", f"exp_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    mod.pl = INTERPRET_PL
    for k, v in shape.items():
        setattr(mod, k, v)
    for k, f in (("NT", lambda m: m.N // m.SEG), ("PT", lambda m: m.BLK // m.SEG), ("NCH", lambda m: m.N // m.BLK),
                 ("NCHUNKS", lambda m: m.N // m.BLK), ("GB", lambda m: m.N * m.D * 2 / 1e9)):
        if hasattr(mod, k):
            setattr(mod, k, f(mod))
    return mod


def bf16(rng, shape):
    """(torch bf16, jnp bf16) holding the same standard-normal values."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def f32(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def test_loader_restores_the_compilation_cache_settings():
    before = (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs)
    mod = load_script("split2")
    assert mod.pl.pallas_call.keywords["interpret"] is not None
    assert (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs) == before


# ---------------------------------------------------------------- K1 ----


# the script's ring primes slots - 1 copies, so it needs N / blkc >= slots - 1
@pytest.mark.parametrize("seg,blkc,slots", [(128, 2048, 2), (64, 2048, 2), (128, 4096, 3), (64, 4096, 4),
                                            (128, 16384, 2)])
def test_make_segmax_qn_matches_jax(seg, blkc, slots):
    n, q = 16384, 8
    jm = load_script("split_pipeline", N=n, D=64, Q=q)
    st_t, st_j = f32(np.random.default_rng(seg + blkc), (q, n))
    want = np.asarray(jm.make_segmax_qn(seg, blkc, slots)(st_j))
    got = split_pipeline.make_segmax_qn(seg, blkc, slots)(st_t)
    assert got.shape == (q, n // seg)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("blkc,slots", [(2048, 2), (4096, 2), (2048, 3), (8192, 2)])
def test_split2_make_segmax_matches_jax(blkc, slots):
    n, q = 8192, 8
    jm = load_script("split2", N=n, D=64, Q=q)
    st_t, st_j = f32(np.random.default_rng(blkc), (q, n))
    np.testing.assert_array_equal(split2.make_segmax(blkc, slots)(st_t).numpy(),
                                  np.asarray(jm.make_segmax(blkc, slots)(st_j)))


# ------------------------------------------------- the fused row (2, 6) ----


def test_stream_fused_matches_jax():
    n, q, d = 8192, 8, 64
    jm = load_script("split2", N=n, D=d, Q=q, BLK=2048)
    rng = np.random.default_rng(11)
    qt, qj = bf16(rng, (q, d))
    ct, cj = bf16(rng, (n, d))
    st_j, sm_j = (np.asarray(x) for x in jm.stream_fused(qj, cj))
    st_t, sm_t = split2.stream_fused(qt, ct)
    assert sm_t.shape == sm_j.shape == (n // 128, q)
    np.testing.assert_allclose(st_t.numpy(), st_j, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(sm_t.numpy(), sm_j, rtol=0, atol=SCORE_ATOL)
    # the port's maxima are exactly those of its own scores
    torch.testing.assert_close(sm_t, st_t.view(q, n // 128, 128).amax(dim=2).T, rtol=0, atol=0)


# ---------------------------------------------------------------- K2 ----


@pytest.mark.parametrize("seg,transposed", [(128, False), (128, True), (64, True), (64, False)])
def test_make_stream_matches_jax(seg, transposed):
    n, q, d = 8192, 8, 64
    jm = load_script("stream_kernel", N=n, D=d, Q=q, BLK=2048)
    rng = np.random.default_rng(seg + transposed)
    qt, qj = bf16(rng, (q, d))
    ct, cj = bf16(rng, (n, d))
    s_j, m_j = (np.asarray(x) for x in jm.make_stream(seg, transposed)(qj, cj))
    s_t, m_t = stream_kernel.make_stream(seg, transposed)(qt, ct)
    assert s_t.shape == s_j.shape == ((n, q) if transposed else (q, n))
    assert m_t.shape == m_j.shape == (n // seg, q)
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(m_t.numpy(), m_j, rtol=0, atol=SCORE_ATOL)


ISOLATE_MODES = [("dma", 2), ("dma", 4), ("dot", 2), ("both", 2), ("both", 4)]


def _isolate_case(jm_make, port_make, mode, n, q, d, blk, seed):
    rng = np.random.default_rng(seed)
    qt, qj = bf16(rng, (q, d))
    ct, cj = bf16(rng, (n, d))
    want = np.asarray(jm_make(qj, cj))
    got = port_make(qt, ct)
    assert want.shape == (n // 128, q)
    if mode == "dma":
        # the TPU wrote only row i * blk / 128 of each chunk i: the first q
        # values of the chunk's first slab row; the port returns just those
        heads, sums = got
        np.testing.assert_array_equal(heads.numpy(), want[:: blk // 128])
        bits = ct.view(torch.int16).numpy().astype(np.int64).reshape(n // blk, -1)
        np.testing.assert_array_equal(sums.numpy(), bits.sum(axis=1))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCORE_ATOL)
    if mode == "dot":  # block 0's maxima, the same for every chunk
        per = blk // 128
        assert torch.equal(got, got[:per].repeat(n // blk, 1))


@pytest.mark.parametrize("mode,slots", ISOLATE_MODES)
def test_isolate_kernel_make_matches_jax(mode, slots):
    n, q, d, blk = 8192, 8, 64, 2048
    jm = load_script("isolate_kernel", N=n, D=d, Q=q, BLK=blk)
    _isolate_case(jm.make(mode, slots), isolate_kernel.make(mode, slots), mode, n, q, d, blk, 7 + slots)


@pytest.mark.parametrize("mode,blk,natural", [(m, b, nat) for _, m, b, nat in isolate2.SWEEP])
def test_isolate2_make_matches_jax(mode, blk, natural):
    """Every setting of the script's sweep."""
    n, q, d = 16384, 8, 64
    jm = load_script("isolate2", N=n, D=d, Q=q)
    _isolate_case(jm.make(mode, blk, natural), isolate2.make(mode, blk, natural), mode, n, q, d, blk,
                  blk + natural)


# ---------------------------------------------------------------- K3 ----


@pytest.mark.parametrize("blk,slots,static", list(dma_probe.SWEEP))
def test_dma_probe_make_matches_jax(blk, slots, static):
    """Every setting of the script's sweep: tag + the head of the chunk
    that last sat in ring slot 0."""
    n, d = 32768, 128
    jm = load_script("dma_probe", N=n, D=d)
    rng = np.random.default_rng(blk + slots)
    ct, cj = bf16(rng, (n, d))
    tag = np.arange(128, dtype=np.float32).reshape(1, 128) * 0.5
    want = np.asarray(jm.make(blk, slots, static)(jnp.asarray(tag), cj))
    got = dma_probe.make(blk, slots, static)(torch.from_numpy(tag), ct)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------- selection, pipeline ----


@pytest.mark.parametrize("s_keep", [128, 256, 100, 8])
def test_select_matches_jax_on_the_same_scores(s_keep):
    n, q = 65536, 8
    jm = load_script("split2", N=n, D=64, Q=q)
    st_t, st_j = f32(np.random.default_rng(s_keep), (q, n))
    sm_t = st_t.view(q, n // 128, 128).amax(dim=2)
    gv, gi = split2.select(st_t, sm_t, s_keep)
    wv, wi = (np.asarray(x) for x in jm.select(st_j, jnp.asarray(sm_t.numpy()), s_keep))
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)
    assert gi.dtype == torch.int32
    # and it is the exact top-k of the scores
    tv, ti = torch.topk(st_t, split2.K, dim=1)
    assert common.same_topk(gv, gi, tv, ti)[:2] == (True, True)


@pytest.mark.parametrize("seg,blkc,s_keep", list(split_pipeline.SWEEP) + [(64, 16384, 128)])
def test_pipeline_qn_matches_jax(seg, blkc, s_keep):
    """The whole split pipeline (GEMM, segment max, selection) against the
    script's. The two GEMMs round differently (SCORE_ATOL), so an index
    may differ only where the two scores are within that of each other."""
    n, q, d = 65536, 8, 64
    jm = load_script("split_pipeline", N=n, D=d, Q=q)
    rng = np.random.default_rng(seg + blkc + s_keep)
    qt, qj = bf16(rng, (q, d))
    ct, cj = bf16(rng, (n, d))
    wv, wi = (np.asarray(x) for x in jm.pipeline_qn(seg, blkc, s_keep)(qj, cj))
    gv, gi = split_pipeline.pipeline_qn(seg, blkc, s_keep)(qt, ct)
    np.testing.assert_allclose(gv.numpy(), wv, rtol=0, atol=SCORE_ATOL)
    st_j = np.asarray(jnp.einsum("qd,nd->qn", qj, cj, preferred_element_type=jnp.float32))
    differ = gi.numpy() != wi
    picked = np.take_along_axis(st_j, gi.numpy().astype(np.int64), axis=1)
    assert np.all(np.abs(picked - wv)[differ] <= SCORE_ATOL)
    # against torch.topk over the port's own scores: exact
    tv, ti = torch.topk(common.gemm_scores(qt, ct), split_pipeline.K, dim=1)
    assert common.same_topk(gv, gi, tv, ti)[:2] == (True, True)


def test_same_topk_orders_ties_and_counts_boundary_ties():
    v = torch.tensor([[3.0, 2.0, 2.0, 1.0]])
    assert common.same_topk(v, torch.tensor([[0, 5, 4, 9]]), v, torch.tensor([[0, 4, 5, 9]])) == (True, True, 0)
    assert common.same_topk(v, torch.tensor([[0, 5, 4, 9]]), v, torch.tensor([[0, 4, 5, 7]])) == (True, True, 1)
    assert common.same_topk(v, torch.tensor([[0, 5, 4, 9]]), v, torch.tensor([[1, 4, 5, 9]]))[:2] == (True, False)
    assert common.same_topk(v + 1, torch.tensor([[0, 5, 4, 9]]), v, torch.tensor([[0, 4, 5, 9]]))[:2] == (False, False)


# ------------------------------------------------------- the entry points ----


SMALL = {"N": 65536, "D": 128, "Q": 8}


@pytest.mark.parametrize("mod", [split_pipeline, split2, stream_kernel, isolate_kernel, isolate2, dma_probe],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_runs_every_sweep_on_the_cpu_at_a_small_shape(mod, monkeypatch, capsys):
    """Each module's main at N 65,536, D 128, Q 8 on the CPU: its checks
    pass, every sweep line of the script prints, and no time is reported
    (nan: a CPU time is not the card's)."""
    for k, v in SMALL.items():
        if hasattr(mod, k):
            monkeypatch.setattr(mod, k, v)
    for k, f in (("NT", lambda: SMALL["N"] // mod.SEG), ("NCH", lambda: SMALL["N"] // mod.BLK),
                 ("NCHUNKS", lambda: SMALL["N"] // mod.BLK), ("GB", lambda: SMALL["N"] * SMALL["D"] * 2 / 1e9)):
        if hasattr(mod, k):
            monkeypatch.setattr(mod, k, f())
    mod.main(device=torch.device("cpu"))
    lines = capsys.readouterr().out.splitlines()
    timed = [line for line in lines if " ms" in line]
    sweeps = {split_pipeline: 5, split2: 4, stream_kernel: 3, isolate_kernel: 5, isolate2: 7, dma_probe: 7}
    assert len(timed) == sweeps[mod] and all("nan" in line for line in timed), lines
    assert not any("False" in line for line in lines if "exact" in line), lines


def test_wrappers_refuse_what_the_kernels_do_not_take():
    s = torch.zeros(2, 1024)
    with pytest.raises(ValueError):
        segmax(s, seg=32)
    with pytest.raises(ValueError):
        segmax(s, blkc=768)  # not a multiple of 128 dividing C
    with pytest.raises(ValueError):
        segmax(s.double(), blkc=1024)
    q, c = torch.zeros(2, 64, dtype=torch.bfloat16), torch.zeros(256, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        stream_segmax(q, c, layout="kn")
    with pytest.raises(ValueError):
        stream_segmax(q.float(), c)
    with pytest.raises(ValueError):
        stream_segmax(q, c[:200])  # N % 128
    with pytest.raises(ValueError):
        resident_dot_segmax(q, c, 192)
    with pytest.raises(ValueError):
        read_probe(c, 100)
    with pytest.raises(ValueError):
        read_probe(c, 128, width=65)
