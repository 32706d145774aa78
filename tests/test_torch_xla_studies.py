"""The port's XLA-formulation studies (experiments/rw_segmax.py,
xla_blocked.py, xla_segmax.py, partialreduce.py) against the guarded JAX
functions of their scripts (scripts/exp_rw_segmax.py, exp_xla_blocked.py,
exp_xla_segmax.py, exp_partialreduce.py), loaded by path with their shape
globals set small, on the same seeded inputs. The scripts set
jax_compilation_cache_dir when imported; the loader puts the two cache
settings back at once. scripts/ is not edited.

Tolerances, each with its reason:
  * scores and segment maxima: SCORE_ATOL, as in
    tests/test_torch_experiments.py (the same exact bf16 products summed
    in f32 in another order);
  * the selection's indices and the bin counts: exact (selection over
    scores that agree to that tolerance, with no near-tie at these seeds;
    the count is integer arithmetic);
  * the interleaved maxima against numpy: exact (a max is a copy).
"""

import importlib.util
import io
import math
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_local_rag_tpu_torch.experiments import common, partialreduce, rw_segmax, xla_blocked, xla_segmax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_ATOL = 2e-4
CPU = torch.device("cpu")


def load_script(name: str, **shape):
    """scripts/exp_<name>.py with its shape globals set and NT / NS
    recomputed."""
    saved = (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs)
    spec = importlib.util.spec_from_file_location(f"exp_{name}_under_test",
                                                  os.path.join(ROOT, "scripts", f"exp_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    for k, v in shape.items():
        setattr(mod, k, v)
    for k in ("NT", "NS"):
        if hasattr(mod, k):
            setattr(mod, k, mod.N // mod.SEG)
    return mod


def bf16(rng, shape):
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)


def close(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCORE_ATOL, rtol=0)


def test_loader_restores_the_compilation_cache_settings():
    before = (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs)
    load_script("rw_segmax")
    assert (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs) == before


# ---------------------------------------------------------- rw_segmax ----


def test_pipe_rw_matches_jax():
    n, q = 32768, 8
    jm = load_script("rw_segmax", N=n, Q=q, D=64, K=10)
    rng = np.random.default_rng(11)
    c_t, c_j = bf16(rng, (n, 64))
    q_t, q_j = bf16(rng, (q, 64))
    st_j, sm_j = jm.pipe_rw(q_j, c_j)
    st, sm = rw_segmax.pipe_rw(q_t, c_t)
    close(st, st_j)
    close(sm, sm_j)
    assert torch.equal(sm, st.view(q, -1, 128).amax(dim=2))
    gv, gi = rw_segmax.pipe_rw_select(q_t, c_t, k=10)
    wv, wi = jm.pipe_rw_select(q_j, c_j)
    close(gv, wv)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


# -------------------------------------------------------- xla_blocked ----


@pytest.mark.parametrize("bn,with_scores", [(8192, True), (8192, False), (16384, True), (32768, False)])
def test_blocked_matches_jax(bn, with_scores, monkeypatch):
    n, q = 32768, 8
    jm = load_script("xla_blocked", N=n, Q=q, D=64)
    monkeypatch.setattr(xla_blocked, "N", n)
    rng = np.random.default_rng(bn)
    c_t, c_j = bf16(rng, (n, 64))
    q_t, q_j = bf16(rng, (q, 64))
    s_j, m_j = jm.make(bn, with_scores)(q_j, c_j)
    s, m = xla_blocked.make(bn, with_scores)(q_t, c_t)
    close(m, m_j)
    if with_scores:
        close(s, s_j)
    else:
        assert s is None and s_j is None


# --------------------------------------------------------- xla_segmax ----


@pytest.mark.parametrize("name", ["v_scores_only", "v_a", "v_b", "v_b_segonly", "v_nq"])
def test_segmax_layouts_match_jax(name):
    n, q = 16384, 8
    jm = load_script("xla_segmax", N=n, Q=q, D=64)
    rng = np.random.default_rng(len(name))
    c_t, c_j = bf16(rng, (n, 64))
    q_t, q_j = bf16(rng, (q, 64))
    want = getattr(jm, name)(q_j, c_j)
    got = getattr(xla_segmax, name)(q_t, c_t)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            close(g, w)
    assert [label for label, _ in xla_segmax.VARIANTS] == ["scores only [Q,N]", "a: [Q,N]+reshape max",
                                                           "b: [NS,SEG,Q]+max(1)", "b seg-only", "nq: [N,Q]+max(1)"]


@pytest.mark.parametrize("mod,n", [(rw_segmax, 16384), (xla_blocked, 16384), (xla_segmax, 16384)])
def test_study_main_runs_its_checks(mod, n, monkeypatch):
    for k, v in (("N", n), ("D", 64), ("Q", 8), ("K", 10), ("BLOCKS", (8192,)), ("CHECK_BN", 4096)):
        if hasattr(mod, k):
            monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(common, "STEPS", 1)
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = mod.main(device=CPU)
    text = buf.getvalue()
    assert ("exact: True True" in text) or ("correct" in text)
    assert "row 2 kernel (fused_score_segmax)" in text and out


# ------------------------------------------------------ partialreduce ----


# a grid of widths (the bench shard, powers of two, ragged and tiny), k,
# recall and override
GRID = [(n, k, r, ov) for n in (100, 129, 300, 384, 1000, 4096, 65537, 100_000, 1_245_184)
        for k in (1, 10, 100, 256) for r in (0.9, 0.95, 0.99, 0.995)
        for ov in (None, 2 * n, 5_000_000) if k <= n]


@pytest.mark.parametrize("n", sorted({g[0] for g in GRID}))
def test_bin_count_rule_matches_approx_max_k(n):
    for _, k, r, ov in (g for g in GRID if g[0] == n):
        kw = {} if ov is None else {"reduction_input_size_override": ov}
        shape = jax.eval_shape(lambda x: jax.lax.approx_max_k(x, k, recall_target=r, aggregate_to_topk=False, **kw),
                               jax.ShapeDtypeStruct((2, n), jnp.float32))
        assert partialreduce.bins(n, k, r, ov) == shape[0].shape[1], (n, k, r, ov)


def test_bin_counts_of_the_bench_shard():
    """The bin counts at N 1,245,184 that the CPU's approx_max_k gives."""
    want = {(0.95, 10): 384, (0.95, 100): 2432, (0.95, 256): 9728, (0.99, 10): 1280, (0.99, 100): 19456,
            (0.99, 256): 38912}
    assert {key: partialreduce.bins(1_245_184, key[1], key[0]) for key in want} == want
    assert partialreduce.bins(1_245_184, 100, 0.95, 5_000_000) == 640
    assert partialreduce.bins(1_245_184, 100, 0.95, 20_000_000) == 256
    assert partialreduce.bins(100_000, 100, 0.95) == 3200


def test_probe_l_prints_the_scripts_counts(monkeypatch):
    """The script's probe_l run on the CPU (approx_max_k's shapes) and the
    port's, both at N 100,000: the same lines."""
    jm = load_script("partialreduce", N=100_000)
    monkeypatch.setattr(partialreduce, "N", 100_000)
    buf = io.StringIO()
    with redirect_stdout(buf):
        jm.probe_l()
    lines = []
    partialreduce.probe_l(log=lines.append)
    assert buf.getvalue().splitlines() == lines


@pytest.mark.parametrize("n,k,r", [(1_245_184 // 16, 100, 0.99), (77_821, 100, 0.95), (1000, 10, 0.9), (300, 256, 0.99),
                                   (5000, 1, 0.95), (100, 10, 0.95)])
def test_interleaved_max_matches_numpy(n, k, r):
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    v, i = partialreduce.interleaved_max(torch.from_numpy(x), k, r)
    l, groups = partialreduce.reduction_shape(n, k, r)
    assert v.shape == (3, l) and l == partialreduce.bins(n, k, r) and l * groups >= n
    live = min(l, n)
    want = np.stack([x[:, b::l].max(axis=1) for b in range(live)], axis=1)
    np.testing.assert_array_equal(v.numpy()[:, :live], want)
    np.testing.assert_array_equal(np.take_along_axis(x, i.numpy()[:, :live], 1), want)
    assert np.array_equal(i.numpy() % l, np.tile(np.arange(l), (3, 1)))
    assert np.isneginf(v.numpy()[:, live:]).all()


def test_probe_layout_and_main(monkeypatch):
    monkeypatch.setattr(partialreduce, "N", 65536)
    monkeypatch.setattr(partialreduce, "D", 64)
    monkeypatch.setattr(partialreduce, "Q", 8)
    monkeypatch.setattr(common, "STEPS", 1)
    r = partialreduce.probe_layout(CPU, log=lambda m: None)
    assert r["interleaved"] and r["exact"] and not r["contiguous"]
    assert r["l"] == partialreduce.bins(65536, 100, 0.99) == 2 ** 14 and math.isnan(
        partialreduce.main(device=CPU)["ms"][0.95])
