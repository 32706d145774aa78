"""The port's parallel/ (mesh, sharded exact search, multi-slice merge)
against the JAX package's on the CPU: the same seeded numpy inputs through
the JAX function on its 8-device virtual CPU mesh (tests/conftest.py) and
through the port's on its 8-position CPU mesh, and against the port's
unsharded function.

Tolerance: values within SCORE_ATOL = 1e-5 (XLA's einsum and torch's
matmul sum the D products in different orders; tests/test_torch_ops.py),
index sets equal outside exact ties, whose order JAX itself leaves open
(sharded_search.py:139-141): a row on one side only must tie with the
last kept value within the tolerance. Counterparts of the 8 sharded tests
of tests/test_parallel.py keep their sizes (the 8 x 65,536-row one at
D 16). Pallas-free: the JAX sharded code is plain XLA; the port's masked
kernel takes its plain version on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_local_rag_tpu.ops.hybrid import hybrid_topk as jhybrid_topk
from rust_local_rag_tpu.ops.topk import streaming_topk
from rust_local_rag_tpu.parallel import multislice as jmultislice
from rust_local_rag_tpu.parallel import sharded_search as jss
from rust_local_rag_tpu.parallel.mesh import build_mesh as jbuild_mesh
from rust_local_rag_tpu_torch.ops import hybrid as thybrid
from rust_local_rag_tpu_torch.ops.quantized import quantize_rows
from rust_local_rag_tpu_torch.parallel import mesh as tmesh
from rust_local_rag_tpu_torch.parallel import sharded_search as tss
from rust_local_rag_tpu_torch.parallel.multislice import multislice_topk

SCORE_ATOL = 1e-5


def _unit(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tmesh(sizes=None, names=("corpus",)):
    return tmesh.build_mesh(sizes, names, device="cpu")


def _same(got_v, got_i, want_v, want_i, what, extra=()):
    """Per row: the values within SCORE_ATOL position by position (both
    sorted descending), the same index sets up to rows tied with the last
    kept value, and each plane in `extra` ((got, want) pairs) equal per
    shared index."""
    got_v, got_i, want_v, want_i = (np.asarray(x) for x in (got_v, got_i, want_v, want_i))
    assert got_v.shape == want_v.shape and got_i.shape == want_i.shape, what
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=SCORE_ATOL, err_msg=what)
    for r in range(got_v.shape[0]):
        g = {int(i): j for j, i in enumerate(got_i[r]) if np.isfinite(got_v[r, j])}
        w = {int(i): j for j, i in enumerate(want_i[r]) if np.isfinite(want_v[r, j])}
        fin = np.isfinite(want_v[r])
        floor = want_v[r][fin].min() if fin.any() else -np.inf
        for key in set(g) ^ set(w):
            v = got_v[r, g[key]] if key in g else want_v[r, w[key]]
            assert v - floor <= SCORE_ATOL, f"{what} row {r}: index {key} on one side only"
        for key in set(g) & set(w):
            for a, b in extra:
                np.testing.assert_allclose(np.asarray(a)[r, g[key]], np.asarray(b)[r, w[key]], rtol=0,
                                           atol=SCORE_ATOL, err_msg=f"{what} row {r} index {key}")


# ----------------------------------------------------------------- mesh ----


def test_mesh_construction():
    mesh = _tmesh()
    assert mesh.shape["corpus"] == 8 == jbuild_mesh().shape["corpus"]
    mesh2 = _tmesh((2, 4), ("data", "corpus"))
    assert mesh2.shape == {"data": 2, "corpus": 4}
    assert dict(zip(mesh2.axis_names, mesh2.devices.shape)) == {"data": 2, "corpus": 4}
    assert all(d == torch.device("cpu") for d in mesh2.devices.flat)
    # an explicit device list may repeat a device (shards standing on one card)
    one = tmesh.build_mesh((2, 2), ("slice", "corpus"), devices=["cpu"] * 4)
    assert one.size == 4 and one.lead == torch.device("cpu")


@pytest.mark.parametrize("sizes, names", [((3,), ("corpus",)), ((16,), ("corpus",)), ((8,), ("data", "corpus")),
                                          ((2, 4), ("corpus",))])
def test_build_mesh_raises_as_jax(sizes, names):
    with pytest.raises(ValueError) as want:
        jbuild_mesh(sizes, names)
    with pytest.raises(ValueError) as got:
        _tmesh(sizes, names)
    assert str(got.value) == str(want.value)


def test_available_devices():
    assert tmesh.available_devices("cpu") == [torch.device("cpu")] * tmesh.CPU_DEVICES == [torch.device("cpu")] * 8


def test_mesh_without_card_raises(monkeypatch):
    """The default mesh is the cards': no silent CPU mesh without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tmesh.available_devices, tmesh.build_mesh):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()


# --------------------------------------------------------- sharded tensor ----


def test_sharded_tensor_layout_and_updates(rng):
    """Blocks are the row ranges of their shards in outer-major order,
    replicas on one device share a tensor, and writes, growth (rows move
    between shards) and repacking keep the row order."""
    mesh = _tmesh((2, 2, 2), ("data", "slice", "corpus"))
    x = _t(rng.standard_normal((64, 3)).astype(np.float32))
    st = tss.shard_corpus(x, mesh, ("slice", "corpus"))
    assert st.spec == (("slice", "corpus"), None) and st.rows == 16 and st.n_shards == 4
    for pos in np.ndindex(2, 2, 2):
        s = pos[1] * 2 + pos[2]
        assert torch.equal(st.block(pos), x[16 * s:16 * (s + 1)])
        assert st.block(pos) is st.block((0, *pos[1:]))  # the data replica shares it
    assert len(st.blocks()) == 4
    np.testing.assert_array_equal(st.full().numpy(), x.numpy())
    slots = np.array([[63, 0, 17], [33, 48, 15]])
    np.testing.assert_array_equal(st.take(slots).numpy(), x.numpy()[slots])
    new = rng.standard_normal((3, 3)).astype(np.float32)
    st.set_rows(np.array([5, 40, 63]), _t(new))
    ref = x.numpy().copy()
    ref[[5, 40, 63]] = new
    np.testing.assert_array_equal(st.full().numpy(), ref)
    grown = st.resized(128)
    assert grown.rows == 32
    np.testing.assert_array_equal(grown.full().numpy()[:64], ref)
    assert not grown.full().numpy()[64:].any()
    live = np.array([3, 9, 40, 41, 63])
    packed = grown.repacked(live)
    np.testing.assert_array_equal(packed.full().numpy()[:5], ref[live])
    assert not packed.full().numpy()[5:].any()
    rep = tss.replicate(x, mesh)
    assert rep.spec == (None, None) and len(rep.blocks()) == 1 and torch.equal(rep.full(), x)


# ------------------------------------- tests/test_parallel.py counterparts ----


def test_sharded_topk_exact_vs_single_device(rng):
    d, n, q, k = 32, 1024, 4, 16
    corpus = _unit(rng, n, d)
    queries = _unit(rng, q, d)
    jmesh, mesh = jbuild_mesh(), _tmesh()
    jv, ji = jss.sharded_topk(jss.replicate(jnp.asarray(queries), jmesh),
                              jss.shard_corpus(jnp.asarray(corpus), jmesh), k, jmesh, tile_n=64)
    tv, ti = tss.sharded_topk(tss.replicate(_t(queries), mesh), tss.shard_corpus(_t(corpus), mesh), k, mesh)
    assert ti.dtype == torch.int32
    _same(tv, ti, jv, ji, "sharded_topk vs JAX")
    rv, ri = streaming_topk(jnp.asarray(queries), jnp.asarray(corpus), k, tile_n=256)
    _same(tv, ti, rv, ri, "sharded_topk vs single device")
    uv, ui = torch.topk(_t(queries) @ _t(corpus).T, k, dim=1)
    _same(tv, ti, uv, ui, "sharded_topk vs the port unsharded")


def test_sharded_topk_with_padding_mask(rng):
    d, n_valid, k = 16, 700, 8
    n_padded = 704  # multiple of 8 shards
    corpus = np.zeros((n_padded, d), dtype=np.float32)
    corpus[:n_valid] = _unit(rng, n_valid, d)
    corpus[n_valid:] = corpus[0]  # padded tail maximally attractive
    queries = corpus[:2].copy()
    jmesh, mesh = jbuild_mesh(), _tmesh()
    tv, ti = tss.sharded_topk(_t(queries), _t(corpus), k, mesh, valid_count=n_valid)
    assert int(ti.max()) < n_valid
    jv, ji = jss.sharded_topk(jnp.asarray(queries), jnp.asarray(corpus), k, jmesh, tile_n=64,
                              valid_count=jnp.int32(n_valid))
    _same(tv, ti, jv, ji, "padded sharded_topk vs JAX")


def test_sharded_topk_k_too_large_rejected(rng):
    corpus = _t(_unit(rng, 64, 8))  # 8 rows a shard
    queries = _t(_unit(rng, 1, 8))
    with pytest.raises(ValueError, match="exceeds rows per shard") as got:
        tss.sharded_topk(queries, corpus, 9, _tmesh())
    with pytest.raises(ValueError) as want:
        jss.sharded_topk(jnp.asarray(queries.numpy()), jnp.asarray(corpus.numpy()), 9, jbuild_mesh())
    assert str(got.value) in str(want.value)


def test_sharded_topk_uneven_rejected(rng):
    corpus = _t(_unit(rng, 100, 8))  # not divisible by 8
    queries = _t(_unit(rng, 1, 8))
    with pytest.raises(ValueError, match="divide evenly") as got:
        tss.sharded_topk(queries, corpus, 4, _tmesh())
    with pytest.raises(ValueError) as want:
        jss.sharded_topk(jnp.asarray(queries.numpy()), jnp.asarray(corpus.numpy()), 4, jbuild_mesh())
    assert str(got.value) == str(want.value)


def test_sharded_topk_large_shard_segmented_path(rng):
    """65,536 rows a shard: the masked kernel's branch (its plain version
    here) and the segmented selection on every shard."""
    d, k = 16, 8
    n = 8 * 65536
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = corpus[:2].copy()
    mesh = _tmesh()
    assert thybrid.uses_score_segmax(n // 8)
    tv, ti = tss.sharded_topk(_t(queries), tss.shard_corpus(_t(corpus), mesh), k, mesh)
    assert (ti.numpy()[:, 0] == np.arange(2)).all()
    np.testing.assert_allclose(tv.numpy()[:, 0], 1.0, atol=1e-5)
    jv, ji = jss.sharded_topk(jnp.asarray(queries), jnp.asarray(corpus), k, jbuild_mesh())
    _same(tv, ti, jv, ji, "segmented sharded_topk vs JAX")
    ref = queries @ corpus.T
    for qi in range(2):
        assert set(ti.numpy()[qi].tolist()) == set(np.argsort(-ref[qi])[:k].tolist())


def test_multislice_topk_exact_vs_single_device(rng):
    d, n, q, k = 32, 1024, 4, 16
    corpus = _unit(rng, n, d)
    queries = _unit(rng, q, d)
    mesh = _tmesh((2, 4), ("slice", "ici"))
    tv, ti = multislice_topk(_t(queries), _t(corpus), k, mesh)
    jv, ji = jmultislice.multislice_topk(jnp.asarray(queries), jnp.asarray(corpus), k,
                                         jbuild_mesh((2, 4), ("slice", "ici")), tile_n=64)
    _same(tv, ti, jv, ji, "multislice vs JAX")
    rv, ri = jax.lax.top_k(jnp.einsum("qd,nd->qn", jnp.asarray(queries), jnp.asarray(corpus),
                                      precision=jax.lax.Precision.HIGHEST), k)
    _same(tv, ti, rv, ri, "multislice vs single device")


def test_multislice_topk_padding_and_bounds(rng):
    mesh, jmesh = _tmesh((2, 4), ("slice", "ici")), jbuild_mesh((2, 4), ("slice", "ici"))
    d, n_valid, n_padded, k = 16, 700, 704, 8
    corpus = np.zeros((n_padded, d), np.float32)
    corpus[:n_valid] = _unit(rng, n_valid, d)
    queries = _unit(rng, 3, d)
    tv, ti = multislice_topk(_t(queries), _t(corpus), k, mesh, valid_count=n_valid)
    assert int(ti.max()) < n_valid
    jv, ji = jmultislice.multislice_topk(jnp.asarray(queries), jnp.asarray(corpus), k, jmesh, tile_n=64,
                                         valid_count=n_valid)
    _same(tv, ti, jv, ji, "padded multislice vs JAX")
    # fewer live rows than k: the -inf fillers carry index -1
    few = 3
    tv2, ti2 = multislice_topk(_t(queries), _t(corpus), k, mesh, valid_count=few)
    tv2, ti2 = tv2.numpy(), ti2.numpy()
    assert (ti2[:, few:] == -1).all() and np.isneginf(tv2[:, few:]).all()
    assert (ti2[:, :few] >= 0).all() and (ti2[:, :few] < few).all()
    jv2, ji2 = jmultislice.multislice_topk(jnp.asarray(queries), jnp.asarray(corpus), k, jmesh, tile_n=64,
                                           valid_count=few)
    np.testing.assert_array_equal(ti2[:, few:], np.asarray(ji2)[:, few:])
    _same(tv2, ti2, jv2, ji2, "multislice few rows vs JAX")
    with pytest.raises(ValueError, match="exceeds rows per shard"):
        multislice_topk(_t(queries), _t(corpus), 128, mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        multislice_topk(_t(queries), _t(corpus[:701]), k, mesh)


# ------------------------------------------------- the hybrid first stages ----

# (mesh sizes, names, corpus_axis, data_axis)
MESHES = {
    "flat8": ((8,), ("corpus",), "corpus", None),
    "flat4": ((4,), ("corpus",), "corpus", None),
    "slices": ((2, 4), ("slice", "corpus"), ("slice", "corpus"), None),
    "data": ((2, 4), ("data", "corpus"), "corpus", "data"),
    "data_slices": ((2, 2, 2), ("data", "slice", "corpus"), ("slice", "corpus"), "data"),
}


def _meshes(name):
    sizes, names, caxis, daxis = MESHES[name]
    n = int(np.prod(sizes))
    return (jbuild_mesh(sizes, names, devices=jax.devices()[:n]),
            tmesh.build_mesh(sizes, names, devices=[torch.device("cpu")] * n), caxis, daxis)


def _hybrid_case(rng, n, d, q, freed=0.1, lex_width=512, hits=40):
    """Unit rows with ~`freed` of the slots freed (the top candidates
    among them), q queries near stored rows, and `hits` lexical hits a
    query (some on freed slots, some duplicated with the dense top)."""
    corpus = _unit(rng, n, d)
    mask = rng.random(n) >= freed
    queries = corpus[rng.integers(0, n, q)] + 0.3 * _unit(rng, q, d)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    mask[np.argsort(-(queries[0] @ corpus.T))[:3]] = False
    slots = np.full((q, lex_width), -1, np.int32)
    vals = np.zeros((q, lex_width), np.float32)
    for r in range(q):
        live = np.flatnonzero(mask)
        top = np.argsort(-(queries[r] @ corpus.T))[:5]
        pick = np.concatenate([top, rng.choice(live, hits - len(top), replace=False)])
        slots[r, :hits] = pick
        vals[r, :hits] = rng.random(hits).astype(np.float32) * 10
    return queries.astype(np.float32), corpus, mask, slots, vals


@pytest.mark.parametrize("with_sims", [False, True], ids=["plain", "sims"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_hybrid_topk_matches_jax_and_unsharded(rng, mesh_name, dtype, with_sims):
    jmesh, mesh, caxis, daxis = _meshes(mesh_name)
    n, d, q, k = 4096, 64, 8, 32
    queries, corpus, mask, slots, vals = _hybrid_case(rng, n, d, q)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    w = (0.7, 0.3)
    jout = jss.sharded_hybrid_topk(jnp.asarray(queries), jnp.asarray(corpus, dtype=jdt), jnp.asarray(mask),
                                   jnp.asarray(slots), jnp.asarray(vals), jnp.float32(w[0]), jnp.float32(w[1]),
                                   k, mesh=jmesh, corpus_axis=caxis, with_sims=with_sims, data_axis=daxis)
    corpus_t = _t(corpus).to(tdt)
    placed = tss.shard_corpus(corpus_t, mesh, caxis)
    tout = tss.sharded_hybrid_topk(_t(queries), placed, tss.shard_corpus(_t(mask), mesh, caxis), _t(slots),
                                   _t(vals), torch.tensor(w[0]), torch.tensor(w[1]), k, mesh, corpus_axis=caxis,
                                   with_sims=with_sims, data_axis=daxis)
    assert len(tout) == len(jout) == (5 if with_sims else 4)
    assert tout[3].dtype == torch.int32 and tuple(tout[0].shape) == (q, k)
    _same(tout[0], tout[3], jout[0], jout[3], f"{mesh_name} vs JAX",
          extra=[(tout[1], jout[1]), (tout[2], jout[2])])
    uout = thybrid.hybrid_topk(_t(queries), corpus_t, _t(mask), _t(slots), _t(vals), torch.tensor(w[0]),
                               torch.tensor(w[1]), k, with_sims=with_sims)
    _same(tout[0], tout[3], uout[0], uout[3], f"{mesh_name} vs unsharded",
          extra=[(tout[1], uout[1]), (tout[2], uout[2])])
    assert (tout[3].numpy()[np.isneginf(tout[0].numpy())] == -1).all()
    if with_sims:
        # rows where both picked the same candidates in the same order
        same = (tout[3].numpy() == np.asarray(jout[3])).all(axis=1)
        assert same.any()
        np.testing.assert_allclose(tout[4].numpy()[same], np.asarray(jout[4])[same], rtol=0, atol=SCORE_ATOL)
    # a plain (unplaced) slab gives the same answer as the placed one
    again = tss.sharded_hybrid_topk(_t(queries), corpus_t, _t(mask), _t(slots), _t(vals), torch.tensor(w[0]),
                                    torch.tensor(w[1]), k, mesh, corpus_axis=caxis, data_axis=daxis)
    for a, b in zip(again, tout[:4]):
        assert torch.equal(a, b)


def test_sharded_hybrid_topk_kernel_branch(rng):
    """65,536 rows a shard at 4 shards: each shard's dense stage takes the
    masked kernel's branch (plain version here) and segmented_select_from;
    against JAX (segmented_exact_topk_scores over an einsum)."""
    jmesh, mesh, caxis, daxis = _meshes("flat4")
    n, d, q, k = 4 * 65536, 16, 4, 32
    queries, corpus, mask, slots, vals = _hybrid_case(rng, n, d, q, freed=0.05)
    assert thybrid.uses_score_segmax(n // 4)
    jout = jss.sharded_hybrid_topk(jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask),
                                   jnp.asarray(slots), jnp.asarray(vals), jnp.float32(0.7), jnp.float32(0.3), k,
                                   mesh=jmesh)
    tout = tss.sharded_hybrid_topk(_t(queries), _t(corpus), _t(mask), _t(slots), _t(vals), torch.tensor(0.7),
                                   torch.tensor(0.3), k, mesh)
    _same(tout[0], tout[3], jout[0], jout[3], "kernel branch vs JAX", extra=[(tout[1], jout[1]), (tout[2], jout[2])])


def test_sharded_hybrid_topk_fewer_rows_than_k(rng):
    """k above the live rows of every shard: -inf / -1 fillers, as JAX pads
    them; and k above the rows a shard (k_local = rows)."""
    jmesh, mesh, caxis, daxis = _meshes("flat8")
    n, d, q, k = 64, 16, 3, 32
    queries, corpus, mask, slots, vals = _hybrid_case(rng, n, d, q, freed=0.8, hits=6)
    args_j = (jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask), jnp.asarray(slots), jnp.asarray(vals),
              jnp.float32(1.0), jnp.float32(0.5), k)
    jout = jss.sharded_hybrid_topk(*args_j, mesh=jmesh)
    tout = tss.sharded_hybrid_topk(_t(queries), _t(corpus), _t(mask), _t(slots), _t(vals), torch.tensor(1.0),
                                   torch.tensor(0.5), k, mesh)
    np.testing.assert_array_equal(np.isneginf(tout[0].numpy()), np.isneginf(np.asarray(jout[0])))
    np.testing.assert_array_equal(tout[3].numpy()[np.isneginf(tout[0].numpy())], -1)
    _same(tout[0], tout[3], jout[0], jout[3], "few rows vs JAX", extra=[(tout[1], jout[1]), (tout[2], jout[2])])


def _int8_case(rng, n, d, q):
    queries, corpus, mask, slots, vals = _hybrid_case(rng, n, d, q)
    values, scales = quantize_rows(_t(corpus))
    l1 = (scales[:, 0] * values.abs().float().sum(dim=1)).numpy()
    return queries, values.numpy(), scales.numpy(), l1, mask, slots, vals


@pytest.mark.parametrize("with_sims", [False, True], ids=["plain", "sims"])
@pytest.mark.parametrize("mesh_name", ["flat8", "slices", "data"])
def test_sharded_hybrid_topk_quantized_matches_jax(rng, mesh_name, with_sims):
    jmesh, mesh, caxis, daxis = _meshes(mesh_name)
    n, d, q, k = 4096, 64, 8, 32
    queries, values, scales, l1, mask, slots, vals = _int8_case(rng, n, d, q)
    jout = jss.sharded_hybrid_topk_quantized(
        jnp.asarray(queries), jnp.asarray(values), jnp.asarray(scales), jnp.asarray(l1), jnp.asarray(mask),
        jnp.asarray(slots), jnp.asarray(vals), jnp.float32(0.7), jnp.float32(0.3), k, mesh=jmesh,
        corpus_axis=caxis, with_sims=with_sims, data_axis=daxis)
    place = lambda x: tss.shard_corpus(_t(x), mesh, caxis)  # noqa: E731
    tout = tss.sharded_hybrid_topk_quantized(
        _t(queries), place(values), place(scales), place(l1), place(mask), _t(slots), _t(vals),
        torch.tensor(0.7), torch.tensor(0.3), k, mesh, corpus_axis=caxis, with_sims=with_sims, data_axis=daxis)
    assert len(tout) == len(jout) == (6 if with_sims else 5)
    # the certificates agree (they could differ only where a k-th score
    # ties tau within rounding: ROADMAP's pinned "int8 upper bound")
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
    _same(tout[0], tout[3], jout[0], jout[3], f"int8 {mesh_name} vs JAX",
          extra=[(tout[1], jout[1]), (tout[2], jout[2])])
    if with_sims:
        same = (tout[3].numpy() == np.asarray(jout[3])).all(axis=1)
        np.testing.assert_allclose(tout[5].numpy()[same], np.asarray(jout[5])[same], rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("mesh_name", ["flat8", "slices", "data"])
def test_sharded_dequant_full_matches_jax_and_unsharded(rng, mesh_name):
    jmesh, mesh, caxis, daxis = _meshes(mesh_name)
    n, d, q, k = 4096, 64, 8, 32
    queries, values, scales, _, mask, slots, vals = _int8_case(rng, n, d, q)
    jout = jss.sharded_hybrid_topk_dequant_full(
        jnp.asarray(queries), jnp.asarray(values), jnp.asarray(scales), jnp.asarray(mask), jnp.asarray(slots),
        jnp.asarray(vals), jnp.float32(0.7), jnp.float32(0.3), k, mesh=jmesh, corpus_axis=caxis, data_axis=daxis)
    place = lambda x: tss.shard_corpus(_t(x), mesh, caxis)  # noqa: E731
    tout = tss.sharded_hybrid_topk_dequant_full(
        _t(queries), place(values), place(scales), place(mask), _t(slots), _t(vals), torch.tensor(0.7),
        torch.tensor(0.3), k, mesh, corpus_axis=caxis, data_axis=daxis)
    assert len(tout) == 4
    _same(tout[0], tout[3], jout[0], jout[3], f"dequant_full {mesh_name} vs JAX",
          extra=[(tout[1], jout[1]), (tout[2], jout[2])])
    uout = thybrid.hybrid_topk_dequant_full(_t(queries), _t(values), _t(scales), _t(mask), _t(slots), _t(vals),
                                            torch.tensor(0.7), torch.tensor(0.3), k)
    _same(tout[0], tout[3], uout[0], uout[3], f"dequant_full {mesh_name} vs unsharded",
          extra=[(tout[1], uout[1]), (tout[2], uout[2])])


def test_sharded_matches_jax_unsharded_hybrid(rng):
    """The sharded port against the JAX package's unsharded hybrid_topk:
    the merge is exact."""
    _, mesh, caxis, daxis = _meshes("slices")
    n, d, q, k = 4096, 64, 8, 64
    queries, corpus, mask, slots, vals = _hybrid_case(rng, n, d, q)
    jout = jhybrid_topk(jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(mask), jnp.asarray(slots),
                        jnp.asarray(vals), jnp.float32(0.7), jnp.float32(0.3), k)
    tout = tss.sharded_hybrid_topk(_t(queries), _t(corpus), _t(mask), _t(slots), _t(vals), torch.tensor(0.7),
                                   torch.tensor(0.3), k, mesh, corpus_axis=caxis)
    _same(tout[0], tout[3], jout[0], jout[3], "sliced vs JAX unsharded",
          extra=[(tout[1], jout[1]), (tout[2], jout[2])])


def test_sharded_topk_jit_is_an_alias():
    assert tss.sharded_topk_jit is tss.sharded_topk
