"""The port's chunk store and npz persistence against the JAX package's:
the same operations give the same slots, masks, rows and files."""

import os

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_local_rag_tpu.engine import persistence as jper
from rust_local_rag_tpu.engine.chunk_store import ChunkMeta as JMeta
from rust_local_rag_tpu.engine.chunk_store import ChunkStore as JStore
from rust_local_rag_tpu_torch.engine import persistence as tper
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta as TMeta
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkStore as TStore

DIM = 8


def _rows(rng, n):
    m = rng.standard_normal((n, DIM)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _metas(cls, names):
    return [cls(id=n, document_name=n.split(":")[0], text=f"text {n}", chunk_index=i) for i, n in enumerate(names)]


def _same_state(t: TStore, j: JStore):
    assert len(t) == len(j) and t.capacity == j.capacity and t.high_water == j.high_water
    assert t._free == j._free
    np.testing.assert_array_equal(t.valid_mask().numpy(), np.asarray(j.valid_mask()))
    live = np.asarray(j.valid_mask())
    np.testing.assert_array_equal(
        t.corpus().float().numpy()[live], np.asarray(j.corpus(), dtype=np.float32)[live]
    )
    assert {m.id: s for s, m in t.iter_meta()} == {m.id: s for s, m in j.iter_meta()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_free_list_growth_and_compact_match_jax(rng, dtype):
    t = TStore(DIM, getattr(torch, dtype), initial_capacity=4, device="cpu")
    j = JStore(dim=DIM, dtype=jnp.dtype(dtype), initial_capacity=4)
    steps = [
        ("add", [f"a:{i}" for i in range(3)]),
        ("add", [f"b:{i}" for i in range(4)]),  # grows 4 -> 8
        ("remove", ["a:1", "b:2", "missing"]),
        ("add", [f"c:{i}" for i in range(5)]),  # refills holes, grows to 16
        ("remove", ["a:0", "c:4"]),
    ]
    for op, names in steps:
        if op == "add":
            rows = _rows(rng, len(names))
            assert t.add_chunks(_metas(TMeta, names), rows) == j.add_chunks(_metas(JMeta, names), rows)
        else:
            assert t.remove_ids(names) == j.remove_ids(names)
        _same_state(t, j)
    assert t.capacity == 16
    t.compact()
    j.compact()
    _same_state(t, j)
    assert t.high_water == len(t) and not t._free
    et, mt = t.snapshot_host()
    ej, mj = j.snapshot_host()
    np.testing.assert_array_equal(et, ej)
    assert [m.id for m in mt] == [m.id for m in mj]
    assert t.document_names() == j.document_names() == ["a", "b", "c"]


def test_store_rejects_bad_input(rng):
    t = TStore(DIM, device="cpu")
    t.add_chunks(_metas(TMeta, ["a:0"]), _rows(rng, 1))
    with pytest.raises(ValueError, match="duplicate"):
        t.add_chunks(_metas(TMeta, ["a:0"]), _rows(rng, 1))
    with pytest.raises(ValueError, match="dim"):
        t.add_chunks(_metas(TMeta, ["a:1"]), np.zeros((1, DIM + 1), np.float32))
    with pytest.raises(ValueError, match="mismatch"):
        t.add_chunks(_metas(TMeta, ["a:2", "a:3"]), _rows(rng, 1))
    with pytest.raises(KeyError):
        t.meta_for_slot(5)
    with pytest.raises(ValueError, match="dtype"):
        TStore(DIM, torch.float16, device="cpu")
    assert t.add_chunks([], np.zeros((0, DIM), np.float32)) == []


def _state(cls_state, cls_meta, rng, n=5, model="m/odel:1"):
    return cls_state(
        model=model,
        embeddings=_rows(rng, n) * 3.0,  # renormalised on load
        metas=[
            cls_meta(id=f"id{i}", document_name="d.pdf", text=f"t{i} é", chunk_index=i,
                     page_number=i + 1, section=None if i % 2 else "S", metadata={"token_count": i})
            for i in range(n)
        ],
        document_hashes={"d.pdf": "abc"},
    )


def test_persistence_roundtrip_and_interchange(tmp_path, rng):
    st = _state(tper.IndexState, TMeta, rng)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    p = tper.save_index(tdir, st)
    assert os.path.basename(p) == os.path.basename(jper.get_index_path(tdir, st.model)) == "chunks_m_odel_1.npz"
    jper.save_index(jdir, _state(jper.IndexState, JMeta, np.random.default_rng(42)))
    for path_dir in (tdir, jdir):
        a = tper.load_index(path_dir, st.model)
        b = jper.load_index(path_dir, st.model)
        assert not a.needs_reindex and not b.needs_reindex
        np.testing.assert_array_equal(a.state.embeddings, b.state.embeddings)
        assert [vars(m) for m in a.state.metas] == [vars(m) for m in b.state.metas]
        assert a.state.document_hashes == b.state.document_hashes
    assert not [f for f in os.listdir(tdir) if f.endswith(".tmp")]


@pytest.mark.parametrize("name", ["", "  ", "a/b", "../x", "ok-name_1.2", "é", "..."])
def test_sanitize_model_name_matches_jax(name):
    assert tper.sanitize_model_name(name) == jper.sanitize_model_name(name)


def test_persistence_corrupt_missing_and_unfingerprinted(tmp_path, rng):
    d = str(tmp_path)
    assert tper.load_index(d, "m").state is None and not tper.load_index(d, "m").needs_reindex
    with open(tper.get_index_path(d, "m"), "wb") as f:
        f.write(b"not an npz")
    res = tper.load_index(d, "m")
    assert res.state is None and res.needs_reindex
    assert os.path.exists(tper.get_index_path(d, "m"))  # kept on disk
    st = _state(tper.IndexState, TMeta, rng, model="m")
    st.document_hashes = {}
    tper.save_index(d, st)
    assert tper.load_index(d, "m").state.needs_reindex  # no fingerprints
