"""The port's chunk store and npz persistence against the JAX package's:
the same operations give the same slots, masks, rows and files."""

import json
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


# ----- the reference's JSON index and the legacy chunks.json (migration) -----


def _load_both(tmp_path, files: dict, model: str):
    """The same data directory (files: name -> bytes) loaded by the port and
    by the JAX package, each in its own copy (a migration writes the npz)."""
    out = []
    for side, mod in (("t", tper), ("j", jper)):
        d = tmp_path / side
        d.mkdir()
        for name, data in files.items():
            (d / name).write_bytes(data)
        out.append((mod.load_index(str(d), model), sorted(os.listdir(d))))
    return out


def _same_result(a, b):
    assert (a.state is None) == (b.state is None)
    assert a.needs_reindex == b.needs_reindex and a.migrated == b.migrated
    if a.state is not None:
        assert a.state.model == b.state.model
        np.testing.assert_array_equal(a.state.embeddings, b.state.embeddings)
        assert [vars(m) for m in a.state.metas] == [vars(m) for m in b.state.metas]
        assert a.state.document_hashes == b.state.document_hashes
        assert a.state.needs_reindex == b.state.needs_reindex


def _legacy_blob(rng, model, version=2, hashes=True):
    st = _state(jper.IndexState, JMeta, rng, n=4, model=model or "m")
    blob = {
        "version": version,
        "chunks": {
            m.id: {"id": m.id, "document_name": m.document_name, "text": m.text,
                   "embedding": [float(x) for x in st.embeddings[i]], "chunk_index": m.chunk_index,
                   "page_number": m.page_number, "section": m.section, "metadata": m.metadata}
            for i, m in enumerate(st.metas)
        },
        "needs_reindex": False,
        "document_hashes": st.document_hashes if hashes else {},
    }
    if model is not None:
        blob["model"] = model
    return json.dumps(blob).encode()


@pytest.mark.parametrize("hashes", [True, False])
def test_reference_json_written_by_jax_loads_like_jax(tmp_path, rng, hashes):
    """A data directory holding only the JAX package's export_reference_json
    file migrates in the port to the texts, metadata and embeddings (exact)
    the JAX load_index gives, writes the npz and keeps the JSON; the port's
    own export writes the same file."""
    st = _state(jper.IndexState, JMeta, rng, model="m/odel:1")
    if not hashes:  # no fingerprints: loaded, and marked for reindex
        st.document_hashes = {}
    src = tmp_path / "src"
    path = jper.export_reference_json(str(src), st)
    assert os.path.basename(path) == os.path.basename(tper.get_reference_json_path(str(src), st.model))
    with open(path, "rb") as f:
        data = f.read()
    (a, files_a), (b, files_b) = _load_both(tmp_path, {os.path.basename(path): data}, st.model)
    _same_result(a, b)
    assert a.migrated and a.state is not None and a.needs_reindex == (not hashes)
    assert [m.text for m in a.state.metas] == [m.text for m in st.metas]
    np.testing.assert_allclose(np.linalg.norm(a.state.embeddings, axis=1), 1.0, rtol=1e-6)
    assert files_a == files_b == sorted([os.path.basename(path), "chunks_m_odel_1.npz"])
    # each side's migrated npz reloads as an npz, to the same state in both
    # (rows re-normalised again on load, so equal to the first load up to
    # rounding)
    again_t = tper.load_index(str(tmp_path / "t"), st.model)
    again_j = jper.load_index(str(tmp_path / "j"), st.model)
    _same_result(again_t, again_j)
    assert not again_t.migrated
    np.testing.assert_allclose(again_t.state.embeddings, a.state.embeddings, rtol=0, atol=1e-6)
    tst = tper.IndexState(model=st.model, embeddings=st.embeddings,
                          metas=[TMeta(**vars(m)) for m in st.metas], document_hashes=st.document_hashes)
    with open(tper.export_reference_json(str(tmp_path / "mine"), tst), "rb") as f:
        assert f.read() == data


@pytest.mark.parametrize("case", ["matching_model", "other_model", "no_model_field", "version_1",
                                  "no_fingerprints"])
def test_legacy_chunks_json_like_jax(tmp_path, rng, case):
    """The legacy chunks.json: migrated when its model matches, kept and
    ignored for another model, needs_reindex without model info or below
    version 2 - in both packages alike; the file is never deleted."""
    blob = {
        "matching_model": lambda: _legacy_blob(rng, "m"),
        "other_model": lambda: _legacy_blob(rng, "other"),
        "no_model_field": lambda: _legacy_blob(rng, None),
        "version_1": lambda: _legacy_blob(rng, "m", version=1),
        "no_fingerprints": lambda: _legacy_blob(rng, "m", hashes=False),
    }[case]()
    (a, files_a), (b, files_b) = _load_both(tmp_path, {"chunks.json": blob}, "m")
    _same_result(a, b)
    assert files_a == files_b and "chunks.json" in files_a
    want = {"matching_model": (True, False), "other_model": (False, False), "no_model_field": (False, True),
            "version_1": (False, True), "no_fingerprints": (True, True)}[case]
    assert (a.state is not None, a.needs_reindex) == want
    if a.state is not None:
        assert a.migrated and "chunks_m.npz" in files_a


@pytest.mark.parametrize("case", ["garbage", "truncated", "version_1", "ragged_dims", "legacy_garbage"])
def test_unreadable_reference_json_like_jax(tmp_path, rng, case):
    """An unreadable or outdated reference JSON marks the index for reindex
    and is kept on disk; an unreadable legacy chunks.json starts fresh - as
    the JAX load_index does."""
    good = _legacy_blob(rng, "m")
    ragged = json.loads(good)
    next(iter(ragged["chunks"].values()))["embedding"].append(0.5)
    name, data = {
        "garbage": ("chunks_m.json", b"\x00 not json"),
        "truncated": ("chunks_m.json", good[: len(good) // 2]),
        "version_1": ("chunks_m.json", _legacy_blob(rng, "m", version=1)),
        "ragged_dims": ("chunks_m.json", json.dumps(ragged).encode()),
        "legacy_garbage": ("chunks.json", b"{{{"),
    }[case]
    (a, files_a), (b, files_b) = _load_both(tmp_path, {name: data}, "m")
    _same_result(a, b)
    assert a.state is None and a.needs_reindex == (case != "legacy_garbage")
    assert files_a == files_b == [name]


def test_saved_index_is_stored_uncompressed_and_loads_in_jax(tmp_path, rng):
    """The npz's embeddings are stored, not deflated (zlib over f32 noise
    took most of a save and saved little), its metadata JSON deflated;
    the JAX package's
    load_index reads the port's file, and the port still reads the JAX
    package's compressed one."""
    import zipfile

    st = _state(tper.IndexState, TMeta, rng)
    path = tper.save_index(str(tmp_path / "t"), st)
    with zipfile.ZipFile(path) as z:
        assert {i.filename: i.compress_type for i in z.infolist()} == {
            "embeddings.npy": zipfile.ZIP_STORED, "meta_json.npy": zipfile.ZIP_DEFLATED}
    a, b = tper.load_index(str(tmp_path / "t"), st.model), jper.load_index(str(tmp_path / "t"), st.model)
    np.testing.assert_array_equal(a.state.embeddings, b.state.embeddings)
    assert [vars(m) for m in a.state.metas] == [vars(m) for m in b.state.metas]
    jpath = jper.save_index(str(tmp_path / "j"), _state(jper.IndexState, JMeta, np.random.default_rng(42)))
    with zipfile.ZipFile(jpath) as z:
        assert all(i.compress_type == zipfile.ZIP_DEFLATED for i in z.infolist())
    c, d = tper.load_index(str(tmp_path / "j"), st.model), jper.load_index(str(tmp_path / "j"), st.model)
    np.testing.assert_array_equal(c.state.embeddings, d.state.embeddings)
    assert [vars(m) for m in c.state.metas] == [vars(m) for m in d.state.metas]


def test_shutdown_flush_saves_an_unsaved_mutation_at_index_size(tmp_path, caplog):
    """ROADMAP C8: an index of the chip smoke's size (33,033 chunks of 768
    dims) is mutated with no save after it; the shutdown flush
    (graceful_flush: the write lock, the reference's 5 s budget) must log a
    completed save, and a reload, by the port and by the JAX package, must
    see the mutation."""
    import logging
    import types

    from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine
    from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService
    from rust_local_rag_tpu_torch.models.fake_encoder import HashEncoder
    from rust_local_rag_tpu_torch.server.app import graceful_flush
    from rust_local_rag_tpu_torch.utils.rwlock import RwLock

    n, d = 33033, 768
    data = str(tmp_path / "data")
    engine = RagEngine(data, EmbeddingService(HashEncoder(dim=d)), device="cpu")
    rows = np.random.default_rng(3).standard_normal((n, d)).astype(np.float32)
    engine.add_chunks([TMeta(id=f"c{i}", document_name=f"doc{i // 1000}", text=f"record {i}", chunk_index=i % 1000)
                       for i in range(n)], rows)
    engine.document_hashes = {f"doc{i}": f"h{i}" for i in range(n // 1000 + 1)}
    engine.save_to_disk()
    # the mutation no save covers: one document replaced, two chunks added
    engine._remove_document_chunks("doc0")
    new = [TMeta(id=f"new{i}", document_name="late.pdf", text=f"late text {i}", chunk_index=i) for i in range(2)]
    engine.add_chunks(new, rows[:2] * -1.0)
    engine.document_hashes["late.pdf"] = "h-late"
    live = len(engine.store)
    assert live == n - 1000 + 2

    caplog.set_level(logging.INFO, logger="rust_local_rag_tpu_torch.server.app")
    graceful_flush(types.SimpleNamespace(engine=engine, engine_lock=RwLock()))
    assert "RAG state successfully saved to disk" in caplog.messages, caplog.messages
    model = engine.embedding_model()
    for res in (tper.load_index(data, model), jper.load_index(data, model)):
        ids = [m.id for m in res.state.metas]
        assert len(ids) == live and {"new0", "new1", "c1000"} <= set(ids) and "c0" not in ids
        assert res.state.document_hashes["late.pdf"] == "h-late"
        got = res.state.embeddings[[ids.index("new0"), ids.index("new1")]]
        np.testing.assert_allclose(got, -rows[:2] / np.linalg.norm(rows[:2], axis=1)[:, None], rtol=1e-6, atol=1e-6)
