"""The port's response serializer (csrc/serializer.cpp through
server/serializer.py) against the JAX package's (native/serializer.cpp
through rust_local_rag_tpu/server/serializer.py), on the same stores and
columnar inputs: the same bytes, byte for byte. The JAX side skips where
its library is not built (as tests/test_serializer.py does); the port's
side builds from its own source and never skips: its bodies are also held
to SearchResult.to_dict of the same rows.

Scores are formatted by the C++ with 7 fractional digits, so a parsed
score is within 5e-8 of the f32 it came from (checked at 1e-7)."""

import json

import numpy as np
import pytest

from rust_local_rag_tpu.engine.chunk_store import ChunkMeta as JMeta
from rust_local_rag_tpu.engine.chunk_store import ChunkStore as JStore
from rust_local_rag_tpu.server.serializer import ResponseSerializer as JSerializer
from rust_local_rag_tpu.server.serializer import native_serializer_available
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta, ChunkStore
from rust_local_rag_tpu_torch.engine.rag_engine import SearchResult
from rust_local_rag_tpu_torch.kernels import build
from rust_local_rag_tpu_torch.server.serializer import ResponseSerializer

DIM = 8
FMT_TOL = 1e-7

TEXTS = [
    'passage with "quotes", backslash \\ and emoji 🎯',
    "ünïcödé «guillemets» and CJK 検索",
    "control \x01 bytes \t tabs \n newlines \r",
    "plain ascii text",
    "x" * 700,  # longer than the 512-byte row guess
    "</script> & <b>markup</b>",
]


def _metas(cls, n, prefix="c"):
    return [
        cls(id=f"{prefix}{i}", document_name=f"doc {i % 2} «ü».pdf", text=TEXTS[i % len(TEXTS)] + f" #{i}",
            chunk_index=i, page_number=i % 3, section="intro" if i % 2 else None)
        for i in range(n)
    ]


def _rows(n, seed=0):
    e = np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _stores(n=12):
    """A port store and a JAX store with the same chunks in the same slots."""
    port = ChunkStore(DIM, device="cpu")
    jax_store = JStore(dim=DIM)
    port.add_chunks(_metas(ChunkMeta, n), _rows(n))
    jax_store.add_chunks(_metas(JMeta, n), _rows(n))
    return port, jax_store


def _columns(nq, k, n, seed):
    rng = np.random.default_rng(seed)
    slots = rng.integers(-1, n, size=(nq, k)).astype(np.int32)
    score = rng.uniform(-1.5, 1.5, size=(nq, k)).astype(np.float32)
    score[0, 0] = np.float32(-np.inf)
    score[-1, -1] = np.float32(np.nan)
    score[0, 1] = np.float32(123456.789)  # past the fixed-point range
    emb = rng.uniform(-0.2, 1.0, size=(nq, k)).astype(np.float32)
    lex = rng.uniform(0.0, 1.0, size=(nq, k)).astype(np.float32)
    return slots, score, emb, lex


def _rr_columns(nq, k, n, seed):
    slots, _, emb, lex = _columns(nq, k, n, seed)
    rng = np.random.default_rng(seed + 1)
    score = rng.uniform(0.0, 1.0, size=(nq, k)).astype(np.float32)  # the weight-0 blend
    initial = rng.uniform(0.0, 1.0, size=(nq, k)).astype(np.float32)
    initial[1, 2] = np.float32(-np.inf)
    rr = rng.uniform(0.0, 1.0, size=(nq, k)).astype(np.float32)
    yes = np.log(rr + 1e-6).astype(np.float32)
    no = np.log(1.0 - rr + 1e-6).astype(np.float32)
    return slots, score, emb, lex, initial, rr, yes, no


def _jax():
    if not native_serializer_available():
        pytest.skip("the JAX package's native library (native/librag_native.so) is not built")


@pytest.mark.parametrize("floor", [0.0, 0.35])
@pytest.mark.parametrize("preregister", [False, True])
def test_batch_bytes_equal_jax(floor, preregister):
    _jax()
    port, jstore = _stores()
    ps, js = ResponseSerializer(lambda: port), JSerializer(lambda: jstore)
    if preregister:
        assert ps.preregister_all() == js.preregister_all() == 12
    cols = _columns(5, 9, 12, seed=3)
    a = ps.serialize_batch(*cols, floor=floor)
    b = js.serialize_batch(*cols, floor=floor)
    assert a == b
    for qi in range(5):
        assert ps.serialize_query(*(c[qi] for c in cols), floor=floor) == a[qi]


@pytest.mark.parametrize("emb_floor,rr_floor", [(0.0, 0.0), (0.3, 0.0), (0.0, 0.5), (0.2, 0.4)])
def test_rr_bytes_equal_jax(emb_floor, rr_floor):
    _jax()
    port, jstore = _stores()
    cols = _rr_columns(4, 10, 12, seed=7)
    a = ResponseSerializer(lambda: port).serialize_batch_rr(*cols, emb_floor=emb_floor, rr_floor=rr_floor)
    b = JSerializer(lambda: jstore).serialize_batch_rr(*cols, emb_floor=emb_floor, rr_floor=rr_floor)
    assert a == b


@pytest.mark.parametrize("preregister", [False, True])
def test_slot_reuse_after_replacement_equals_jax(preregister):
    """A slot freed by a document replacement and refilled serves the new
    chunk in both packages, with or without the bulk registration (whose
    "complete" state the mutation counter invalidates)."""
    _jax()
    port, jstore = _stores(6)
    ps, js = ResponseSerializer(lambda: port), JSerializer(lambda: jstore)
    if preregister:
        ps.preregister_all()
        js.preregister_all()
    cols = _columns(2, 6, 6, seed=11)
    assert ps.serialize_batch(*cols) == js.serialize_batch(*cols)
    for store, cls in ((port, ChunkMeta), (jstore, JMeta)):
        store.remove_ids(["c1", "c4"])
        store.add_chunks(_metas(cls, 2, prefix="new"), _rows(2, seed=5))
    assert {port.slot_for_id("new0"), port.slot_for_id("new1")} == {1, 4}
    a, b = ps.serialize_batch(*cols), js.serialize_batch(*cols)
    assert a == b
    ids = [r["chunk_id"] for body in a for r in json.loads(body)["results"]]
    assert "c1" not in ids and "c4" not in ids


def test_mutation_counter_bumps_like_jax():
    port, jstore = _stores(6)
    seq = [port.mutations]
    jseq = [jstore.mutations]
    for store, cls, out in ((port, ChunkMeta, seq), (jstore, JMeta, jseq)):
        store.remove_ids(["c2"])
        out.append(store.mutations)
        store.remove_ids(["missing"])  # nothing removed: no bump
        out.append(store.mutations)
        store.add_chunks(_metas(cls, 1, prefix="z"), _rows(1))
        out.append(store.mutations)
        store.compact()
        out.append(store.mutations)
    assert seq == jseq == [1, 2, 2, 3, 4]


def _port_bodies_vs_objects(bodies, cols, store, floor=0.0):
    """Each body parses to the to_dict rows of the kept columnar rows."""
    slots, score, emb, lex = cols
    for qi, body in enumerate(bodies):
        want = []
        for s, v, e, lx in zip(slots[qi].tolist(), score[qi].tolist(), emb[qi].tolist(), lex[qi].tolist()):
            if s < 0 or not np.isfinite(v) or (floor > 0 and e < floor):
                continue
            m = store.meta_for_slot(s)
            want.append(SearchResult(text=m.text, score=v, document=m.document_name, chunk_id=m.id,
                                     chunk_index=m.chunk_index, page_number=m.page_number, section=m.section,
                                     embedding_score=e, lexical_score=lx, initial_score=v).to_dict())
        got = json.loads(body)["results"]
        assert [sorted(r) for r in got] == [sorted(w) for w in want]
        for g, w in zip(got, want):
            for key, val in w.items():
                if isinstance(val, float):
                    assert g[key] == pytest.approx(val, abs=FMT_TOL, rel=FMT_TOL), key
                else:
                    assert g[key] == val, key


@pytest.mark.parametrize("floor", [0.0, 0.35])
def test_port_bodies_parse_to_the_object_path(floor):
    port, _ = _stores()
    cols = _columns(5, 9, 12, seed=3)
    cols[1][0, 1] = 0.5  # keep the past-fixed-point value out of the tolerance check
    _port_bodies_vs_objects(ResponseSerializer(lambda: port).serialize_batch(*cols, floor=floor), cols, port, floor)


def test_port_rr_bodies_gate_like_results_from_judged():
    port, _ = _stores()
    slots, score, emb, lex, initial, rr, yes, no = _rr_columns(4, 10, 12, seed=7)
    bodies = ResponseSerializer(lambda: port).serialize_batch_rr(
        slots, score, emb, lex, initial, rr, yes, no, emb_floor=0.2, rr_floor=0.4)
    for qi, body in enumerate(bodies):
        want = [
            (port.meta_for_slot(s).id, r)
            for s, v, e, r in zip(slots[qi].tolist(), initial[qi].tolist(), emb[qi].tolist(), rr[qi].tolist())
            if s >= 0 and np.isfinite(v) and r >= 0.4 and e >= 0.2
        ]
        got = json.loads(body)["results"]
        assert [(g["chunk_id"], pytest.approx(g["reranker_score"], abs=FMT_TOL)) for g in got] == \
            [(i, pytest.approx(r, abs=FMT_TOL)) for i, r in want]
        assert all(list(g)[-4:] == ["initial_score", "reranker_score", "yes_logprob", "no_logprob"] for g in got)


def test_port_buffer_grows_and_registry_counts():
    port = ChunkStore(4, device="cpu")
    big = "y" * (3 << 20)
    port.add_chunks([ChunkMeta(id="big", document_name="b.pdf", text=big, chunk_index=0, page_number=1)],
                    np.full((1, 4), 0.5, dtype=np.float32))
    ser = ResponseSerializer(lambda: port)
    empty = np.zeros((1, 0), dtype=np.float32)
    assert ser.serialize_batch(np.zeros((1, 0), dtype=np.int32), empty, empty, empty) == [b'{"results": []}']
    one = np.ones((1, 1), dtype=np.float32)
    out = ser.serialize_batch(np.zeros((1, 1), dtype=np.int32), one, one, one)
    assert json.loads(out[0])["results"][0]["text"] == big
    assert ser.count() == 1 and ser.preregister_all() == 1 and ser.count() == 1


def test_port_serializer_raises_when_its_library_fails(monkeypatch):
    """No silent fallback: a library that does not build is an error."""
    def broken(name):
        raise RuntimeError(f"building {name} failed")

    monkeypatch.setattr(build, "load", broken)
    with pytest.raises(RuntimeError, match="serializer"):
        ResponseSerializer(lambda: None)
