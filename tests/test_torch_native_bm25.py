"""The port's native BM25 index (csrc/lexical.cpp through
ops/native_bm25.NativeLexicalIndex) against the port's pure-Python index
and both JAX indexes, over the same seeded chunks and slots, whether it
is filled one chunk a call or in batches (add_chunks).

Tolerances: native scores are f32 sums of f64 terms against the Python
indexes' f64, so scores agree within rel 1e-5 (the bound the JAX package's
own parity test uses, tests/test_native_bm25.py) and the unseen mass, an
f32 ratio of f64 sums, within 1e-6. Hit sets are compared as sets: rows
whose scores tie within that tolerance may fall on either side of a
top-`limit` cut. Against the JAX native index (the same C++ source) the
answers are identical.
"""

import sys
import threading

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch  # noqa: F401

from rust_local_rag_tpu.ops import bm25 as jbm25
from rust_local_rag_tpu.ops import native_bm25 as jnative
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine
from rust_local_rag_tpu_torch.kernels import build
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService
from rust_local_rag_tpu_torch.ops import native_bm25 as tnative
from rust_local_rag_tpu_torch.ops.bm25 import LexicalIndex
from rust_local_rag_tpu_torch.utils import profiling

REL = 1e-5
MASS_TOL = 1e-6
LIMIT = 50

WORDS = [f"w{i:03d}" for i in range(300)] + [
    "pump", "valve", "seal", "bearing", "café", "naïve", "straße", "Ωmega", "日本語", "résumé",
]


def _corpus(seed: int = 11, n: int = 400):
    """n seeded chunk texts of Zipf-weighted words (some non-ASCII), with a
    few empty-token chunks and exact duplicates."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 0.9
    p = p / p.sum()
    rng.shuffle(p)
    texts = []
    for i in range(n):
        words = rng.choice(WORDS, rng.integers(5, 40), p=p)
        texts.append(" ".join(words) + (", ok!" if i % 7 else ""))
    texts[13] = "a b c -- !!"  # tokenises to nothing
    texts[77] = texts[76]      # an exact duplicate: tied scores
    return texts


def _queries(seed: int = 12, n: int = 100):
    rng = np.random.default_rng(seed)
    qs = [" ".join(rng.choice(WORDS, rng.integers(1, 6))) for _ in range(n)]
    qs[:6] = ["pump VALVE", "café naïve", "Straße 日本語", "zzz never seen words", "", "w001 w001 unknownterm"]
    return qs


@pytest.fixture(scope="module")
def texts():
    return _corpus()


def _filled(index, texts, slotted=True):
    for i, t in enumerate(texts):
        index.add_chunk(f"c{i}", t, i if slotted else None)
    return index


def _jax_native():
    if not (jnative.native_available() or jnative.build_native()):
        pytest.skip("the JAX package's native library is not built and could not be built")
    return jnative.NativeLexicalIndex()


REFERENCES = {
    "port_python": LexicalIndex,
    "jax_python": jbm25.LexicalIndex,
    "jax_native": _jax_native,
}


def _same_hits(got, want, what):
    """Same top-`limit` hit sets with scores within rel REL; an id on one
    side only must tie (within REL) with the last score."""
    assert len(got) == len(want), what
    if not got:
        return
    g, w = dict(got), dict(want)
    floor = min(min(g.values()), min(w.values()))
    for cid in set(g) ^ set(w):
        assert (g.get(cid, w.get(cid)) - floor) <= REL * max(abs(floor), 1.0), (what, cid)
    for cid in set(g) & set(w):
        assert g[cid] == pytest.approx(w[cid], rel=REL, abs=1e-12), (what, cid)


@pytest.mark.parametrize("ref", sorted(REFERENCES))
def test_score_and_unseen_mass_match(texts, ref):
    nat = _filled(tnative.NativeLexicalIndex(), texts)
    other = _filled(REFERENCES[ref](), texts)
    assert nat.total_docs == other.total_docs == len(texts) - 1
    for q in _queries():
        _same_hits(nat.score(q, LIMIT), other.score(q, LIMIT), q)
        full_n, full_o = dict(nat.score(q, 0)), dict(other.score(q, 0))
        assert set(full_n) == set(full_o), q
        for cid, v in full_n.items():
            assert v == pytest.approx(full_o[cid], rel=REL, abs=1e-12), (q, cid)
        assert abs(nat.unseen_mass(q) - other.unseen_mass(q)) <= MASS_TOL, q
        if ref == "jax_native":  # the same C++ source: identical answers
            assert nat.score(q, LIMIT) == other.score(q, LIMIT), q


@pytest.mark.parametrize("kind", ["ascii", "non_ascii"])
def test_score_slots_into_paths(texts, kind):
    """score_slots_into: the C++ tokeniser for ASCII queries, the Python one
    otherwise; both give the Python index's hits, and for an ASCII query
    the two C++ paths give identical rows."""
    nat = _filled(tnative.NativeLexicalIndex(), texts)
    py = _filled(LexicalIndex(), texts)
    queries = [q for q in _queries() if q.isascii() == (kind == "ascii")]
    assert len(queries) >= 3
    for q in queries:
        rows = {}
        for name, index in (("native", nat), ("python", py)):
            slots = np.full(LIMIT + 3, -1, dtype=np.int32)
            vals = np.zeros(LIMIT + 3, dtype=np.float32)
            n = index.score_slots_into(q, LIMIT, slots, vals)
            assert (slots[n:] == -1).all() and n <= LIMIT
            rows[name] = [(f"c{s}", float(v)) for s, v in zip(slots[:n], vals[:n])]
        _same_hits(rows["native"], rows["python"], q)
        if kind == "ascii":
            with nat._lock:
                n = nat._score_into_scratch(tnative._joined(q), True, LIMIT)
                token_path = [(f"c{s}", float(v)) for s, v in zip(nat._scratch_slots[:n], nat._scratch_vals[:n])]
            assert token_path == rows["native"], q


def test_remove_drop_stale_reuse_and_clear(texts):
    nat = _filled(tnative.NativeLexicalIndex(), texts)
    py = _filled(LexicalIndex(), texts)
    jn = _filled(_jax_native(), texts)
    for index in (nat, py, jn):
        assert not index.contains("c13") and index.contains("c12")
        index.remove_chunk("c5")
        index.drop_stale({f"c{i}" for i in range(len(texts)) if i % 3})
        # slot reuse: a new chunk takes the slot of a dropped one
        index.add_chunk("fresh", "pump valve café seal w001", 3)
        # re-adding under the same id replaces the text
        index.add_chunk("c1", "bearing bearing naïve", 1)
        # an empty-token chunk is not indexed, and replacing with one removes
        index.add_chunk("c2", "-- !!", 2)
    for q in _queries()[:40] + ["pump valve café seal w001", "bearing naïve"]:
        _same_hits(nat.score(q, LIMIT), py.score(q, LIMIT), q)
        assert nat.score(q, LIMIT) == jn.score(q, LIMIT), q
        assert abs(nat.unseen_mass(q) - py.unseen_mass(q)) <= MASS_TOL
    for cid in ("c0", "c3", "c5", "c2", "fresh", "c1", "c4"):
        assert nat.contains(cid) == py.contains(cid) == jn.contains(cid), cid
    assert nat.total_docs == py.total_docs == jn.total_docs
    assert nat.slots_aligned
    nat.clear()
    assert nat.total_docs == 0 and nat.score("pump", 5) == [] and nat.unseen_mass("pump") == 0.0
    assert not nat.contains("fresh") and nat.slots_aligned
    nat.add_chunk("x", "pump valve")
    assert not nat.slots_aligned and nat.score("pump", 5)[0][0] == "x"
    with pytest.raises(RuntimeError, match="slots"):
        nat.score_slots_into("pump", 5, np.zeros(5, np.int32), np.zeros(5, np.float32))


def test_compile_all_counts(texts):
    """Every term is compiled once (none has df >= 1024 here); a mutation
    stales every snapshot; the JAX native index counts the same."""
    nat = _filled(tnative.NativeLexicalIndex(), texts)
    jn = _filled(_jax_native(), texts)
    terms = len(_filled(LexicalIndex(), texts).term_postings)
    before = nat.score("pump valve", LIMIT)
    jn.score("pump valve", LIMIT)
    assert nat.compile_all() == jn.compile_all() == terms - 2  # "pump" and "valve" compiled by the score
    assert nat.compile_all() == 0
    assert nat.score("pump valve", LIMIT) == before
    nat.add_chunk("new", "pump", len(texts))
    assert nat.compile_all() == terms
    assert LexicalIndex().compile_all() == 0


def test_concurrent_scoring_equals_sequential(texts):
    """8 threads x 100 queries scoring one index at once give the
    sequential answers (the C++ scorer's scratch is shared per index)."""
    nat = _filled(tnative.NativeLexicalIndex(), texts)
    queries = _queries(seed=99, n=100)

    def answer(q):
        slots = np.full(LIMIT, -1, dtype=np.int32)
        vals = np.zeros(LIMIT, dtype=np.float32)
        n = nat.score_slots_into(q, LIMIT, slots, vals)
        return slots[:n].tolist(), vals[:n].tolist(), nat.score(q, 20), nat.unseen_mass(q)

    want = [answer(q) for q in queries]
    got = [[None] * len(queries) for _ in range(8)]
    errors = []

    def worker(t):
        try:
            order = list(range(len(queries)))
            np.random.default_rng(t).shuffle(order)
            for i in order:
                got[t][i] = answer(queries[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors
    for t in range(8):
        assert got[t] == want, f"thread {t}"


# the same edits, in order, for every way of filling an index: (chunk id,
# text, slot) adds, with removals and a drop_stale between them. Slots are
# reused inside one add (slot 10, and id n1 twice) and across adds (slots 3
# and 6 after their chunks went); c5 is removed and added again.
def _edits(texts):
    return [
        ("add", [(f"c{i}", t, i) for i, t in enumerate(texts)]),
        ("remove", ["c5", "c6", "c7"]),
        ("add", [("c5", texts[5], 5), ("n1", "pump valve w001 straße", 6), ("n2", "seal seal bearing Ωmega", 400),
                 ("n1", "valve résumé gasket", 401), ("c10", "bearing pump pump", 10), ("n3", "-- !!", 402),
                 ("n4", "naïve w002 w003 pump", 10), ("c11", texts[12], 11)]),
        ("drop_stale", lambda ids: {c for c in ids if not c.startswith("c") or int(c[1:]) % 3}),
        ("add", [("n5", "pump valve café seal w001", 3), ("c1", "bearing bearing naïve", 1), ("c2", "-- !!", 2),
                 ("n2", "w004 w004 w005", 7)]),
    ]


class _Edited:
    """An index taking _edits one at a time: adds one add_chunk a chunk
    (batch None), else add_chunks in batches of `batch` (0: each add
    whole). The Python index is keyed by chunk id alone, so for it the
    chunk holding a reused slot is removed first, as the engine's store
    does."""

    def __init__(self, index, batch, slotted=True):
        self.index, self.batch, self.slotted = index, batch, slotted
        self.ids, self._held, self._where = set(), {}, {}
        self._evict = isinstance(index, LexicalIndex) and slotted

    def apply(self, op, arg):
        index = self.index
        if op == "remove":
            for cid in arg:
                index.remove_chunk(cid)
            self.ids -= set(arg)
            return
        if op == "drop_stale":
            self.ids = arg(self.ids)
            index.drop_stale(self.ids)
            return
        self.ids |= {cid for cid, _, _ in arg}
        if self.batch is None:
            for cid, text, slot in arg:
                prior = self._held.get(slot)
                if self._evict and prior not in (None, cid) and self._where.get(prior) == slot:
                    index.remove_chunk(prior)
                self._held[slot], self._where[cid] = cid, slot
                index.add_chunk(cid, text, slot if self.slotted else None)
            return
        step = self.batch or len(arg)
        for lo in range(0, len(arg), step):
            part = arg[lo:lo + step]
            index.add_chunks([c for c, _, _ in part], [t for _, t, _ in part],
                             [s for _, _, s in part] if self.slotted else None)


def _rows(index, q):
    slots = np.full(LIMIT, -1, dtype=np.int32)
    vals = np.zeros(LIMIT, dtype=np.float32)
    n = index.score_slots_into(q, LIMIT, slots, vals)
    return slots[:n].tolist(), vals[:n].tolist()


@pytest.mark.parametrize("fill", ["per_chunk", "batch_1", "batch_7", "batch_all", "auto_slots"])
def test_batched_adds_equal_per_chunk(texts, fill):
    """add_chunks in batches of 1, 7 or whole adds, over ASCII, non-ASCII
    and token-less texts with slot reuse, removals and drop_stale: the
    same hits, order and f32 scores as one add_chunk a chunk and as the
    JAX package's native index (the same arithmetic), the Python index's
    hits within REL, and the same df through compile_all's count."""
    slotted = fill != "auto_slots"
    batch = {"per_chunk": None, "batch_1": 1, "batch_7": 7, "batch_all": 0, "auto_slots": 7}[fill]
    edited = [_Edited(tnative.NativeLexicalIndex(), batch, slotted), _Edited(tnative.NativeLexicalIndex(), None, slotted),
              _Edited(_jax_native(), None, slotted), _Edited(LexicalIndex(), None, slotted)]
    nat, one, jn, py = (e.index for e in edited)
    for op, arg in _edits(texts):
        for e in edited:
            e.apply(op, arg)
        assert nat.total_docs == one.total_docs == jn.total_docs == py.total_docs, op
        for q in ("pump valve", "seal w001 straße", "bearing naïve"):
            assert nat.score(q, 0) == one.score(q, 0) == jn.score(q, 0), (op, q)
            if slotted:
                assert _rows(nat, q) == _rows(one, q) == _rows(jn, q), (op, q)
    ids = edited[0].ids
    assert nat.slots_aligned == slotted
    for cid in sorted(ids | {"c5", "c6", "c10", "n3", "c2", "c3", "c0"}):
        assert nat.contains(cid) == jn.contains(cid) == py.contains(cid), cid
    assert nat.compile_all() == jn.compile_all() == one.compile_all()
    assert nat.compile_all() == 0
    queries = _queries() + ["pump valve café seal w001", "bearing naïve", "seal Ωmega", "gasket résumé", "w004 w005"]
    for q in queries:
        got = nat.score(q, LIMIT)
        assert got == one.score(q, LIMIT) == jn.score(q, LIMIT), q
        _same_hits(got, py.score(q, LIMIT), q)
        assert nat.score(q, 0) == jn.score(q, 0), q
        assert nat.unseen_mass(q) == one.unseen_mass(q) == jn.unseen_mass(q), q
        assert abs(nat.unseen_mass(q) - py.unseen_mass(q)) <= MASS_TOL, q
        if slotted:
            assert _rows(nat, q) == _rows(one, q), q
            assert _rows(nat, q) == _rows(jn, q), q


def test_removed_terms_leave_df(texts):
    """A term whose every posting was removed is unseen again (df 0), and
    the df of a term counts live postings only, after removals and slot
    reuse, as in the JAX package's native index."""
    nat = _filled(tnative.NativeLexicalIndex(), texts)
    jn = _filled(_jax_native(), texts)
    nat.add_chunks(["u1", "u2"], ["uniqueterm pump", "uniqueterm seal"], [500, 501])
    jn.add_chunk("u1", "uniqueterm pump", 500)
    jn.add_chunk("u2", "uniqueterm seal", 501)
    assert nat.unseen_mass("uniqueterm") == jn.unseen_mass("uniqueterm") == 0.0
    nat.remove_chunk("u1")
    nat.add_chunks(["u3"], ["other words"], [501])  # slot 501 reused: u2 goes
    jn.remove_chunk("u1")
    jn.add_chunk("u3", "other words", 501)
    assert nat.unseen_mass("uniqueterm") == jn.unseen_mass("uniqueterm") == 1.0
    assert nat.score("uniqueterm", LIMIT) == [] and not nat.contains("u2")
    assert nat.compile_all() == jn.compile_all()
    for q in ("pump", "seal pump", "other words"):
        assert nat.score(q, 0) == jn.score(q, 0), q


def test_text_counters_count_each_text_once(texts):
    """bm25.texts_native / bm25.texts_python count each text once, by where
    it was tokenised: C++ for ASCII text, Python otherwise; the Python
    index tokenises every text in Python."""
    ascii_n = sum(t.isascii() for t in texts)
    assert 0 < ascii_n < len(texts)
    profiling.reset()
    profiling.enable()
    try:
        nat = tnative.NativeLexicalIndex()
        nat.add_chunks([f"c{i}" for i in range(len(texts))], texts, list(range(len(texts))))
        nat.add_chunk("a", "plain ascii words", len(texts))
        nat.add_chunk("b", "café naïve", len(texts) + 1)
        assert profiling.snapshot()["counters"] == {"bm25.texts_native": ascii_n + 1,
                                                    "bm25.texts_python": len(texts) - ascii_n + 1}
        profiling.reset()
        nat.add_chunks(["x"], ["only ascii"], [0])
        LexicalIndex().add_chunks(["p", "q"], ["pump", "café"], [0, 1])
        assert profiling.snapshot()["counters"] == {"bm25.texts_native": 1, "bm25.texts_python": 2}
    finally:
        profiling.disable()
        profiling.reset()
    nat.add_chunks(["y"], ["off now"], [1])
    assert profiling.snapshot()["counters"] == {}


def test_selection_and_no_silent_fallback(monkeypatch, tmp_path):
    monkeypatch.delenv("RAG_TPU_NATIVE_BM25", raising=False)
    assert type(tnative.make_lexical_index()) is tnative.NativeLexicalIndex
    monkeypatch.setenv("RAG_TPU_NATIVE_BM25", "0")
    assert type(tnative.make_lexical_index()) is LexicalIndex
    monkeypatch.delenv("RAG_TPU_NATIVE_BM25")

    class _Enc:
        dim, model_name = 8, "fake"

        def encode(self, texts):
            return np.ones((len(texts), 8), dtype=np.float32)

    assert type(RagEngine(str(tmp_path / "a"), EmbeddingService(_Enc()), device="cpu").lexical_index) \
        is tnative.NativeLexicalIndex

    def failed(name):
        raise RuntimeError(f"building {name} failed")

    monkeypatch.setattr(build, "load", failed)
    with pytest.raises(RuntimeError, match="lexical"):
        tnative.make_lexical_index()
    with pytest.raises(RuntimeError, match="lexical"):
        RagEngine(str(tmp_path / "b"), EmbeddingService(_Enc()), device="cpu")
