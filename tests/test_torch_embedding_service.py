"""The port's query-embedding cache against the JAX package's: a locked
LRU (utils/lru.LruCache) shared by concurrent batches, with the JAX
cache's eviction order and its "every miss in one model call" contract.

The model is the JAX package's HashEncoder (numpy only, no device path),
so get_query_embeddings goes through the cache in both services."""

import sys
import threading

import jax  # noqa: F401
import numpy as np
import pytest

from rust_local_rag_tpu.models.embedding_service import EmbeddingService as JService
from rust_local_rag_tpu.models.fake_encoder import HashEncoder
from rust_local_rag_tpu.utils.lru import LruCache as JLru
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService as TService
from rust_local_rag_tpu_torch.utils.lru import LruCache as TLru

DIM = 32


class CountingEncoder(HashEncoder):
    """HashEncoder that records the texts of every model call."""

    def __init__(self):
        super().__init__(dim=DIM)
        self.calls = []

    def encode(self, texts):
        self.calls.append(list(texts))
        return super().encode(texts)


def test_query_cache_is_safe_under_concurrent_batches():
    """8 threads over a 2-entry cache: every get races other threads' puts
    and evictions. Nothing may raise, and every row is the model's own."""
    model = HashEncoder(dim=DIM)
    svc = TService(model, query_cache_size=2)
    vocab = [f"query {i}" for i in range(6)]
    want = {t: model.encode([t])[0] for t in vocab}
    errors, start = [], threading.Barrier(8)

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            start.wait(timeout=30)
            for _ in range(300):
                texts = [vocab[i] for i in rng.integers(0, len(vocab), size=3)]
                out = svc.get_query_embeddings(texts)
                for t, row in zip(texts, out):
                    np.testing.assert_array_equal(row, want[t])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often, so the races show
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert len(svc._cache) <= 2


def test_lru_matches_jax_operation_by_operation():
    """The same puts and gets leave the same keys, in the same order, in
    the port's LruCache and the JAX one (a get moves a key to the young end,
    a put of a present key too; the oldest goes first)."""
    rng = np.random.default_rng(3)
    t, j = TLru(3), JLru(3)
    for _ in range(400):
        key = int(rng.integers(0, 6))
        if rng.random() < 0.5:
            assert t.get(key) == j.get(key)
        else:
            t.put(key, key * 10)
            j.put(key, key * 10)
        assert list(t._data.items()) == list(j._data.items())
        assert len(t) == len(j)
    t.clear()
    j.clear()
    assert len(t) == len(j) == 0
    with pytest.raises(ValueError, match="capacity"):
        TLru(0)


def test_put_then_get_keeps_the_lru_order_of_jax():
    """Through the services: a, b cached; a read again (a is young); c
    evicts b in both, so b is a miss and a a hit."""
    services = [(cls, CountingEncoder()) for cls in (TService, JService)]
    calls = []
    for cls, model in services:
        svc = cls(model, query_cache_size=2)
        svc.get_query_embeddings(["a", "b"])
        svc.get_query_embeddings(["a"])
        svc.get_query_embeddings(["c"])
        svc.get_query_embeddings(["a", "b"])
        calls.append(model.calls)
    assert calls[0] == calls[1] == [["a", "b"], ["c"], ["b"]]


def test_every_miss_is_embedded_in_one_model_call_like_jax():
    rng = np.random.default_rng(9)
    bursts = [[f"q{i}" for i in rng.integers(0, 12, size=5)] for _ in range(20)]
    outs, calls = [], []
    for cls in (TService, JService):
        model = CountingEncoder()
        svc = cls(model, query_cache_size=4)
        outs.append([svc.get_query_embeddings(b) for b in bursts])
        calls.append(model.calls)
    assert calls[0] == calls[1]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert TService(CountingEncoder()).get_query_embeddings([]).shape == (0, DIM)


# ---- the hermetic models (RAG_TPU_FAKE_ENCODER, RAG_TPU_FAKE_RERANKER) ----

HERMETIC_TEXTS = ["Replace the pump seal.", "", "ünïcode Ünïcode 123 mixed-CASE words",
                  "a b c d e f g h " * 40, "Query: pump seal\nChunk:\nReplace the seal."]


@pytest.mark.parametrize("dim", [16, 128, 768])
def test_port_hash_encoder_is_bit_identical_to_jax(dim):
    from rust_local_rag_tpu_torch.models.fake_encoder import HashEncoder as THash

    a, b = THash(dim=dim).encode(HERMETIC_TEXTS), HashEncoder(dim=dim).encode(HERMETIC_TEXTS)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    assert THash(dim=dim).encode([]).shape == (0, dim)


def test_port_fake_reranker_is_bit_identical_to_jax():
    from rust_local_rag_tpu.models.reranker import FakeReranker as JFake
    from rust_local_rag_tpu.models.reranker_service import RerankerCandidate as JCand
    from rust_local_rag_tpu.models.reranker_service import RerankerService as JSvc
    from rust_local_rag_tpu_torch.models.reranker import FakeReranker as TFake
    from rust_local_rag_tpu_torch.models.reranker_service import RerankerCandidate as TCand
    from rust_local_rag_tpu_torch.models.reranker_service import RerankerService as TSvc

    t, j = TSvc(TFake(model_name="rr")), JSvc(JFake(model_name="rr"))
    for q in ("pump seal", "zebra quasar"):
        tc = [TCand(f"c{i}", "m.pdf", x, i, None, 0.5) for i, x in enumerate(HERMETIC_TEXTS)]
        jc = [JCand(f"c{i}", "m.pdf", x, i, None, 0.5) for i, x in enumerate(HERMETIC_TEXTS)]
        got = t.score_prompts([t.build_prompt(q, c) for c in tc])
        assert got == j.score_prompts([j.build_prompt(q, c) for c in jc])
        assert t.fetch_prompts(t.dispatch_prompts([t.build_prompt(q, tc[0])])) == got[:1]
    assert t.model_name == "rr"


def test_hermetic_default_services_like_jax(monkeypatch):
    from rust_local_rag_tpu.models.embedding_service import build_default_service as j_build
    from rust_local_rag_tpu.models.reranker_service import build_default_reranker as j_rr
    from rust_local_rag_tpu_torch.models.embedding_service import build_default_service
    from rust_local_rag_tpu_torch.models.reranker import FakeReranker as TFake
    from rust_local_rag_tpu_torch.models.reranker_service import build_default_reranker

    monkeypatch.setenv("RAG_TPU_FAKE_ENCODER", "1")
    monkeypatch.setenv("RAG_TPU_FAKE_ENCODER_DIM", "48")
    monkeypatch.setenv("RAG_TPU_EMBEDDING_MODEL", "hermetic-model")
    t, j = build_default_service(device="cpu"), j_build()
    assert (t.model_name, t.dim) == (j.model_name, j.dim) == ("hermetic-model", 48)
    assert np.array_equal(t.get_query_embeddings(HERMETIC_TEXTS), j.get_query_embeddings(HERMETIC_TEXTS))
    monkeypatch.delenv("RAG_TPU_RERANK_MODEL", raising=False)
    monkeypatch.delenv("OLLAMA_RERANK_MODEL", raising=False)
    assert build_default_reranker("cpu") is None and j_rr() is None
    monkeypatch.setenv("RAG_TPU_RERANK_MODEL", "fake-rr")
    monkeypatch.setenv("RAG_TPU_FAKE_RERANKER", "1")
    svc = build_default_reranker("cuda")  # the hash judge needs no device
    assert isinstance(svc._model, TFake) and svc.model_name == j_rr().model_name == "fake-rr"


class FailingBatchEncoder(HashEncoder):
    """Raises on any call of more than one text (an out-of-memory batch)."""

    def __init__(self):
        super().__init__(dim=DIM)

    def encode(self, texts):
        if len(texts) > 1:
            raise RuntimeError("CUDA out of memory (simulated)")
        return super().encode(texts)


class ShortBatchEncoder(HashEncoder):
    """Drops the last row of any call of more than one text."""

    def __init__(self):
        super().__init__(dim=DIM)

    def encode(self, texts):
        out = super().encode(texts)
        return out[:-1] if len(texts) > 1 else out


@pytest.mark.parametrize("model_cls", [FailingBatchEncoder, ShortBatchEncoder])
def test_embed_in_batches_falls_back_per_text_as_jax(model_cls):
    """A batch that raises or returns the wrong row count is encoded again
    one text at a time (JAX embed_texts, embedding_service.py:132-156), so
    every chunk of the document still gets its row, equal to the JAX
    service's and to the model's own single-text rows."""
    texts = [f"chunk {i} " + "word " * (i % 7) for i in range(11)]
    want = np.stack([HashEncoder(dim=DIM).encode([t])[0] for t in texts])
    got_j = JService(model_cls()).embed_in_batches(texts, batch_size=4, cooldown_ms=0)
    got_t = TService(model_cls()).embed_in_batches(texts, batch_size=4, cooldown_ms=0)
    np.testing.assert_array_equal(got_j, want)
    np.testing.assert_array_equal(got_t, got_j)


def test_embed_texts_matches_jax_and_raises_on_a_failing_text():
    texts = ["alpha beta", "gamma", "delta epsilon zeta"]
    for model_cls in (HashEncoder, FailingBatchEncoder, ShortBatchEncoder):
        a = JService(model_cls(dim=DIM) if model_cls is HashEncoder else model_cls()).embed_texts(texts)
        b = TService(model_cls(dim=DIM) if model_cls is HashEncoder else model_cls()).embed_texts(texts)
        np.testing.assert_array_equal(b, a)
    assert TService(HashEncoder(dim=DIM)).embed_texts([]).shape == (0, DIM)

    class AlwaysFails(HashEncoder):
        def encode(self, texts):
            raise RuntimeError("encoder down")

    for svc in (JService(AlwaysFails(dim=DIM)), TService(AlwaysFails(dim=DIM))):
        with pytest.raises(RuntimeError, match="encoder down"):
            svc.embed_texts(texts)


def test_get_embedding_and_get_query_embedding_match_jax():
    """get_embedding is the model's row; get_query_embedding goes through
    the query cache (one model call for a repeated query), as in JAX."""
    mj, mt = CountingEncoder(), CountingEncoder()
    sj, st = JService(mj), TService(mt)
    np.testing.assert_array_equal(st.get_embedding("some text"), sj.get_embedding("some text"))
    for q in ("first query", "second query", "first query"):
        np.testing.assert_array_equal(st.get_query_embedding(q), sj.get_query_embedding(q))
    assert mt.calls == mj.calls == [["some text"], ["first query"], ["second query"]]
    # the single-query and batch lanes share one cache
    np.testing.assert_array_equal(st.get_query_embeddings(["second query"])[0], sj.get_query_embedding("second query"))
    assert len(mt.calls) == 3
