"""The port's scale check and its oracle (tools/scale_check.py,
tools/oracle_check.py) against the JAX scripts (scripts/scale_check.py,
scripts/oracle_check.py), on the CPU at a small SCALE_N.

The oracle is duck-typed over an engine (store.snapshot_host, the query
cache, search, lexical_index.score), so each package's oracle is run on
the other package's engine, both engines filled by the same seeded rows
and texts: the JAX oracle must pass on the port's engine and the port's
oracle on the JAX engine, with the same seeds, and the two engines must
return the same ids for the oracle's probes. The oracle compares ranked
ids, so it has no tolerance; a near-tie within f32 rounding could swap two
ids, and these seeds have none. A broken engine (answers reversed) must
fail it.
"""

import importlib.util
import json
import os
import tempfile

import numpy as np
import pytest

from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService
from rust_local_rag_tpu_torch.models.fake_encoder import HashEncoder
from rust_local_rag_tpu_torch.tools import oracle_check, scale_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 3000


def _script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_under_test", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def engines():
    """(port engine, JAX engine) over the same N seeded rows and texts."""
    from rust_local_rag_tpu.engine.chunk_store import ChunkMeta as JMeta
    from rust_local_rag_tpu.engine.rag_engine import RagEngine as JEngine
    from rust_local_rag_tpu.models import EmbeddingService as JService
    from rust_local_rag_tpu.models import HashEncoder as JHash

    with tempfile.TemporaryDirectory() as tmp:
        port = RagEngine(os.path.join(tmp, "port"), EmbeddingService(HashEncoder(768, "scale-check")), device="cpu")
        scale_check.populate(port, N, np.random.default_rng(0))
        jax_eng = JEngine(os.path.join(tmp, "jax"), JService(JHash(dim=768, model_name="scale-check")))
        rng = np.random.default_rng(0)
        emb = rng.standard_normal((N, 768)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        metas = [JMeta(id=f"c{i}", document_name=f"doc{i % 500}.pdf",
                       text=f"synthetic chunk {i} with filler words alpha beta", chunk_index=i,
                       page_number=(i % 40) + 1) for i in range(N)]
        jax_eng.store.add_chunks(metas, emb)
        for m in metas[:: max(1, N // 200)]:
            jax_eng.lexical_index.add_chunk(m.id, m.text)
        yield port, jax_eng


def test_engines_hold_the_same_state(engines):
    port, jax_eng = engines
    (pe, pm), (je, jm) = port.store.snapshot_host(), jax_eng.store.snapshot_host()
    assert [m.id for m in pm] == [m.id for m in jm] and np.array_equal(pe, je)
    for q in ("alpha beta", "synthetic chunk 2070 with 1050"):
        got, want = dict(port.lexical_index.score(q, 1000)), dict(jax_eng.lexical_index.score(q, 1000))
        assert len(got) == 200 and got.keys() == want.keys()
        assert [got[k] for k in want] == pytest.approx(list(want.values()), rel=1e-6)


def test_jax_oracle_passes_on_the_port_engine(engines):
    assert _script("oracle_check").validate(engines[0], np.random.default_rng(7), n_queries=3, top_k=20)


def test_port_oracle_passes_on_the_jax_engine(engines):
    assert oracle_check.validate(engines[1], np.random.default_rng(7), n_queries=3, top_k=20)


def test_engines_answer_the_probes_alike(engines):
    port, jax_eng = engines
    assert oracle_check.validate(port, np.random.default_rng(9), n_queries=3, top_k=20)
    assert _script("oracle_check").validate(jax_eng, np.random.default_rng(9), n_queries=3, top_k=20)
    for qi in range(3):
        text = f"__oracle_probe_{qi}__"
        assert [r.chunk_id for r in port.search(text, 20)] == [r.chunk_id for r in jax_eng.search(text, 20)]


def test_oracle_fails_a_broken_engine(engines, monkeypatch, capsys):
    port = engines[0]
    search = port.search
    monkeypatch.setattr(port, "search", lambda q, k: list(reversed(search(q, k))))
    assert not oracle_check.validate(port, np.random.default_rng(7), n_queries=2, top_k=20)
    assert "rank mismatches" in capsys.readouterr().out


def test_scale_check_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("SCALE_N", str(N))
    monkeypatch.setattr(scale_check, "BATCHES", (4, 8))
    assert scale_check.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu" and "oracle ranking parity: PASS" in lines
    out = json.loads(lines[-1])["scale_check"]
    assert out["n"] == N and out["capacity"] == 4096 and out["oracle"] is True
    assert out["score_segmax_masked_launches"] == 0  # CPU tensors take the plain version
    assert out["batch8_qps"] > 0 and out["ms_per_query"] > 0
