"""The port's calibration studies (rust_local_rag_tpu_torch/tools/:
judge_dev, gate_grid, blend_offline, joint_ood, query_cosine_floor)
against the JAX scripts they port (scripts/exp_*.py), on the CPU.

The scripts are loaded by path; exp_gate_grid and exp_blend_offline
import exp_judge_dev by name, so that module is registered under its name.
scripts/ itself is not edited.

  * the judge studies: `_heads` is replaced on both sides by the same
    seeded synthetic heads (12 queries of 15 candidates, 4 of them junk),
    and RAG_TPU_FAKE_RERANKER=1 gives both sides the hash judge, which
    scores alike in both packages (tests/test_torch_reranker.py), so the
    printed tables must be equal line for line (the cache file's name in
    gate_grid's first line aside: the port keeps its own);
  * the committed judge named by RERANKER_WEIGHTS on both sides: each
    candidate's yes-probability within 0.03. The gap is bf16 rounded at
    other places through 4 layers, as in tests/test_torch_reranker.py,
    whose 0.01 holds for its 5 prompts; over these 180 it reaches 0.0197
    (a yes-p near 0.95 sits where the sigmoid is steep), and the smoke's
    kernel-on / kernel-off gap is of the same size (RR_TOL 0.02). Then the
    port's tables computed from JAX's yes-probabilities must equal JAX's
    printed ones (the table logic exact, the judge within tolerance);
  * the engine studies and `_heads` itself: both packages' engines over
    the generated eval corpus with the hash encoder
    (RAG_TPU_FAKE_ENCODER=1): the same heads (texts, documents, pages in
    order; scores within 1e-5, f32 sums in another order; unseen mass
    within 1e-6), and joint_ood's and query_cosine_floor's printed tables
    equal line for line.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

from rust_local_rag_tpu_torch.models.encoder import default_asset
from rust_local_rag_tpu_torch.tools import blend_offline, common, gate_grid, joint_ood, judge_dev, query_cosine_floor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED_ATOL = 0.03
HEAD_ATOL = 1e-5
MASS_ATOL = 1e-6
WORDS = ("pump seal torque flange bolt star pattern sourdough starter galaxy nebula pawn king opening "
         "watering tomato yeast oven telescope gasket valve").split()
JUNK_WORDS = "wormhole quasar zeppelin kazoo marmalade tundra origami lantern".split()


def load_script(name: str, monkeypatch):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, name, mod)
    spec.loader.exec_module(mod)
    return mod


def synthetic_heads(seed: int = 0, nq: int = 12, k: int = 15, junk: int = 4):
    """judge_dev._heads' rows from a seeded generator. A retrieval query's
    words recur in some candidates of its head, one of which is a gold
    document's; a junk query's words (JUNK_WORDS) recur in none, its
    candidates' cosines are lower and its unseen mass higher."""
    rng = np.random.default_rng(seed)
    heads = []
    for qi in range(nq):
        is_rej = qi >= nq - junk
        query = " ".join(rng.choice(JUNK_WORDS if is_rej else WORDS, 4))
        head = []
        for r in range(k):
            doc = f"doc{int(rng.integers(0, 6))}.pdf"
            words = list(rng.choice(WORDS, int(rng.integers(6, 20))))
            on_topic = not is_rej and rng.uniform() < 0.4
            text = " ".join(words + (query.split() if on_topic else []))
            emb = float(rng.uniform(0.45, 0.75) if on_topic else rng.uniform(0.1, 0.4))
            head.append((text, doc, int(rng.integers(1, 9)), None if r % 3 else "Section",
                         float(rng.uniform(0.2, 1.0)), emb))
        gold = [] if is_rej else [{"document": head[int(rng.integers(0, 3))][1], "page": 1}]
        heads.append((query, is_rej, gold, head, float(rng.uniform(0.5, 0.9) if is_rej else rng.uniform(0.0, 0.45))))
    return heads


@pytest.fixture
def hermetic(monkeypatch):
    for k in ("RERANKER_WEIGHTS", "ENCODER_WEIGHTS", "TOKENIZER_PATH", "RAG_TPU_FUSED_ATTN"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RAG_TPU_FAKE_RERANKER", "1")
    monkeypatch.setenv("RAG_TPU_FAKE_ENCODER", "1")
    monkeypatch.setenv("RAG_TPU_RERANK_MODEL", "tpu-reranker")
    return monkeypatch


@pytest.fixture
def jax_judge_dev(monkeypatch):
    return load_script("exp_judge_dev", monkeypatch)


def _run(main, capsys, *args):
    capsys.readouterr()
    main(*args)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("study", ["exp_judge_dev", "exp_gate_grid", "exp_blend_offline"])
def test_judge_studies_print_the_jax_tables(study, hermetic, jax_judge_dev, capsys):
    heads = synthetic_heads()
    hermetic.setattr(jax_judge_dev, "_heads", lambda: heads)
    hermetic.setattr(judge_dev, "_heads", lambda *a, **k: heads)
    jmod = jax_judge_dev if study == "exp_judge_dev" else load_script(study, hermetic)
    port = {"exp_judge_dev": judge_dev, "exp_gate_grid": gate_grid, "exp_blend_offline": blend_offline}[study]
    want = _run(jmod.main, capsys)
    got = _run(port.main, capsys, ["--device", "cpu"])
    if study == "exp_gate_grid":
        assert want[0] == "12 dev queries (cache: dev_heads2.pkl)"
        assert got[0] == "12 dev queries (cache: torch_dev_heads.pkl)"
        want, got = want[1:], got[1:]
    assert got == want
    assert len(got) > 8


def test_gate_grid_covers_the_jax_grid():
    """The grid's size and its 3-way rows, from the data function."""
    heads = synthetic_heads(1)
    rows = gate_grid.grid(heads, np.random.default_rng(2).uniform(0, 1, 12 * 15))
    assert len(rows) == 5 * 7 * (1 + 11 * 4 * 6)
    assert all(0.0 <= r[0] <= 1.0 and 0.0 <= r[1] <= 1.0 for r in rows)
    t = gate_grid.table(heads, np.random.default_rng(2).uniform(0, 1, 12 * 15))
    assert t["pareto"][0][0] == max(r[0] for r in rows)


def test_committed_judge_named_by_reranker_weights(hermetic, jax_judge_dev, capsys):
    from rust_local_rag_tpu.models import reranker_service as jsvc

    hermetic.delenv("RAG_TPU_FAKE_RERANKER")
    hermetic.setenv("RERANKER_WEIGHTS", default_asset("reranker.safetensors"))
    hermetic.setenv("TOKENIZER_PATH", default_asset("tokenizer.json"))
    heads = synthetic_heads(3)
    jrr = jsvc.build_default_reranker()
    prompts = [jrr.build_prompt(q, jsvc.RerankerCandidate("", doc, text, page, section, initial))
               for q, _r, _g, head, _u in heads for text, doc, page, section, initial, _e in head]
    want = np.asarray([s for s, _, _ in jrr.score_prompts(prompts)])
    capsys.readouterr()
    got = np.asarray(common.score_heads(heads, common.default_judge("cpu")))
    assert got.shape == want.shape == (180,)
    np.testing.assert_allclose(got, want, atol=COMMITTED_ATOL, rtol=0)

    # the table logic, exactly, on JAX's yes-probabilities
    hermetic.setattr(jax_judge_dev, "_heads", lambda: heads)
    hermetic.setattr(jrr, "score_prompts", lambda p: [(float(s), 0.0, 0.0) for s in want])
    hermetic.setattr(jsvc, "build_default_reranker", lambda: jrr)
    for name, port in (("exp_judge_dev", judge_dev), ("exp_blend_offline", blend_offline)):
        jmod = jax_judge_dev if name == "exp_judge_dev" else load_script(name, hermetic)
        lines = _run(jmod.main, capsys)
        sub = heads if port is judge_dev else [h for h in heads if not h[1]]
        ys = want if port is judge_dev else want[np.repeat([not h[1] for h in heads], 15)]
        assert lines[-len(port.lines(port.table(sub, ys))):] == port.lines(port.table(sub, ys))
    lines = _run(load_script("exp_gate_grid", hermetic).main, capsys)
    assert lines[-len(gate_grid.lines(gate_grid.table(heads, want))):] == gate_grid.lines(gate_grid.table(heads, want))


@pytest.fixture(scope="module")
def jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")


def _same_heads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        assert abs(g[4] - w[4]) <= MASS_ATOL
        assert [x[:4] for x in g[3]] == [x[:4] for x in w[3]]
        np.testing.assert_allclose([x[4:] for x in g[3]], [x[4:] for x in w[3]], atol=HEAD_ATOL, rtol=0)


def test_heads_equal_jax(hermetic, jax_judge_dev, tmp_path, jax_cpu):
    """_heads over the generated eval corpus with the hash encoder: the
    same heads as the JAX script's, each written to its own cache and read
    back from it."""
    hermetic.setattr(jax_judge_dev, "CACHE", str(tmp_path / "jax" / "dev_heads2.pkl"))
    hermetic.setattr(judge_dev, "CACHE", str(tmp_path / "port" / "torch_dev_heads.pkl"))
    want = jax_judge_dev._heads()
    got = judge_dev._heads("cpu")
    assert len(got) == 168 and sum(h[1] for h in got) == 15
    _same_heads(got, want)
    assert os.path.exists(judge_dev.CACHE)
    _same_heads(judge_dev._heads("cpu"), want)


@pytest.mark.parametrize("study", ["exp_joint_ood", "exp_query_cosine_floor"])
def test_engine_studies_print_the_jax_tables(study, hermetic, capsys, jax_cpu):
    jmod = load_script(study, hermetic)
    port = {"exp_joint_ood": joint_ood, "exp_query_cosine_floor": query_cosine_floor}[study]
    want = _run(jmod.main, capsys)
    got = _run(port.main, capsys, ["--device", "cpu"])
    assert got == want
    assert got[0].startswith("chunks: ") and len(got) > 6
