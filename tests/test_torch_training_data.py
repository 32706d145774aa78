"""The port's training data (training/corpus, pairs, paraphrase, ood, mining,
train_reranker.PromptPairBatcher) against the JAX package's on the CPU.

The batchers are numpy over the same seed, paragraphs and token ids, so
their arrays must be equal, array for array, and so must the BM25
neighbour tables (the port's native index against the JAX package's).
The one exception is dense mining with the committed encoder, whose two
encoders (JAX on XLA, the port on torch) round bf16 activations at other
places: a neighbour may differ only where it ties within 1e-6 plus twice
the largest embedding difference (a cosine of unit vectors moves by at
most |a - a'| + |b - b'|).
"""

import os
import sys

import jax  # noqa: F401  (the JAX side of every comparison runs on the CPU)
import numpy as np
import pytest

from rust_local_rag_tpu.models.reranker_service import DEFAULT_PROMPT_TEMPLATE as JAX_TEMPLATE
from rust_local_rag_tpu.models.tokenizer import HfTokenizer
from rust_local_rag_tpu.training import corpus as jcorpus
from rust_local_rag_tpu.training import mining as jmining
from rust_local_rag_tpu.training import ood as jood
from rust_local_rag_tpu.training import paraphrase as jpara
from rust_local_rag_tpu.training.pairs import PairBatcher as JaxPairBatcher
from rust_local_rag_tpu.training.train_reranker import PromptPairBatcher as JaxPromptPairBatcher
from rust_local_rag_tpu.training.train_reranker import _doc_junk_queries as jax_doc_junk
from rust_local_rag_tpu_torch.models.reranker_service import DEFAULT_PROMPT_TEMPLATE
from rust_local_rag_tpu_torch.models.tokenizer import WordPieceTokenizer, load_tokenizer
from rust_local_rag_tpu_torch.training import corpus as tcorpus
from rust_local_rag_tpu_torch.training import mining as tmining
from rust_local_rag_tpu_torch.training import ood as tood
from rust_local_rag_tpu_torch.training import paraphrase as tpara
from rust_local_rag_tpu_torch.training.pairs import PairBatcher, bm25_neighbors
from rust_local_rag_tpu_torch.training.train_reranker import PromptPairBatcher, _doc_junk_queries

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK = os.path.join(ROOT, "rust_local_rag_tpu", "assets", "tokenizer.json")
CORPUS = os.path.join(ROOT, ".cache", "train_corpus.txt")
PREFIXES = {"query_prefix": "search_query: ", "doc_prefix": "search_document: "}


@pytest.fixture(scope="module")
def paragraphs():
    return tcorpus.load_paragraphs(CORPUS)[:400]


@pytest.fixture(scope="module")
def tokenizers():
    return HfTokenizer(TOK), load_tokenizer(TOK)


@pytest.fixture
def home(tmp_path, monkeypatch):
    """The premine caches of both packages in a directory of the test."""
    monkeypatch.setenv("HOME", str(tmp_path))
    return tmp_path


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("prefixes", [{}, PREFIXES], ids=["no_prefix", "prefixes"])
def test_pair_batcher_equals_jax(paragraphs, tokenizers, home, prefixes):
    jb = JaxPairBatcher(paragraphs, tokenizers[0], seed=3, **prefixes)
    tb = PairBatcher(paragraphs, tokenizers[1], seed=3, **prefixes)
    assert (tb.cls_id, tb.sep_id, tb.pad_id) == (jb.cls_id, jb.sep_id, jb.pad_id)
    np.testing.assert_array_equal(tb.q_prefix, jb.q_prefix)
    assert tb.texts == jb.texts and len(tb.docs) == len(jb.docs)
    for a, b in zip(tb.docs, jb.docs):
        np.testing.assert_array_equal(a, b)
    _same(tb.batch(8), jb.batch(8))
    _same(tb.stacked_batches(2, 4), jb.stacked_batches(2, 4))
    _same(tb.ict_batch(8), jb.ict_batch(8))
    _same(tb.ict_batch(8, p_len=256), jb.ict_batch(8, p_len=256))
    _same(tb.mixed_batch(8), jb.mixed_batch(8))
    _same(tb.mixed_stacked_batches(2, 4), jb.mixed_stacked_batches(2, 4))
    _same(tb.ict_stacked_batches(2, 4), jb.ict_stacked_batches(2, 4))
    _same(tb.ict_eval_bank(16), jb.ict_eval_bank(16))
    _same(tb.eval_bank(16), jb.eval_bank(16))
    jb.premine_hard_negatives(index_size=300)
    tb.premine_hard_negatives(index_size=300)
    np.testing.assert_array_equal(tb.neighbors, jb.neighbors)
    assert (tb.neighbors >= 0).mean() > 0.9
    _same(tb.mixed_hn_batch(8), jb.mixed_hn_batch(8))
    _same(tb.mixed_hn_stacked_batches(2, 4, 256), jb.mixed_hn_stacked_batches(2, 4, 256))
    # the port's cache is its own; a batcher that hits it keeps the rng
    # stream of one that mined
    files = sorted(os.listdir(home / ".cache" / "rag_tpu_premine"))
    assert [f for f in files if f.startswith("torch_")] and [f for f in files if not f.startswith("torch_")]
    mined, hit = (PairBatcher(paragraphs, tokenizers[1], seed=5, **prefixes) for _ in range(2))
    mined.premine_hard_negatives(index_size=300)
    hit.premine_hard_negatives(index_size=300)
    np.testing.assert_array_equal(hit.neighbors, mined.neighbors)
    _same(hit.mixed_hn_batch(8), mined.mixed_hn_batch(8))


def test_pair_batcher_pure_python_tokenizer_equal(paragraphs, tokenizers):
    """The batcher gives the same arrays through either port tokenizer."""
    a = PairBatcher(paragraphs[:100], tokenizers[1], seed=1, **PREFIXES)
    b = PairBatcher(paragraphs[:100], WordPieceTokenizer(TOK), seed=1, **PREFIXES)
    _same(a.mixed_batch(8), b.mixed_batch(8))


def test_bm25_neighbors_independent_of_threads(paragraphs):
    crops = tmining.canonical_crops(paragraphs[:120], seed=5)
    one = bm25_neighbors(paragraphs, list(range(100)), crops, 4, threads=1)
    many = bm25_neighbors(paragraphs, list(range(100)), crops, 4, threads=5)
    np.testing.assert_array_equal(one, many)


@pytest.mark.parametrize("ood_frac,paraphrase_frac", [(0.0, 0.0), (0.3, 0.5)])
def test_prompt_pair_batcher_equals_jax(paragraphs, tokenizers, home, ood_frac, paraphrase_frac):
    assert DEFAULT_PROMPT_TEMPLATE == JAX_TEMPLATE
    kw = dict(seq_len=96, seed=4, index_size=250, ood_frac=ood_frac, junk_hard_frac=0.0,
              paraphrase_frac=paraphrase_frac)
    jb = JaxPromptPairBatcher(paragraphs, tokenizers[0], JAX_TEMPLATE, **kw)
    tb = PromptPairBatcher(paragraphs, tokenizers[1], DEFAULT_PROMPT_TEMPLATE, device="cpu", **kw)
    assert tb.paragraphs == jb.paragraphs and tb.indexed == jb.indexed
    np.testing.assert_array_equal(tb.neighbors, jb.neighbors)
    _same(tb.batch(12), jb.batch(12))
    _same(tb.stacked(2, 6), jb.stacked(2, 6))
    assert tb._prompt("q", "t") == jb._prompt("q", "t")


def test_doc_junk_queries_equal_jax(paragraphs):
    for seed in (0, 7, 778):
        assert _doc_junk_queries(paragraphs[:50], 40, seed) == jax_doc_junk(paragraphs[:50], 40, seed)


def test_paraphrase_and_junk_queries_equal_jax(paragraphs):
    for seed in (0, 1, 5, 99):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for p in paragraphs[:40]:
            q = " ".join(p.split()[:10])
            assert tpara.paraphrase(q, a) == jpara.paraphrase(q, b)
        for split in ("train", "far", "near", "probe", "near_probe"):
            assert tood.junk_queries(300, seed=seed, split=split) == jood.junk_queries(300, seed=seed, split=split)
    with pytest.raises(ValueError):
        tood.junk_queries(3, split="nope")


def test_canonical_crops_equal_jax(paragraphs):
    for seed in (0, 987):
        assert tmining.canonical_crops(paragraphs, seed=seed) == jmining.canonical_crops(paragraphs, seed=seed)


def test_corpus_text_functions_equal_jax():
    text = (
        "Compute the arithmetic mean along the specified axis.\n"
        "Returns the :func:`average` of the array elements as ``ndarray``.\n\n"
        ">>> np.mean([1, 2, 3])\n2.0\n\n.. note:: something\n"
        "```\ncode block\n```\nSee [the docs](https://example.org) and `link <x>`_ here.\n"
        "Second paragraph about broadcasting rules across dimensions here.\n"
    )
    assert tcorpus.paragraphs_from_text(text) == jcorpus.paragraphs_from_text(text)
    for p in ("Gradient  Descent converges\nslowly", "gradient descent CONVERGES slowly", "", "Ünïcode text"):
        assert tcorpus.normalized_hash(p) == jcorpus.normalized_hash(p)
    for p in tcorpus.paragraphs_from_text(text) + ["2.0", "x " * 300]:
        assert tcorpus._looks_like_prose(p) == jcorpus._looks_like_prose(p)


def test_harvest_over_a_package_tree_equals_jax(tmp_path, monkeypatch):
    pkg = tmp_path / "rag_port_harvest_pkg"
    (pkg / "sub").mkdir(parents=True)
    prose = ("The scheduler assigns each unit of work to a replica and gathers the partial results "
             "into one ordered stream that consumers read with bounded memory.")
    (pkg / "__init__.py").write_text(f'"""{prose}\n\nA second paragraph explains how the replicas '
                                     'report their progress back to the coordinator at a fixed interval."""\n')
    (pkg / "sub" / "mod.py").write_text(
        'def f():\n    """Compute the rolling average of the values over the given window and return '
        'it as a new array of the same length as the input."""\n\n\nclass C:\n    """'
        f'{prose}"""\n')
    (pkg / "README.md").write_text("# Title\n\nThis package provides tools that let a user index documents "
                                   "and search them with a combination of lexical and dense scores.\n")
    (pkg / "broken.py").write_text("def (:\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    name = pkg.name
    a = tcorpus.harvest(packages=(name, "no_such_package_here"))
    b = jcorpus.harvest(packages=(name, "no_such_package_here"))
    assert a == b and len(a) == 4  # the repeated paragraph once
    ex = {tcorpus.normalized_hash(a[0])}
    assert tcorpus.harvest(packages=(name,), exclude_hashes=ex) == jcorpus.harvest(packages=(name,), exclude_hashes=ex)
    assert tcorpus.harvest(packages=(name,), max_paragraphs=2) == a[:2]
    path = tmp_path / "pars.txt"
    tcorpus.save_paragraphs(a, str(path))
    assert tcorpus.load_paragraphs(str(path)) == jcorpus.load_paragraphs(str(path)) == a
    assert "rag_port_harvest_pkg" not in sys.modules  # found by spec, never imported


def test_eval_passage_hashes_equal_eval_harness():
    from eval_harness.corpus import passage_hashes

    assert tcorpus.eval_passage_hashes() == passage_hashes()


class _Recording:
    """An embedding service that keeps what embed_texts returned."""

    def __init__(self, svc):
        self.svc, self.out = svc, []

    def embed_texts(self, texts):
        e = np.asarray(self.svc.embed_texts(texts))
        self.out.append(e)
        return e


def test_mine_dense_neighbors_with_committed_encoder_equal_jax(home, monkeypatch):
    """The committed encoder on both sides (the JAX package reads its
    default asset only without RAG_TPU_NO_DEFAULT_ASSETS), over 200 short
    paragraphs of the training corpus (one length bucket, for time)."""
    import rust_local_rag_tpu.models.embedding_service as jes
    import rust_local_rag_tpu_torch.models.embedding_service as tes

    monkeypatch.delenv("RAG_TPU_NO_DEFAULT_ASSETS", raising=False)
    monkeypatch.delenv("RAG_TPU_FAKE_ENCODER", raising=False)
    monkeypatch.delenv("ENCODER_WEIGHTS", raising=False)
    pars = [p for p in tcorpus.load_paragraphs(CORPUS)[:3000] if len(p.split()) <= 24][:200]
    assert len(pars) == 200
    jsvc, tsvc = _Recording(jes.build_default_service()), _Recording(tes.build_default_service("cpu"))
    monkeypatch.setattr(jes, "build_default_service", lambda: jsvc)
    monkeypatch.setattr(tes, "build_default_service", lambda device="cuda", model_name=None: tsvc)
    got = tmining.mine_dense_neighbors(pars, device="cpu")
    want = jmining.mine_dense_neighbors(pars)
    assert got is not None and want is not None and got.shape == want.shape == (200, 4)
    ej, et = tmining._unit(np.concatenate(jsvc.out)), tmining._unit(np.concatenate(tsvc.out))
    tol = 1e-6 + 2 * float(np.max(np.linalg.norm(ej - et, axis=1)))
    assert tol < 0.05
    sims = ej @ ej.T
    differ = 0
    for i in range(200):
        a, b = [int(x) for x in got[i] if x >= 0], [int(x) for x in want[i] if x >= 0]
        if a == b:
            continue
        differ += 1
        # a neighbour on one side only ties with a neighbour the other side
        # kept, or with the 0.9 near-duplicate cut; one out of order ties
        # with the one in its place
        for j in set(a) ^ set(b):
            edges = [sims[i, k] for k in (b if j in a else a)] + [0.9]
            assert min(abs(sims[i, j] - e) for e in edges) <= tol, (i, a, b)
        for x, y in zip(a, b):
            if x != y:
                assert abs(sims[i, x] - sims[i, y]) <= tol, (i, a, b)
    assert differ <= 20


def test_cache_keys_are_the_ports_own(paragraphs, home, monkeypatch):
    """mine_junk_neighbors' BM25 half equals JAX's and caches under torch_."""
    monkeypatch.setenv("RAG_TPU_NO_DEFAULT_ASSETS", "1")
    junk = tood.junk_queries(30, seed=2)
    got = tmining.mine_junk_neighbors(junk, paragraphs[:200], pool=list(range(150)), n_bm25=3, n_dense=0,
                                      device="cpu")
    want = jmining.mine_junk_neighbors(junk, paragraphs[:200], pool=list(range(150)), n_bm25=3, n_dense=0)
    np.testing.assert_array_equal(got, want)
    files = os.listdir(home / ".cache" / "rag_tpu_premine")
    assert sum(f.startswith("torch_junk_") for f in files) == 1 and sum(f.startswith("junk_") for f in files) == 1
    again = tmining.mine_junk_neighbors(junk, paragraphs[:200], pool=list(range(150)), n_bm25=3, n_dense=0,
                                        device="cpu")
    np.testing.assert_array_equal(again, got)
