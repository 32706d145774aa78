"""The generators: deterministic from --seed, the same amount of work for
every seed, and means that match the sources."""

import json
import os

import numpy as np
import pytest
import torch

from harness import gen, runner
from reference.bm25 import tokenize
from reference.tokenizer import WordPieceTokenizer

TOKENIZER = os.path.join(runner.ROOT, "rust_local_rag_tpu", "assets", "tokenizer.json")
BIG_SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def tok():
    return WordPieceTokenizer(TOKENIZER)


@pytest.fixture(scope="module")
def vocabs(tok):
    return {name: gen.vocabulary(tok, gen.vocabulary_size(_config(name)))
            for name in ("trec-covid-f32", "msmarco-passage-bf16")}


def _config(name):
    with open(os.path.join(runner.BENCH_DIR, "configs", name + ".json"), encoding="utf-8") as f:
        return json.load(f)


def test_vocabulary_size_is_heaps_law_at_the_sources_scale():
    # V = 44 T^0.49 at T = documents x mean words of the whole source
    assert gen.vocabulary_size(_config("trec-covid-f32")) == round(44 * (171332 * 160.77) ** 0.49) == 194569
    assert gen.vocabulary_size(_config("msmarco-passage-bf16")) == round(44 * (8841823 * 55.98) ** 0.49)


def test_every_word_is_its_pieces_and_one_bm25_token(tok, vocabs):
    v = vocabs["trec-covid-f32"]
    assert v.n_whole > 5000 and len(set(v.words.tolist())) == len(v)
    for i in range(len(v)):
        assert len(tok.tokenize(v[i])) - 2 == v.pieces[i], v[i]
    for w in v.words[::101]:
        assert tokenize(w) == [w]
    big = vocabs["msmarco-passage-bf16"]
    assert list(big.words[:len(v)][:v.n_whole]) == list(v.words[:v.n_whole])
    for i in range(0, len(big), 53):
        assert len(tok.tokenize(big[i])) - 2 == big.pieces[i], big[i]


@pytest.mark.parametrize("config", ["trec-covid-f32", "msmarco-passage-bf16"])
def test_token_counts_are_the_tokenizers(tok, vocabs, config):
    v = vocabs[config]
    c = gen.corpus(v, _config(config)["corpus"], 3000, BIG_SEED)
    pieces = v.tokens(c)
    for i in range(0, 3000, 37):
        assert len(tok.tokenize_full(c.texts[i])) - 2 == pieces[i] == v.text_pieces(c.texts[i])
    # about 1.3 pieces a word, as English under WordPiece
    assert 1.2 < pieces.sum() / c.offsets[-1] < 1.45


@pytest.mark.parametrize("config", ["trec-covid-f32", "msmarco-passage-bf16"])
def test_corpus_is_the_seeds_and_its_mean_the_sources(vocabs, config):
    vocab = vocabs[config]
    spec = _config(config)["corpus"]
    a = gen.corpus(vocab, spec, 20000, BIG_SEED)
    b = gen.corpus(vocab, spec, 20000, BIG_SEED)
    c = gen.corpus(vocab, spec, 20000, BIG_SEED + 1)
    assert a.texts == b.texts and a.texts != c.texts
    lens = np.diff(a.offsets)
    assert abs(lens.mean() / spec["mean_words"] - 1) < 0.01
    assert lens.min() >= spec["min_words"] and lens.max() <= spec["max_words"]
    assert sorted(lens) == sorted(np.diff(c.offsets))  # every seed: the same lengths, another order
    for i in (0, 7, 19999):
        assert tokenize(a.texts[i]) == [vocab[j] for j in a.words(i)]


@pytest.mark.parametrize("traffic", ["reindex", "reindex-msmarco-docs"])
def test_document_sizes_are_the_same_multiset_for_every_seed(traffic):
    with open(os.path.join(runner.BENCH_DIR, "traffic", traffic + ".json"), encoding="utf-8") as f:
        spec = json.load(f)["passages_per_document"]
    a = gen.document_sizes(spec, BIG_SEED)
    b = gen.document_sizes(spec, BIG_SEED + 1)
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert np.array_equal(a, gen.document_sizes(spec, BIG_SEED))
    if "range" in spec:
        assert sorted(a) == list(range(spec["range"][0], spec["range"][1] + 1))
    else:
        assert len(a) == spec["cycle"] and a.min() >= 1
        assert abs(a.mean() / spec["mean"] - 1) < 0.01


@pytest.mark.parametrize("config", ["trec-covid-f32", "msmarco-passage-bf16"])
def test_queries_are_distinct_and_skip_the_top_ranks(vocabs, config):
    vocab = vocabs[config]
    spec = _config(config)["queries"]
    q = gen.queries(vocab, spec, 5000, BIG_SEED)
    assert len(set(q.texts)) == 5000
    assert q.ids.min() >= spec["skip_ranks"]
    assert abs(np.diff(q.offsets).mean() / spec["mean_words"] - 1) < 0.03
    assert gen.queries(vocab, spec, 5000, BIG_SEED).texts == q.texts


def test_zipf_shares():
    ids = gen.zipf_ids(np.random.default_rng(0), 2_000_000, 1000, 1.0)
    p = 1.0 / np.arange(1, 1001)
    p /= p.sum()
    share = np.bincount(ids, minlength=1000) / len(ids)
    assert np.abs(share[:10] - p[:10]).max() < 3e-3
    skip = gen.zipf_ids(np.random.default_rng(0), 10000, 1000, 1.0, skip=64)
    assert skip.min() >= 64


def test_rows_are_unit_and_the_seeds():
    a = gen.rows(300, 16, BIG_SEED, "cpu")
    assert torch.equal(a, gen.rows(300, 16, BIG_SEED, "cpu"))
    assert not torch.equal(a, gen.rows(300, 16, BIG_SEED + 1, "cpu"))
    assert torch.allclose(a.norm(dim=1), torch.ones(300), atol=1e-6)
