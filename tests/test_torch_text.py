"""Port parity of the host-side text path: tokenizer, PDF extraction,
chunking and BM25, against the JAX package on the same inputs.

Every comparison here is exact: the port copies these algorithms, and the
WordPiece reader must give the ids of the HuggingFace tokenizer that the
JAX package loads for the same tokenizer.json.
"""

import os
import random

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch  # noqa: F401

from pdfgen import make_pdf
from rust_local_rag_tpu.ingest import chunking as jchunk
from rust_local_rag_tpu.ingest import pdf as jpdf
from rust_local_rag_tpu.models import tokenizer as jtok
from rust_local_rag_tpu.ops import bm25 as jbm25
from rust_local_rag_tpu_torch.ingest import chunking as tchunk
from rust_local_rag_tpu_torch.ingest import pdf as tpdf
from rust_local_rag_tpu_torch.models import tokenizer as ttok
from rust_local_rag_tpu_torch.models.encoder import default_asset
from rust_local_rag_tpu_torch.ops import bm25 as tbm25

TOK_JSON = default_asset("tokenizer.json")


@pytest.fixture(scope="module")
def pair():
    return ttok.WordPieceTokenizer(TOK_JSON), jtok.HfTokenizer(TOK_JSON)


EDGE = [
    "",
    "Hello, World! Replace the pump seal (see Fig. 3).",
    "Bayesian eyes say YES; yesterday's yes-man",
    "[CLS] literal [SEP][PAD] [MASK] [UNK] and [cls] lowercase",
    "Café naïve résumé coöperate ÉCOLE Ångström",
    "Σίσυφος ΣΟΦΙΑ straße İstanbul ǅemal",
    "日本語のテキスト。中文，标点！한국어 텍스트",
    "dash — en–dash “quotes” ‘single’ «guillemets» …",
    "tabs\tand\nnewlines\r\nand\x0bvertical\x0cfeeds  nbsp\xa0here",
    "\x1c\x1d\x1e\x1f separators u+3000　ideographic",
    "combining é ä and emoji 😀🎉 ⃝",
    "x" * 70 + " supercalifragilisticexpialidocious pneumonoultramicroscopic",
    "   ",
]


@pytest.mark.parametrize("text", EDGE)
def test_wordpiece_matches_hf_on_edge_cases(pair, text):
    port, hf = pair
    assert port.tokenize_full(text) == hf.tokenize_full(text)
    assert port.tokenize(text) == hf.tokenize(text)


def test_wordpiece_matches_hf_fuzz(pair):
    port, hf = pair
    rng = random.Random(7)
    pools = [
        "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 ,.;:!?()[]-_'\"\t\n",
        "éèêëÉÀÇçñÑöÖüÜßøÅæ",
        " 　\x1c\x85\xa0",
        "—–…«»“”‘’•·¿¡",
        "ΣσςΑαβγДжЯİıŁł",
        "日本語中文한국어😀",
        "yes YES [CLS][SEP]",
    ]
    for _ in range(400):
        s = "".join(rng.choice(rng.choice(pools)) for _ in range(rng.randint(0, 80)))
        assert port.tokenize_full(s) == hf.tokenize_full(s), repr(s)


def test_wordpiece_encode_batch_matches_hf(pair):
    port, hf = pair
    texts = EDGE + ["word " * 300, "short"]
    a_ids, a_mask = port.encode_batch(texts)
    b_ids, b_mask = hf.encode_batch(texts)
    np.testing.assert_array_equal(a_ids, b_ids)
    np.testing.assert_array_equal(a_mask, b_mask)
    assert port.vocab_size == hf.vocab_size == 8193


def test_hash_tokenizer_and_helpers_match():
    texts = ["Hello world, pumps & valves.", "", "x " * 600]
    a = ttok.HashTokenizer(vocab_size=512, max_len=64)
    b = jtok.HashTokenizer(vocab_size=512, max_len=64)
    for x, y in zip(a.encode_batch(texts), b.encode_batch(texts)):
        np.testing.assert_array_equal(x, y)
    for n in (1, 3, 64, 65, 700):
        assert ttok.bucket_length(n) == jtok.bucket_length(n)
        assert ttok.bucket_batch(n) == jtok.bucket_batch(n)
    rows = [[2, 5, 6, 3], list(range(40))]
    for x, y in zip(ttok.headtail_pack(rows, 16), jtok.headtail_pack(rows, 16)):
        np.testing.assert_array_equal(x, y)


def test_load_tokenizer_backends(tmp_path, monkeypatch):
    """The native tokenizer by default, the pure-Python one under
    RAG_TPU_NATIVE_TOKENIZER=0, the hash tokenizer without a file."""
    from rust_local_rag_tpu_torch.models.native_tokenizer import NativeWordPieceTokenizer

    monkeypatch.delenv("RAG_TPU_NATIVE_TOKENIZER", raising=False)
    assert isinstance(ttok.load_tokenizer(TOK_JSON), NativeWordPieceTokenizer)
    monkeypatch.setenv("RAG_TPU_NATIVE_TOKENIZER", "0")
    assert isinstance(ttok.load_tokenizer(TOK_JSON), ttok.WordPieceTokenizer)
    assert isinstance(ttok.load_tokenizer(str(tmp_path / "missing.json")), ttok.HashTokenizer)


PAGES = [
    [
        "INTRODUCTION\n\nThe pump (model P-100) moves water. It has a seal.\n\n"
        "Dr. Smith wrote the manual in Dec. 2020. Fig. 3 shows the valve.",
        "MAINTENANCE:\n\nCheck the bearing every 500 h. Replace the gasket if it leaks!\n\n"
        "Is the motor hot? Stop it... and wait. The U.S. office said so.",
        "Troubleshooting\n\nNoise at 3.5 kHz means cavitation. See section 4.2 (e.g. inlet).",
    ],
    ["Single page with one short line."],
    ["Escapes \\ and (nested (parens)) and backslash-n \\n text. " * 30, "Second page text here."],
]


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("pages", PAGES)
def test_pdf_extract_and_chunk_match_jax(pages, compress):
    data = make_pdf(pages, compress=compress)
    text = tpdf.extract_pdf_text(data)
    assert text == jpdf._builtin_extract(data)
    for budget in (20, 200):
        a = tchunk.chunk_text(text, budget)
        b = jchunk.chunk_text(text, budget)
        assert [(f.text, f.page_number, f.section, f.metadata) for f in a] == [
            (f.text, f.page_number, f.section, f.metadata) for f in b
        ]


def test_pdf_without_text_raises():
    with pytest.raises(tpdf.PdfExtractionError):
        tpdf.extract_pdf_text(b"%PDF-1.4\nnothing here\n%%EOF")


def test_chunking_ignores_srx_env(monkeypatch, tmp_path):
    """The port's splitter is the built-in one whatever RAG_TPU_SRX_FILE says."""
    text = "First sentence here. Second one follows. Third closes."
    want = tchunk.split_sentences(text)
    monkeypatch.setenv("RAG_TPU_SRX_FILE", str(tmp_path / "rules.srx"))
    assert tchunk.split_sentences(text) == want == jchunk.split_sentences(text)


def test_bm25_tokenize_matches_jax_fuzz():
    rng = random.Random(3)
    pool = "abcXYZ019_ -.,éÉ日本ß²³½ⅣŁ́٣"
    for _ in range(3000):
        s = "".join(rng.choice(pool) for _ in range(rng.randint(0, 30)))
        assert tbm25.tokenize(s) == jbm25.tokenize(s), repr(s)


def test_bm25_index_matches_jax(rng):
    words = "pump valve seal bearing motor shaft flow pressure gasket rotor".split()
    docs = [" ".join(rng.choice(words, rng.integers(3, 30))) for _ in range(300)]
    a, b = tbm25.LexicalIndex(), jbm25.LexicalIndex()
    for i, d in enumerate(docs):
        a.add_chunk(f"c{i}", d, i)
        b.add_chunk(f"c{i}", d, i)
    for i in range(0, 300, 7):
        a.remove_chunk(f"c{i}")
        b.remove_chunk(f"c{i}")
    for q in ("pump seal", "rotor gasket flow", "unknown words here", "motor motor"):
        assert a.score(q, 50) == b.score(q, 50)
        assert a.unseen_mass(q) == b.unseen_mass(q)
        sa, va = np.full(64, -1, np.int32), np.zeros(64, np.float32)
        sb, vb = np.full(64, -1, np.int32), np.zeros(64, np.float32)
        assert a.score_slots_into(q, 64, sa, va) == b.score_slots_into(q, 64, sb, vb)
        np.testing.assert_array_equal(sa, sb)
        np.testing.assert_array_equal(va, vb)


def test_asset_exists():
    assert os.path.exists(TOK_JSON)
