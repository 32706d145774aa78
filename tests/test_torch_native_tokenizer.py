"""The port's native WordPiece tokenizer (csrc/wordpiece.cpp through
models/native_tokenizer.NativeWordPieceTokenizer) against the port's
pure-Python WordPieceTokenizer and the JAX package's HuggingFace
tokenizer (and its native one where its library is built), on the
committed tokenizer.json.

Every comparison is exact: ids and masks are integers, and the combined
tokenizer must give the pure-Python ids on every input (the texts outside
the kernel's envelope are routed to the pure-Python tokenizer).
"""

import random
import string

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch  # noqa: F401

from rust_local_rag_tpu.models import native_tokenizer as jnative
from rust_local_rag_tpu.models.tokenizer import HfTokenizer
from rust_local_rag_tpu_torch.kernels import build
from rust_local_rag_tpu_torch.models import tokenizer as ttok
from rust_local_rag_tpu_torch.models.encoder import default_asset
from rust_local_rag_tpu_torch.models.native_tokenizer import (
    _FALLBACK_RE,
    NativeWordPieceTokenizer,
    outside_envelope,
)

TOK_JSON = default_asset("tokenizer.json")

EDGE = [
    "",
    " ",
    "\t\n\r\v\f",
    "hello, world! 3.14",
    "yes", "Yes YES yEs", "bayesian eyes yesterday", "yesyes eyesore no", "yes" * 200,
    "foo [CLS] bar", "[PAD][UNK][CLS][SEP][MASK]", "[cls] not special",
    "naïve café étude", "Ω ≈ 3.14 → done", "dash — en–dash “quotes”",
    "a" * 63, "a" * 64, "a" * 65, "x" * 200,
    "fn main() { println!(\"{}\", x_1 + y._2); } // #[derive(Debug)]",
    "a-b_c.d,e;f:g!h?i", "don't can't won't", "...---...",
    "0x7f 1e-9 v2.6.1 100%", "CamelCase UPPERCASE lowercase",
    "tabs\tand\nnewlines\r\nand\x0bvertical\x0cfeeds", "\x1c\x1d control \x00 bytes \x7f",
    "Replace the pump seal (see Fig. 3). Is the answer yes or no?",
]


@pytest.fixture(scope="module")
def toks():
    """(native, pure-Python, JAX HuggingFace) over the committed asset."""
    return NativeWordPieceTokenizer(TOK_JSON), ttok.WordPieceTokenizer(TOK_JSON), HfTokenizer(TOK_JSON)


def _fuzz(seed: int, n: int):
    rng = random.Random(seed)
    ascii_pool = string.ascii_letters + string.digits + string.punctuation + " \t\n" + " " * 20
    uni_pool = ascii_pool + "éüñßλ中文🙂—“"
    out = []
    for i in range(n):
        pool = ascii_pool if i % 3 else uni_pool
        out.append("".join(rng.choice(pool) for _ in range(rng.randint(0, 200))))
    return out


@pytest.mark.parametrize("text", EDGE)
def test_tokenize_edge_cases(toks, text):
    nat, py, hf = toks
    assert nat.tokenize(text) == py.tokenize(text) == hf.tokenize(text)


def test_tokenize_fuzz(toks):
    nat, py, hf = toks
    for text in _fuzz(20261017, 400):
        assert nat.tokenize(text) == py.tokenize(text) == hf.tokenize(text), repr(text)


def test_matches_jax_native_tokenizer(toks):
    """The JAX package's native tokenizer (the same C++ source) where its
    library is built."""
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built")
    nat = toks[0]
    jn = jnative.NativeWordPieceTokenizer(TOK_JSON)
    texts = EDGE + _fuzz(5, 100)
    for text in texts:
        assert nat.tokenize(text) == jn.tokenize(text), repr(text)
    for a, b in zip(nat.encode_batch(texts), jn.encode_batch(texts)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_len", [512, 100])
def test_encode_batch_mixed_routing_and_truncation(max_len):
    """One batch mixing native and routed texts gives the pure-Python
    (ids, mask): same bucket, same [PAD] padding, same rows, truncated at
    max_len (100 is below its 128 bucket)."""
    nat = NativeWordPieceTokenizer(TOK_JSON, max_len=max_len)
    py = ttok.WordPieceTokenizer(TOK_JSON, max_len=max_len)
    hf = HfTokenizer(TOK_JSON, max_len=max_len)
    for texts in (EDGE + [f"plain ascii row {i} with words" for i in range(17)],
                  ["word " * 2000, "short"], ["short", "naïve"], ["only ascii here"]):
        a, b, c = nat.encode_batch(texts), py.encode_batch(texts), hf.encode_batch(texts)
        assert a[0].shape == b[0].shape == c[0].shape
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    assert nat.tokenize("word " * 2000) == py.tokenize("word " * 2000)
    assert len(nat.tokenize("word " * 2000)) == max_len


@pytest.mark.parametrize("seq_len", [64, 192])
def test_encode_batch_headtail(toks, seq_len):
    """The judge's head/tail packing: rows longer than the kernel's buffer
    (max(1024, 2 seq_len) ids) are routed and keep their true tail."""
    nat, py, hf = toks
    texts = EDGE + ["word%d " % i * 300 for i in range(3)] + ["alpha beta gamma " * 700]
    a, b, c = nat.encode_batch_headtail(texts, seq_len), py.encode_batch_headtail(texts, seq_len), \
        hf.encode_batch_headtail(texts, seq_len)
    for x, y, z in zip(a, b, c):
        assert x.shape == (len(texts), seq_len)
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)


def test_envelope_test_equals_the_routing_regex():
    """outside_envelope is the JAX package's routing regex, decided in
    cheaper parts: the same answer on every edge case and fuzzed text
    (control bytes, DEL, non-ASCII and bracketed specials among them)."""
    rng = random.Random(3)
    pool = string.printable + "\x00\x07\x08\x0e\x1f\x7f\x80é[]" + "[CLS]" * 3
    texts = EDGE + _fuzz(9, 300) + ["".join(rng.choice(pool) for _ in range(rng.randint(0, 60))) for _ in range(2000)]
    for t in texts + [chr(c) for c in range(256)] + ["[PAD]", "[pad]", "[MASK", "x[SEP]y"]:
        assert outside_envelope(t) == bool(_FALLBACK_RE.search(t)) == bool(jnative._FALLBACK_RE.search(t)), repr(t)


def test_routing_counts():
    """routed_texts counts each text sent to the pure-Python tokenizer."""
    nat = NativeWordPieceTokenizer(TOK_JSON)
    assert nat.routed_texts == 0
    nat.tokenize("plain ascii")
    nat.encode_batch(["plain", "also plain"])
    assert nat.routed_texts == 0
    nat.tokenize("naïve")
    nat.tokenize("[CLS] literal")
    nat.encode_batch(["plain", "café", "tab\tok", "bell\x07"])
    assert nat.routed_texts == 4
    nat.encode_batch_headtail(["short", "Ω", "long " * 1500], 192)  # non-ASCII, and past the buffer
    assert nat.routed_texts == 6


def test_no_silent_fallback(monkeypatch):
    """With RAG_TPU_NATIVE_TOKENIZER unset a failed build raises; =0 picks
    the pure-Python tokenizer."""
    def failed(name):
        raise RuntimeError(f"building {name} failed")

    monkeypatch.delenv("RAG_TPU_NATIVE_TOKENIZER", raising=False)
    monkeypatch.setattr(build, "load", failed)
    with pytest.raises(RuntimeError, match="wordpiece"):
        ttok.load_tokenizer(TOK_JSON)
    monkeypatch.setenv("RAG_TPU_NATIVE_TOKENIZER", "0")
    assert type(ttok.load_tokenizer(TOK_JSON)) is ttok.WordPieceTokenizer
