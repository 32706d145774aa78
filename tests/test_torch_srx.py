"""The port's SRX ruleset mode (rust_local_rag_tpu_torch/ingest/srx.py, hooked
into ingest/chunking.split_sentences) against the JAX package's: the
engine's cases of tests/test_srx_engine.py run through both packages, then
the mode itself: with RAG_TPU_SRX_FILE naming a ruleset, the port's
split_sentences and chunk_text must give what the JAX package gives on the
same seeded texts (ROADMAP C11: the port used to ignore the variable), and
both fall back to the built-in splitter, with a log line, without the
`regex` module or with a file that does not load. Results are compared
exactly: both packages run the same Python on the same strings."""

import dataclasses
import logging
import os

import numpy as np
import pytest

from rust_local_rag_tpu.ingest import chunking as jchunking
from rust_local_rag_tpu.ingest import srx as jsrx
from rust_local_rag_tpu_torch.ingest import chunking
from rust_local_rag_tpu_torch.ingest import srx
from test_srx_engine import _MINI, _REF_SRX

# the sentences the seeded texts are drawn from: abbreviations the _MINI
# ruleset guards ("Mr. ") and ones it does not ("Prof.", "p.m.", "M. ",
# "e.g."), the built-in splitter's classes, and plain sentences
PARTS = [
    "Prof. Smith arrived at 3 p.m. today.", "Mr. Jones left early.", "She stayed!", "Why not?",
    "M. Dupont signed the contract.", "Values rose by 3.5 percent.", "The file is config.yaml here.",
    "We tried e.g. apples and pears.", "Dr. Who came back.", "It trailed off... and resumed.",
    "The results (see Fig. 3) held.", "Acme Inc. hired twelve people.", "Then they fell.",
    "Sentence one.", "Sentence two.", "Is it done? Yes.",
]


def seeded_texts(seed: int, n: int = 12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pages = []
        for _ in range(int(rng.integers(1, 4))):
            paras = [" ".join(rng.choice(PARTS, size=int(rng.integers(2, 9)))) for _ in range(int(rng.integers(1, 4)))]
            pages.append("\n\n".join(paras))
        out.append("\f".join(pages))
    return out


def fragments(frags):
    return [dataclasses.asdict(f) for f in frags]


@pytest.fixture
def mini(tmp_path, monkeypatch):
    path = tmp_path / "mini.srx"
    path.write_text(_MINI, encoding="utf-8")
    monkeypatch.setenv("RAG_TPU_SRX_FILE", str(path))
    monkeypatch.delenv("RAG_TPU_SRX_LANGUAGE", raising=False)
    return str(path)


# ------------------------------------------------ the engine's cases ----


def both_rules(code, anchored=False):
    return (srx.SRX.from_str(_MINI).language_rules(code, anchored=anchored),
            jsrx.SRX.from_str(_MINI).language_rules(code, anchored=anchored))


@pytest.mark.parametrize("code,anchored,want", [("English", False, 2), ("unfree", False, 3), ("unfree", True, 2),
                                                ("fr-CA", False, 3), ("x", True, 2)])
def test_language_resolution(code, anchored, want):
    """The cascade concatenates in map order; unanchored matching is the
    srx crate's ("unfree" holds "fr"); anchored needs a whole match."""
    a, b = both_rules(code, anchored)
    assert len(a) == len(b) == want
    assert [r.brk for r in a.rules] == [r.brk for r in b.rules]
    assert a.skipped == b.skipped == 0


@pytest.mark.parametrize("text,want", [
    ("Mr. Smith left. She stayed.", ["Mr. Smith left. ", "She stayed."]),
    ("One. Two! Three? Mr. Four.", ["One. ", "Two! ", "Three? ", "Mr. Four."]),
    ("", []),
    ("no break here", ["no break here"]),
])
def test_first_match_wins(text, want):
    a, b = both_rules("x")
    assert a.split(text) == b.split(text) == want
    assert "".join(a.split(text)) == text


@pytest.mark.parametrize("pattern,want", [
    (r"\b[a-z[^abc]]\.", r"\b(?:[a-z]|[^abc])\."),
    (r"[^xy[abc]]", r"(?:[^xy]|[abc])"),
    (r"[\.!?…]['\"]*\s", r"[\.!?…]['\"]*\s"),
    (r"\p{Lu}[^\p{Lu}]", r"\p{Lu}[^\p{Lu}]"),
    (r"a[bc]d", r"a[bc]d"),
    (r"[a[b]", r"[a[b]"),
])
def test_java_class_union_shim(pattern, want):
    assert srx._shim_java_class_union(pattern) == jsrx._shim_java_class_union(pattern) == want


# ---------------------------------------------------- the mode (C11) ----


def test_c11_issue_example(mini):
    """The text of ROADMAP C11: JAX splits "Prof." off, the port used to
    keep it joined."""
    text = ("Prof. Smith arrived at 3 p.m. today. Mr. Jones left early. She stayed! Why not? M. Dupont signed "
            "the contract. Values rose by 3.5 percent. The file is config.yaml here. We tried e.g. apples.")
    got = chunking.split_sentences(text)
    assert got == jchunking.split_sentences(text)
    assert got[:3] == ["Prof.", "Smith arrived at 3 p.m.", "today."]
    assert got != _builtin(chunking, text)


def _builtin(module, text):
    old = os.environ.pop("RAG_TPU_SRX_FILE", None)
    try:
        return module.split_sentences(text)
    finally:
        if old is not None:
            os.environ["RAG_TPU_SRX_FILE"] = old


@pytest.mark.parametrize("seed", range(6))
def test_split_sentences_equal_jax_under_srx(mini, seed):
    for text in seeded_texts(seed):
        assert chunking.split_sentences(text) == jchunking.split_sentences(text)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("budget", [12, 60, 200])
def test_chunk_text_equal_jax_under_srx(mini, seed, budget):
    for text in seeded_texts(seed):
        assert fragments(chunking.chunk_text(text, budget)) == fragments(jchunking.chunk_text(text, budget))


@pytest.mark.parametrize("language", ["English", "unfree", "fr"])
def test_language_variable_equal_jax(mini, monkeypatch, language):
    monkeypatch.setenv("RAG_TPU_SRX_LANGUAGE", language)
    text = "M. Dupont signed. Mr. Jones left. She stayed."
    assert chunking.split_sentences(text) == jchunking.split_sentences(text)
    assert len(srx.load_segmenter()) == len(jsrx.load_segmenter())


def test_env_gates_segmenter(monkeypatch):
    monkeypatch.delenv("RAG_TPU_SRX_FILE", raising=False)
    assert srx.load_segmenter() is None and jsrx.load_segmenter() is None


def test_segmenter_cache_follows_the_environment(mini, monkeypatch):
    first = srx.load_segmenter()
    assert first is not None and srx.load_segmenter() is first
    monkeypatch.delenv("RAG_TPU_SRX_FILE")
    assert srx.load_segmenter() is None


# ------------------------------------------------------- fallbacks ----


def test_without_regex_both_take_the_builtin_splitter(mini, monkeypatch, caplog):
    monkeypatch.setattr(srx, "_HAVE_REGEX", False)
    monkeypatch.setattr(jsrx, "_HAVE_REGEX", False)
    monkeypatch.setattr(srx, "_WARNED_NO_REGEX", False)
    with caplog.at_level(logging.WARNING, logger=srx.logger.name):
        assert srx.load_segmenter() is None and jsrx.load_segmenter() is None
        assert srx.load_segmenter() is None
    # the port says so, once; the JAX package says nothing
    assert [r.getMessage() for r in caplog.records if r.name == srx.logger.name] == [
        "SRX: RAG_TPU_SRX_FILE is set but the regex module is missing; using the built-in splitter"]
    for text in seeded_texts(7, 4):
        got = chunking.split_sentences(text)
        assert got == jchunking.split_sentences(text) == _builtin(chunking, text)


@pytest.mark.parametrize("content", [None, "<srx><not closed", "<?xml version='1.0'?><other/>"])
def test_file_that_does_not_load_falls_back_with_a_log_line(tmp_path, monkeypatch, caplog, content):
    path = tmp_path / "broken.srx"
    if content is not None:
        path.write_text(content, encoding="utf-8")
    monkeypatch.setenv("RAG_TPU_SRX_FILE", str(path))
    text = "Prof. Smith arrived at 3 p.m. today. Mr. Jones left early."
    with caplog.at_level(logging.INFO):
        got = chunking.split_sentences(text)
        want = jchunking.split_sentences(text)
    assert got == want
    port_lines = [r for r in caplog.records if r.name == srx.logger.name]
    jax_lines = [r for r in caplog.records if r.name == jsrx.logger.name]
    if content is None or content.startswith("<srx><not"):
        assert got == _builtin(chunking, text)
        assert [r.levelno for r in port_lines] == [r.levelno for r in jax_lines] == [logging.WARNING]
        assert port_lines[0].getMessage() == jax_lines[0].getMessage()
    else:
        # a well-formed document without rules loads an empty rule list:
        # no break anywhere, in both packages
        assert got == [text]


# ------------------------------------- the full ruleset (not present) ----


full_ruleset = pytest.mark.skipif(not os.path.exists(_REF_SRX), reason="reference ruleset not present")


@full_ruleset
@pytest.mark.parametrize("text", ["Sentence one. Sentence two. Sentence three!",
                                  "Visit www.example.com for info. Email me at a@b.com.",
                                  "He said e.g. apples are good. I agree.", "Dr. Smith arrived. All stood."])
def test_full_ruleset_equal_jax(text):
    a = srx.SRX.from_file(_REF_SRX).language_rules("English")
    b = jsrx.SRX.from_file(_REF_SRX).language_rules("English")
    assert len(a) == len(b) == 233 and a.skipped == b.skipped == 0
    assert a.split(text) == b.split(text)


@full_ruleset
def test_full_ruleset_chunking_equal_jax(monkeypatch):
    monkeypatch.setenv("RAG_TPU_SRX_FILE", _REF_SRX)
    for text in seeded_texts(11):
        assert fragments(chunking.chunk_text(text)) == fragments(jchunking.chunk_text(text))
