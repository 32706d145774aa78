"""The port's PDF tiers (rust_local_rag_tpu_torch/ingest/pdf.py) against the
JAX package's (rust_local_rag_tpu/ingest/pdf.py): tests/test_native_pdf.py's
parity cases run through the port's native tier (csrc/pdftext.cpp, built
with g++ here), the port's built-in tier and the JAX built-in tier, which
must give the same text, byte for byte. Then the tier order:
RAG_TPU_NATIVE_PDF=0 skips the native tier, a failed build raises (no quiet
fallback, unlike the JAX package), and a `pdftotext` on PATH (a stub here:
the test needs no poppler) takes over when the built-in tier fails, with the
same text and the same errors in both packages."""

import os
import stat
import zlib

import pytest

import pdfgen
from eval_harness.corpus import _ascii, _make_pdf, load_distractors
from eval_harness.corpus_data import DOCS
from rust_local_rag_tpu.ingest import pdf as J
from rust_local_rag_tpu_torch.ingest import pdf as P
from rust_local_rag_tpu_torch.kernels import build
from test_native_pdf import _raw_pdf


def _flate_padded():
    comp = zlib.compress(b"BT (padded stream) Tj ET") + b"\x00\x00garbage"
    return (b"1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj\n"
            b"2 0 obj << /Type /Pages /Kids [3 0 R] >> endobj\n"
            b"3 0 obj << /Type /Page /Contents 4 0 R >> endobj\n"
            b"4 0 obj << /Filter /FlateDecode /Length " + str(len(comp) - 9).encode() + b" >>\nstream\n"
            + comp + b"\nendstream endobj\n")


CASES = {
    "simple_pages": lambda: pdfgen.make_pdf(["Hello world.", "Second page."]),
    "compressed_streams": lambda: pdfgen.make_pdf(["Flate page one.", "Flate page two."], compress=True),
    "multiline_paragraphs": lambda: pdfgen.make_pdf(["Para one line.\n\nPara two line.\n\nPara three.",
                                                     "Second page with\n\nmore paragraphs."]),
    "escapes_in_literals": lambda: _raw_pdf(
        rb"BT (Tab\there) Tj (paren \( close \)) Tj (octal \101\102\103 end) Tj (back\\slash) Tj "
        rb"(newline\nin string) Tj (lone \q escape) Tj ET"),
    "hex_strings": lambda: _raw_pdf(b"BT <48656C6C6F> Tj <FEFF00480069> Tj <00480065006C006C006F> Tj <4 86> Tj ET"),
    "tj_array_kerning": lambda: _raw_pdf(b"BT [(Hel) -50 (lo) -300 (world)] TJ ET"),
    "quote_operators_and_td": lambda: _raw_pdf(
        b"BT (line one) ' (line two) Tj 0 -14 Td (line three) Tj T* 1.5 2.5 TD (line four) Tj ET"),
    "latin1_high_bytes": lambda: _raw_pdf(b"BT (caf\xe9 na\xefve \xb5m) Tj ET"),
    "nested_unescaped_paren": lambda: _raw_pdf(b"BT (a(b) Tj (clean) Tj ET"),
    "page_scan_without_catalog": lambda: (
        b"3 0 obj << /Type /Page /Contents 4 0 R >> endobj\n"
        b"4 0 obj << /Length 20 >>\nstream\nBT (orphan page) Tj ET\nendstream endobj\n"),
    "duplicate_object_last_wins": lambda: (
        b"1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj\n"
        b"2 0 obj << /Type /Pages /Kids [3 0 R] >> endobj\n"
        b"3 0 obj << /Type /Page /Contents 4 0 R >> endobj\n"
        b"4 0 obj << >>\nstream\nBT (first version) Tj ET\nendstream endobj\n"
        b"4 0 obj << >>\nstream\nBT (second version) Tj ET\nendstream endobj\n"),
    "flate_with_padding_and_length": _flate_padded,
}


def three(data: bytes):
    return P._native_extract(data), P._builtin_extract(data), J._builtin_extract(data)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_builtin_and_jax_agree(case):
    nat, py, jx = three(CASES[case]())
    assert nat == py == jx
    assert P.extract_pdf_text(CASES[case]()) == J._builtin_extract(CASES[case]())


def test_expected_texts():
    assert "Hello world" in P._native_extract(CASES["tj_array_kerning"]())
    assert "café" in P._native_extract(CASES["latin1_high_bytes"]())
    assert "second version" in P._native_extract(CASES["duplicate_object_last_wins"]())


@pytest.mark.parametrize("i", range(len(DOCS)))
def test_eval_corpus_parity(i):
    data = _make_pdf([_ascii(p) for p in DOCS[i]["pages"]])
    nat, py, jx = three(data)
    assert nat == py == jx and nat.strip()


def test_distractor_parity():
    docs = load_distractors()
    assert docs
    for d in docs:
        data = _make_pdf([_ascii(p) for p in d["pages"]])
        nat, py, jx = three(data)
        assert nat == py == jx


def test_garbage_is_refused_by_every_tier():
    assert P._native_extract(b"not a pdf at all") is None
    with pytest.raises(P.PdfExtractionError):
        P._builtin_extract(b"not a pdf at all")


def test_native_tier_short_circuits(monkeypatch):
    called = []
    monkeypatch.setattr(P, "_builtin_extract", lambda data: called.append(1))
    assert "Tier zero text." in P.extract_pdf_text(pdfgen.make_pdf(["Tier zero text."]))
    assert not called


@pytest.mark.parametrize("value", ["0", "false"])
def test_env_disables_native(monkeypatch, value):
    monkeypatch.setenv("RAG_TPU_NATIVE_PDF", value)
    monkeypatch.setattr(build, "load", lambda name: pytest.fail(f"loaded {name} with the native tier off"))
    data = pdfgen.make_pdf(["x marks the spot"])
    assert P._native_extract(data) is None
    assert P.extract_pdf_text(data) == J._builtin_extract(data)


def test_failed_build_raises(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "pdftext.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="pdftext.cpp failed"):
        P.extract_pdf_text(pdfgen.make_pdf(["no quiet fallback"]))
    monkeypatch.setenv("RAG_TPU_NATIVE_PDF", "0")
    assert "no quiet fallback" in P.extract_pdf_text(pdfgen.make_pdf(["no quiet fallback"]))


def test_native_nonzero_return_falls_through(monkeypatch):
    """A PDF with objects but no page: the native call returns 2 and the
    built-in tier reports the error (and pdftotext, absent, its own)."""
    monkeypatch.setenv("PATH", "")
    data = b"1 0 obj << /Type /Catalog >> endobj\n"
    assert P._native_extract(data) is None
    with pytest.raises(P.PdfExtractionError) as a:
        P.extract_pdf_text(data)
    with pytest.raises(J.PdfExtractionError) as b:
        J.extract_pdf_text(data)
    assert str(a.value) == str(b.value)
    assert "no pages found" in str(a.value) and "pdftotext binary not found" in str(a.value)


# ----------------------------------------------------------- pdftotext ----


def stub(tmp_path, script: str):
    """A `pdftotext` on PATH: a shell script that checks its arguments."""
    d = tmp_path / "bin"
    d.mkdir()
    p = d / "pdftotext"
    p.write_text("#!/bin/sh\n" + script)
    p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return str(d)


ARGS_OK = ('[ "$1 $2 $3 $5" = "-layout -enc UTF-8 -" ] || { echo "bad args: $*" >&2; exit 9; }\n'
           'case "$(basename "$4")" in temp_pdf_*.pdf) ;; *) echo "bad name $4" >&2; exit 8;; esac\n'
           '[ -f "$4" ] || { echo "no file $4" >&2; exit 7; }\n')


@pytest.mark.parametrize("script,want", [
    (ARGS_OK + 'printf "Page one via poppler\\n\\fPage two\\n"\n', "Page one via poppler\n\fPage two\n"),
    (ARGS_OK + 'echo "broken xref" >&2; exit 1\n', "pdftotext failed: broken xref"),
    (ARGS_OK + 'printf "  \\n"\n', "pdftotext produced no text output"),
])
def test_pdftotext_tier_equal_jax(tmp_path, monkeypatch, script, want):
    monkeypatch.setenv("PATH", stub(tmp_path, script) + os.pathsep + os.environ.get("PATH", ""))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    data = b"%PDF-1.4 but nothing a scan can read"
    outs = []
    for mod in (P, J):
        try:
            outs.append(("text", mod.extract_pdf_text(data)))
        except mod.PdfExtractionError as e:
            outs.append(("error", str(e)))
    assert outs[0] == outs[1]
    assert want in outs[0][1]
    assert not [f for f in os.listdir(tmp_path) if f.startswith("temp_pdf_")]  # the temporary file is removed
