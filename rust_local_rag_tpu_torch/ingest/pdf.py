"""PDF text extraction with the JAX package's tiered strategy (copy of
rust_local_rag_tpu/ingest/pdf.py).

The reference tries a pure-Rust extractor (lopdf) first and falls back to the
`pdftotext` binary (rag_engine.rs:949-1090). Here tier 0 is the native C++
extractor (csrc/pdftext.cpp, a copy of native/pdftext.cpp built with g++ by
kernels/build.py; byte-identical output to tier 1), tier 1 the built-in
pure-Python extractor (an xref-free object scan, FlateDecode, the
content-stream text operators), and tier 2 shells out to
`pdftotext -layout -enc UTF-8` when the binary exists.

RAG_TPU_NATIVE_PDF=0 (or false) turns tier 0 off. Otherwise a library that
fails to build or load raises, as the native BM25 index does: the JAX
package's quiet `_NATIVE_BROKEN` path, which goes on without the native
tier, is not copied. A non-zero return code of the native call, or text
that is not UTF-8, falls through to tier 1, as in the JAX package.

Pages are emitted in page-tree order separated by form feed (\\f), which
the chunker uses for 1-based page numbers.
"""

from __future__ import annotations

import ctypes
import logging
import os
import re
import shutil
import subprocess
import tempfile
import uuid
import zlib
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class PdfExtractionError(Exception):
    pass


def extract_pdf_text(data: bytes) -> str:
    """Tiered extraction; raises PdfExtractionError when every tier fails."""
    native = _native_extract(data)
    if native is not None and native.strip():
        return native
    try:
        text = _builtin_extract(data)
        if text.strip():
            logger.info("PDF extracted using built-in backend: %d chars", len(text))
            return text
        builtin_err: Optional[Exception] = PdfExtractionError("built-in extractor produced no text")
    except Exception as e:  # noqa: BLE001 — any parse failure falls through
        builtin_err = e
        logger.warning("Built-in PDF extraction failed: %s; trying pdftotext", e)

    try:
        text = _pdftotext_extract(data)
        logger.info("PDF extracted using pdftotext fallback: %d chars", len(text))
        return text
    except Exception as pdftotext_err:
        raise PdfExtractionError(
            f"PDF extraction failed: built-in error: {builtin_err}, "
            f"pdftotext error: {pdftotext_err}"
        ) from pdftotext_err


# ---- native tier ---------------------------------------------------------


def native_enabled() -> bool:
    return os.environ.get("RAG_TPU_NATIVE_PDF", "1") not in ("0", "false")


def _native_extract(data: bytes) -> Optional[str]:
    """Tier-0 native extraction; None when the tier is off, or when the
    call returns non-zero or non-UTF-8 text (the caller falls back to the
    pure-Python tier, which reports the real parse error). A library that
    does not build or load raises."""
    if not native_enabled():
        return None
    from rust_local_rag_tpu_torch.kernels import build

    lib = build.load("pdftext")
    out = ctypes.c_char_p()
    out_len = ctypes.c_int64()
    rc = lib.pdf_extract_text(data, len(data), ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        return None
    try:
        raw = ctypes.string_at(out, out_len.value)
    finally:
        lib.pdf_free_text(out)
    try:
        text = raw.decode("utf-8")
    except UnicodeDecodeError:
        return None
    logger.info("PDF extracted using native backend: %d chars", len(text))
    return text


def _pdftotext_extract(data: bytes) -> str:
    """pdftotext subprocess path (rag_engine.rs:1044-1090). UUID temp names
    prevent collisions between concurrent extractions."""
    if shutil.which("pdftotext") is None:
        raise PdfExtractionError("pdftotext binary not found (is poppler installed?)")
    tmp = os.path.join(tempfile.gettempdir(), f"temp_pdf_{uuid.uuid4()}.pdf")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        proc = subprocess.run(
            ["pdftotext", "-layout", "-enc", "UTF-8", tmp, "-"],
            capture_output=True,
            timeout=120,
        )
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    if proc.returncode != 0:
        raise PdfExtractionError(f"pdftotext failed: {proc.stderr.decode('utf-8', 'replace')}")
    text = proc.stdout.decode("utf-8", "replace")
    if not text.strip():
        raise PdfExtractionError("pdftotext produced no text output")
    return text


# --------------------------------------------------------------------------
# Built-in extractor
# --------------------------------------------------------------------------

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b", re.S)
_STREAM_RE = re.compile(rb"stream\r?\n")


def _builtin_extract(data: bytes) -> str:
    objects = _scan_objects(data)
    if not objects:
        raise PdfExtractionError("no PDF objects found")

    page_ids = _page_order(objects)
    if not page_ids:
        # fall back to any object that has /Contents
        page_ids = [
            num
            for num, (body, _) in objects.items()
            if b"/Contents" in body and b"/Type" in body and b"/Page" in body
        ]
    if not page_ids:
        raise PdfExtractionError("no pages found")

    pages: List[str] = []
    for pid in page_ids:
        body, _ = objects[pid]
        content = b"".join(
            _object_stream(objects, ref) for ref in _content_refs(body)
        )
        pages.append(_content_text(content))

    text = "\f".join(pages)
    if not text.strip():
        raise PdfExtractionError("extractor produced no text")
    return text


def _scan_objects(data: bytes) -> Dict[int, Tuple[bytes, Optional[bytes]]]:
    """Map object number -> (body bytes, raw stream bytes or None)."""
    objects: Dict[int, Tuple[bytes, Optional[bytes]]] = {}
    for m in _OBJ_RE.finditer(data):
        num = int(m.group(1))
        start = m.end()
        end = data.find(b"endobj", start)
        if end == -1:
            continue
        body = data[start:end]
        stream: Optional[bytes] = None
        sm = _STREAM_RE.search(body)
        if sm:
            s_start = sm.end()
            s_end = body.rfind(b"endstream")
            if s_end != -1:
                stream = body[s_start:s_end]
                # strip one trailing EOL that belongs to the stream keyword
                if stream.endswith(b"\n"):
                    stream = stream[:-1]
                if stream.endswith(b"\r"):
                    stream = stream[:-1]
            body = body[: sm.start()]
        objects[num] = (body, stream)
    return objects


def _find_ref(body: bytes, key: bytes) -> Optional[int]:
    m = re.search(re.escape(key) + rb"\s+(\d+)\s+\d+\s+R", body)
    return int(m.group(1)) if m else None


def _find_refs_array(body: bytes, key: bytes) -> List[int]:
    m = re.search(re.escape(key) + rb"\s*\[(.*?)\]", body, re.S)
    if not m:
        single = _find_ref(body, key)
        return [single] if single is not None else []
    return [int(g) for g in re.findall(rb"(\d+)\s+\d+\s+R", m.group(1))]


def _page_order(objects: Dict[int, Tuple[bytes, Optional[bytes]]]) -> List[int]:
    """Walk the page tree (Catalog -> Pages -> Kids) for document order."""
    root: Optional[int] = None
    for num, (body, _) in objects.items():
        if b"/Type" in body and b"/Catalog" in body:
            root = _find_ref(body, b"/Pages")
            break
    order: List[int] = []

    def walk(node: Optional[int], depth: int = 0) -> None:
        if node is None or node not in objects or depth > 64:
            return
        body, _ = objects[node]
        if b"/Page" in body and b"/Pages" not in body and b"/Kids" not in body:
            order.append(node)
            return
        for kid in _find_refs_array(body, b"/Kids"):
            walk(kid, depth + 1)

    walk(root)
    return order


def _content_refs(page_body: bytes) -> List[int]:
    return _find_refs_array(page_body, b"/Contents")


def _object_stream(
    objects: Dict[int, Tuple[bytes, Optional[bytes]]], num: int
) -> bytes:
    if num not in objects:
        return b""
    body, stream = objects[num]
    if stream is None:
        return b""
    if b"/FlateDecode" in body:
        try:
            return zlib.decompress(stream)
        except zlib.error:
            # some writers pad the stream; try truncating to /Length
            m = re.search(rb"/Length\s+(\d+)", body)
            if m:
                try:
                    return zlib.decompress(stream[: int(m.group(1))])
                except zlib.error:
                    return b""
            return b""
    return stream


# ----- content-stream text interpretation ---------------------------------

_TOKEN_RE = re.compile(
    rb"\((?:\\.|[^\\()])*\)"  # literal string (with escapes)
    rb"|<[0-9A-Fa-f\s]*>"  # hex string
    rb"|\[|\]"
    rb"|[A-Za-z'\"*]+"  # operator
    rb"|[-+]?[0-9]*\.?[0-9]+"  # number
    rb"|/[^\s\[\]()<>/]*",  # name
    re.S,
)

_ESCAPES = {
    b"n": b"\n",
    b"r": b"\r",
    b"t": b"\t",
    b"b": b"\b",
    b"f": b"\f",
    b"(": b"(",
    b")": b")",
    b"\\": b"\\",
}


def _decode_literal(tok: bytes) -> str:
    inner = tok[1:-1]
    out = bytearray()
    i = 0
    while i < len(inner):
        c = inner[i : i + 1]
        if c == b"\\" and i + 1 < len(inner):
            nxt = inner[i + 1 : i + 2]
            if nxt in _ESCAPES:
                out += _ESCAPES[nxt]
                i += 2
                continue
            if nxt.isdigit():  # octal escape, up to 3 digits
                j = i + 1
                oct_digits = b""
                while j < len(inner) and len(oct_digits) < 3 and inner[j : j + 1].isdigit():
                    oct_digits += inner[j : j + 1]
                    j += 1
                out.append(int(oct_digits, 8) & 0xFF)
                i = j
                continue
            i += 1
            continue
        out += c
        i += 1
    return out.decode("latin-1")


def _decode_hex(tok: bytes) -> str:
    hexstr = re.sub(rb"\s", b"", tok[1:-1])
    if len(hexstr) % 2:
        hexstr += b"0"
    raw = bytes.fromhex(hexstr.decode("ascii"))
    # Heuristic: UTF-16BE (BOM or even-length with many NUL highs) vs latin-1
    if raw[:2] == b"\xfe\xff":
        return raw[2:].decode("utf-16-be", "replace")
    if len(raw) >= 2 and raw[0] == 0:
        try:
            return raw.decode("utf-16-be")
        except UnicodeDecodeError:
            pass
    return raw.decode("latin-1")


def _content_text(content: bytes) -> str:
    """Interpret text-showing operators: Tj, ', \", TJ; line breaks on
    Td/TD/T*; space handling for TJ kerning gaps."""
    parts: List[str] = []
    stack: List[object] = []
    in_array: List[object] = []
    array_mode = False

    for m in _TOKEN_RE.finditer(content):
        tok = m.group(0)
        if tok == b"[":
            array_mode = True
            in_array = []
        elif tok == b"]":
            array_mode = False
            stack.append(in_array)
        elif tok.startswith(b"("):
            val = _decode_literal(tok)
            (in_array if array_mode else stack).append(val)
        elif tok.startswith(b"<"):
            val = _decode_hex(tok)
            (in_array if array_mode else stack).append(val)
        elif re.fullmatch(rb"[-+]?[0-9]*\.?[0-9]+", tok):
            (in_array if array_mode else stack).append(float(tok))
        elif tok.startswith(b"/"):
            (in_array if array_mode else stack).append(tok)
        else:
            op = tok
            if op == b"Tj" or op == b"'":
                if stack and isinstance(stack[-1], str):
                    parts.append(stack[-1])
                if op == b"'":
                    parts.append("\n")
            elif op == b'"':
                if stack and isinstance(stack[-1], str):
                    parts.append(stack[-1])
                parts.append("\n")
            elif op == b"TJ":
                if stack and isinstance(stack[-1], list):
                    for item in stack[-1]:
                        if isinstance(item, str):
                            parts.append(item)
                        elif isinstance(item, float) and item < -180:
                            parts.append(" ")  # large kern gap == space
            elif op in (b"Td", b"TD", b"T*"):
                parts.append("\n")
            elif op == b"ET":
                parts.append("\n")
            stack = []
    text = "".join(parts)
    # collapse runs of blank-ish lines but preserve paragraph structure
    text = re.sub(r"[ \t]+\n", "\n", text)
    return text
