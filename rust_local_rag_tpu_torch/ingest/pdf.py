"""Built-in PDF text extraction.

Copy of the pure-Python tier of rust_local_rag_tpu/ingest/pdf.py: an
xref-free object scan, FlateDecode, and the content-stream text operators.
Pages are emitted in page-tree order separated by form feed (\\f), which
the chunker uses for 1-based page numbers. The native C++ tier and the
``pdftotext`` tier of the JAX package are not part of this port yet.
"""

from __future__ import annotations

import re
import zlib
from typing import Dict, List, Optional, Tuple


class PdfExtractionError(Exception):
    pass


def extract_pdf_text(data: bytes) -> str:
    """Text of every page, pages separated by form feed; raises
    PdfExtractionError when the document yields no text."""
    return _builtin_extract(data)


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
