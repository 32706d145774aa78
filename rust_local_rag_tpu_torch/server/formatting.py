"""Markdown result formatting for MCP responses (port of
rust_local_rag_tpu/server/formatting.py).

Byte-compatible with the reference's format_search_results
(mcp_server.rs:599-637): `**1. [85%] doc.pdf (page 5)**`, optional
`*Section: ...*` line, blank line, chunk text; results joined by `---`.
"""

from __future__ import annotations

import math
from typing import List, Sequence


def _round_half_away(x: float) -> int:
    """Rust f32::round() semantics (half away from zero), not Python's
    banker's rounding — [72.5%] must format as 73%."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def format_search_results(results: Sequence) -> str:
    if not results:
        return "No results found."

    blocks: List[str] = []
    for i, r in enumerate(results):
        provenance = (
            f"{r.document} (page {r.page_number})"
            if r.page_number > 0
            else r.document
        )
        section = f"*Section: {r.section}*\n" if r.section else ""
        percentage = _round_half_away(r.score * 100.0)
        blocks.append(
            f"**{i + 1}. [{percentage}%] {provenance}**\n{section}\n{r.text}\n"
        )
    return "\n---\n\n".join(blocks)
