"""Sentence-aware chunking (copy of rust_local_rag_tpu/ingest/chunking.py).

Re-implements the reference's ingest text pipeline (rag_engine.rs:1102-1357):

  * pages are split on form-feed (\\f), page numbers are 1-based;
  * blocks split on blank lines; single-line blocks that look like headings
    become the running section title instead of content;
  * sentences come from an English sentence splitter (the reference embeds a
    6,618-line SRX ruleset; here a rule-based splitter covers the same
    behavior class: abbreviation, initials, decimal and ellipsis handling);
  * token counts are estimated as max(ceil(chars/4), ceil(words*0.9), 1)
    (rag_engine.rs:1346-1357);
  * chunks are sentence windows closed when the token budget is reached,
    with a 2-sentence overlap carried into the next window
    (rag_engine.rs:1102-1141);
  * chunk metadata: page range, sentence range, first heading seen, token
    count, overlap size; section titles truncated to 160 chars
    (rag_engine.rs:1143-1212).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

SENTENCE_OVERLAP = 2
MAX_TITLE_LEN = 160

# English abbreviation handling models the SRX English ruleset's two rule
# classes (segment.srx:1104-1418, compiled into the reference at
# rag_engine.rs:1359-1371):
#   * ALWAYS rules have an empty <afterbreak> — the period never ends a
#     sentence (titles, months, corporate suffixes, Latin citations,
#     degrees): "Dec. 12", "Mr. Smith", "Acme Inc. hired".
#   * SOFT rules carry afterbreak [^\p{Lu}]|I (or \p{N}/roman variants) —
#     the period is suppressed only before a non-uppercase continuation, a
#     number, a roman numeral, or the pronoun "I": "Fig. 3" stays joined,
#     "The min. Temperature rose." splits.
# The golden suite in tests/test_srx_goldens.py pins ~55 cases extracted
# from the ruleset.
_ABBREV_ALWAYS = {
    # titles (segment.srx "Atty|Sg?t|[SG]en|Ft|Gov|Hon|Prof|Mr?s|Mt|...")
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "rev", "revd",
    "hon", "atty", "sgt", "sen", "gen", "ft", "gov", "mt", "col",
    "lt", "lieut", "brig", "capt", "cmdr", "cmnd", "rep", "drs", "messrs",
    "mmes",
    # months ("\bJan\.\s" ... "\bDec\.\s", empty afterbreak)
    "jan", "feb", "mar", "apr", "jun", "jul", "aug", "sep", "sept", "oct",
    "nov", "dec",
    # Latin / citation ("e\.g\.", "i\.e\.", "vs\.", "cf\.", "et al\.",
    # "e[sx]p\.", "[Bb]tw\.")
    "e.g", "i.e", "vs", "v", "cf", "al", "esp", "exp", "btw",
    # corporate ("Corp\.", "Bros\.", "Dist\.", "Co\.")
    "corp", "bros", "dist", "co",
    # degrees ("P[Hh]\.?\s?[Dd]\.", "(PhD|BSc|BEng|...)\.", "LL\.[BM]\.")
    "ph.d", "phd", "bsc", "beng", "bcomp", "barch", "msc", "meng",
    "mcomp", "ll.b", "ll.m", "b.sc", "m.sc", "b.eng", "m.eng", "b.comp",
    "b.arch", "m.d", "b.a", "m.a",
    # misc always-safe
    "u.s", "u.k", "d.c", "p", "pp", "ch", "sec", "dept", "est", "appt",
    "apt", "rd", "nos",
}
# Case-sensitive hard no-breaks: the SRX title rule lists capitalized
# "Maj" (segment.srx:1283) and the corporate rule "I(nc|NC)" (srx:1299)
# with empty afterbreak, while the LOWERCASE forms "maj"/"[Ii]ncl?" belong
# to the soft measurement rule (srx:1146, afterbreak [^\p{Lu}]|I). A
# case-blind lookup would shadow the soft behavior ("a 3% inc. Next..."
# must split; "Acme Inc. The merger..." must not).
_ABBREV_CASED_ALWAYS = {"Inc", "INC", "Maj"}

_ABBREV_SOFT = {
    # the big measurement/figure rule (afterbreak [^\p{Lu}]|I) plus the
    # \p{N}/roman figure rules and \p{Ll}+ street/state rules
    "fig", "figs", "eq", "eqs", "vol", "vols", "thm", "lem", "prop",
    "def", "ed", "viz", "approx", "incl", "inc", "acc", "pres", "ex",
    "conn", "min", "max", "govt", "lb", "lbf", "lbs", "dia", "hr",
    "maj", "rcol", "msec", "no", "etc", "ave", "blvd", "mts", "kan",
    "ill", "mass", "miss", "ltd",
}

# runs of uppercase initials: "J.", "U.S", "L.A", "J.R.R" — never a break
# (segment.srx "\b\p{Lu}\.\p{Lu}\.\s" and "[^\.]\s[A-Z]\.\s")
_INITIALS_RE = re.compile(r"^([A-Z]\.)*[A-Z]$")
_ROMAN_RE = re.compile(r"^[IVXLC]+$")

_HEADING_NUM_RE = re.compile(r"^\d+\.\s")


@dataclass
class SentenceInfo:
    """Mirror of the reference's SentenceInfo (rag_engine.rs:61-68)."""

    text: str
    tokens: int
    page: int
    heading: Optional[str]
    index: int


@dataclass
class ChunkFragment:
    """Mirror of ChunkFragment (rag_engine.rs:115-132)."""

    text: str
    page_number: int
    section: Optional[str]
    metadata: dict = field(default_factory=dict)


def normalize_whitespace(value: str) -> str:
    """Collapse all whitespace runs to single spaces (rag_engine.rs:1302-1304)."""
    return " ".join(value.split())


def approximate_token_count(value: str) -> int:
    """max(ceil(chars/4), ceil(words*0.9), 1); 0 for empty
    (rag_engine.rs:1346-1357)."""
    trimmed = value.strip()
    if not trimmed:
        return 0
    char_count = len(trimmed)
    word_count = len(trimmed.split())
    char_estimate = -(-char_count // 4)
    word_estimate = int(-(-(word_count * 0.9) // 1))
    return max(char_estimate, word_estimate, 1)


def is_heading(line: str) -> bool:
    """Heading heuristics (rag_engine.rs:1306-1338)."""
    trimmed = line.strip()
    if not trimmed or len(trimmed.encode("utf-8")) > 120:
        return False

    words = trimmed.split()
    word_count = len(words)
    if word_count == 0 or word_count > 12:
        return False

    uppercase = sum(1 for c in trimmed if c.isupper())
    lowercase = sum(1 for c in trimmed if c.islower())

    if lowercase == 0 and uppercase > 0:
        return True
    if trimmed.endswith(":"):
        return True
    if word_count <= 4 and uppercase >= lowercase:
        return True
    if _HEADING_NUM_RE.match(trimmed):
        return True
    return False


def _next_token(text: str, k: int) -> str:
    """The word starting at k (letters/digits until space or punct)."""
    m = k
    n = len(text)
    while m < n and (text[m].isalnum() or text[m] in "'-"):
        m += 1
    return text[k:m]


def split_sentences(text: str) -> List[str]:
    """English sentence segmentation modeling the reference's SRX English
    ruleset (segment.srx:1104-1418; rule classes documented at
    _ABBREV_ALWAYS/_ABBREV_SOFT above).

    Full-ruleset mode: when RAG_TPU_SRX_FILE points at an SRX 2.0 document
    the compiled ruleset segments instead (ingest/srx.py), reproducing the
    reference's exact rule resolution including the srx crate's unanchored
    language matching quirk. The built-in splitter below remains the
    default: it is ~40x faster on the host ingest path and covers the
    same rule classes.

    SRX's catch-all break rules fire after any terminal punctuation run
    followed by whitespace — including before a lowercase continuation —
    unless a no-break rule matched first. One deliberate divergence, noted
    in the golden suite: an ellipsis followed by a lowercase continuation
    stays joined ("trailed off ... and resumed"), where raw SRX would
    split; PDF text is full of mid-sentence ellipses.
    """
    from rust_local_rag_tpu_torch.ingest import srx as _srx

    seg = _srx.load_segmenter()
    if seg is not None:
        return [s for s in (p.strip() for p in seg.split(text)) if s]
    out: List[str] = []
    n = len(text)
    start = 0
    i = 0
    while i < n:
        ch = text[i]
        if ch not in ".!?":
            i += 1
            continue
        is_ellipsis = text[i : i + 3] == "..." or ch == "…"
        # swallow runs of terminal punctuation and closing marks
        j = i + 1
        while j < n and text[j] in ".!?…\"'）)]}”’":
            j += 1
        if j >= n:
            i = j
            continue
        if not text[j].isspace():
            # mid-token period: file names, decimals, module paths
            i = j
            continue
        k = j
        while k < n and text[k].isspace():
            k += 1
        if k >= n:
            i = j
            continue

        no_break = False
        nxt = text[k]
        if ch in "!?":
            # "Hello (Hi! ) my name is Chris" — paren continuation
            # (segment.srx "[a-zA-Z][!\?]\s" + "\)\s[a-zA-Z]")
            if nxt in ")]" :
                no_break = True
        elif is_ellipsis:
            # deliberate divergence (see docstring): "... lowercase" joins
            if nxt.islower():
                no_break = True
        else:
            # inspect the word preceding the period
            w_end = i
            w_start = i - 1
            while w_start >= 0 and not text[w_start].isspace():
                w_start -= 1
            word = text[w_start + 1 : w_end].lstrip("\"'“‘([")
            wl = word.lower().rstrip(".")
            if _INITIALS_RE.match(word.rstrip(".")):
                no_break = True
            elif (
                wl in _ABBREV_ALWAYS
                or word.rstrip(".") in _ABBREV_CASED_ALWAYS
            ):
                no_break = True
            elif wl in _ABBREV_SOFT:
                # suppressed unless the continuation looks like a fresh
                # sentence: uppercase word that is neither "I" nor a
                # roman numeral (afterbreak [^\p{Lu}]|I, \p{N}, [IXV]+)
                if not nxt.isupper():
                    no_break = True
                else:
                    token = _next_token(text, k)
                    if token == "I" or _ROMAN_RE.match(token):
                        no_break = True

        if no_break:
            i = j
            continue
        piece = text[start:j].strip()
        if piece:
            out.append(piece)
        start = k
        i = k
    tail = text[start:].strip()
    if tail:
        out.append(tail)
    return out


def extract_sentences(text: str) -> List[SentenceInfo]:
    """Page/block/heading-aware sentence extraction (rag_engine.rs:1214-1300)."""
    sentences: List[SentenceInfo] = []
    sentence_index = 0

    for page_idx, page_text in enumerate(text.split("\x0c")):
        page_number = page_idx + 1
        last_heading: Optional[str] = None

        for block in page_text.split("\n\n"):
            block = block.strip()
            if not block:
                continue

            lines = block.splitlines()
            if len(lines) == 1 and is_heading(lines[0]):
                last_heading = lines[0].strip()
                continue

            paragraph_lines: List[str] = []
            for line in lines:
                trimmed = line.strip()
                if not trimmed:
                    continue
                if not paragraph_lines and is_heading(trimmed):
                    last_heading = trimmed
                    continue
                paragraph_lines.append(trimmed)

            if not paragraph_lines:
                continue

            normalized = normalize_whitespace(" ".join(paragraph_lines))
            if not normalized:
                continue

            splits = [s for s in (p.strip() for p in split_sentences(normalized)) if s]
            parts = splits if splits else [normalized]

            for part in parts:
                tokens = approximate_token_count(part)
                if tokens == 0:
                    continue
                sentences.append(
                    SentenceInfo(
                        text=part,
                        tokens=tokens,
                        page=page_number,
                        heading=last_heading,
                        index=sentence_index,
                    )
                )
                sentence_index += 1

    if not sentences:
        normalized = normalize_whitespace(text)
        if normalized:
            sentences.append(
                SentenceInfo(
                    text=normalized,
                    tokens=approximate_token_count(normalized),
                    page=1,
                    heading=None,
                    index=0,
                )
            )
    return sentences


def _finalize_chunk(
    sentence_indices: List[int],
    sentences: List[SentenceInfo],
    overlap_with_previous: int,
) -> Optional[Tuple[str, dict]]:
    """rag_engine.rs:1143-1212"""
    if not sentence_indices:
        return None

    text_parts: List[str] = []
    min_page: Optional[int] = None
    max_page: Optional[int] = None
    section_title: Optional[str] = None
    token_sum = 0

    for idx in sentence_indices:
        s = sentences[idx]
        text_parts.append(s.text)
        token_sum += s.tokens
        min_page = s.page if min_page is None else min(min_page, s.page)
        max_page = s.page if max_page is None else max(max_page, s.page)
        if section_title is None and s.heading is not None:
            section_title = s.heading

    start_index = sentences[sentence_indices[0]].index
    end_index = sentences[sentence_indices[-1]].index

    chunk_text = normalize_whitespace(" ".join(text_parts))
    if not chunk_text:
        return None

    if section_title is not None and len(section_title) > MAX_TITLE_LEN:
        section_title = section_title[:MAX_TITLE_LEN]

    metadata = {
        "page_range": (min_page, max_page),
        "sentence_range": (start_index, end_index),
        "section_title": section_title,
        "token_count": token_sum,
        "overlap_with_previous": overlap_with_previous,
    }
    return chunk_text, metadata


def chunk_text(text: str, chunk_tokens: int = 200) -> List[ChunkFragment]:
    """Sentence-window chunking (rag_engine.rs:1102-1141)."""
    sentences = extract_sentences(text)
    if not sentences:
        return []

    window: List[int] = []
    token_sum = 0
    fragments: List[ChunkFragment] = []

    for idx, sentence in enumerate(sentences):
        window.append(idx)
        token_sum += sentence.tokens

        if token_sum >= chunk_tokens:
            finalized = _finalize_chunk(window, sentences, SENTENCE_OVERLAP)
            if finalized is not None:
                txt, md = finalized
                fragments.append(_fragment_from_metadata(txt, md))
            overlap_start = max(len(window) - SENTENCE_OVERLAP, 0)
            window = window[overlap_start:]
            token_sum = sum(sentences[i].tokens for i in window)

    if window:
        finalized = _finalize_chunk(window, sentences, 0)
        if finalized is not None:
            txt, md = finalized
            fragments.append(_fragment_from_metadata(txt, md))

    return fragments


def _fragment_from_metadata(text: str, metadata: dict) -> ChunkFragment:
    """ChunkFragment::from_metadata (rag_engine.rs:123-132)."""
    page_range = metadata.get("page_range")
    page_number = page_range[0] if page_range else 1
    return ChunkFragment(
        text=text,
        page_number=page_number,
        section=metadata.get("section_title"),
        metadata=metadata,
    )
