"""SRX 2.0 segmentation engine (copy of rust_local_rag_tpu/ingest/srx.py;
one addition: load_segmenter logs a warning, once, when RAG_TPU_SRX_FILE
is set on a host without the `regex` module, where the JAX package takes
the built-in splitter without a word).

The reference embeds a 6,618-line SRX ruleset and compiles it with the
Rust `srx` crate at first use (rag_engine.rs:1359-1371,
data/segment.srx). This module is an original implementation of the same
contract: parse an SRX document, resolve the rules for a language, and
segment text by first-matching-rule-wins semantics.

Two behaviors are mirrored deliberately because they define the
reference's OBSERVED chunk boundaries (not the SRX spec's intent):

  * `language_rules(code)` matches each <languagemap> languagepattern
    UNANCHORED against the language string (the srx crate calls
    `Regex::is_match`, which searches anywhere). The reference passes the
    string "English", which therefore selects GeneralImportant (`.*`),
    Icelandic (`(IS|is).*` — "Engl-is-h"), Galician (`(GL|gl).*` —
    "En-gl-ish") and Default (`.*`), concatenated in map order under
    cascade="yes". The full English rule set is NOT selected ("English"
    contains neither "EN" nor "en"). Anchored matching is available via
    `language_rules(code, anchored=True)` for spec-style callers.
  * Rules are evaluated in order at every candidate position; the first
    rule whose beforebreak ends at the position AND whose afterbreak
    matches at it decides break/no-break (SRX 2.0 §segmentation).

Segmentation runs break-rule-first for speed: the few break="yes" rules
propose candidate positions (overlapped scan), then each candidate walks
the rule list in order until the first match decides it. This is
equivalent to the naive all-rules-all-positions scan because a position
with no matching rule is never a break.

Java-regex shims: the ruleset is written for Java/Rust regex; the one
construct Python's `regex` module parses DIFFERENTLY (nested character
class union, e.g. `[a-z[^íáóæ]]`) is rewritten to an alternation. Every
pattern in the shipped ruleset compiles after the shim; rules that still
fail are skipped and counted in `Rules.skipped`.
"""

from __future__ import annotations

import logging
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Optional, Tuple

logger = logging.getLogger(__name__)

try:  # `regex` supports \p{..} classes and overlapped scans; stdlib re
    # does not. The image ships it; the hermetic fallback keeps imports
    # working so the built-in splitter can take over.
    import regex as _re

    _HAVE_REGEX = True
except ImportError:  # pragma: no cover - regex is baked into the image
    import re as _re  # type: ignore

    _HAVE_REGEX = False

_NS = "{http://www.lisa.org/srx20}"

# how far back a beforebreak is allowed to reach when testing "ends at
# position p" (the shipped ruleset's longest befores are short abbreviation
# alternations; 160 covers them with margin)
_BEFORE_WINDOW = 160


def _shim_java_class_union(pattern: str) -> str:
    """Rewrite Java/Rust nested character-class unions `[abc[^xyz]]` into
    `(?:[abc]|[^xyz])`. Python's regex parses the inner `[` as a literal,
    silently changing the meaning."""
    out = []
    i, n = 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            out.append(pattern[i : i + 2])
            i += 2
            continue
        if c != "[":
            out.append(c)
            i += 1
            continue
        # scan the class; detect a nested unescaped '['
        j = i + 1
        depth = 1
        parts: List[str] = []
        cur = []
        start = j
        if j < n and pattern[j] == "^":
            cur.append("^")
            j += 1
        while j < n and depth:
            cj = pattern[j]
            if cj == "\\" and j + 1 < n:
                cur.append(pattern[j : j + 2])
                j += 2
                continue
            if cj == "[":
                depth += 1
                if depth == 2:
                    # inner class begins: flush outer accumulation
                    parts.append("".join(cur))
                    cur = ["["]
                else:
                    cur.append("[")
                j += 1
                continue
            if cj == "]":
                depth -= 1
                if depth == 1:
                    cur.append("]")
                    parts.append("".join(cur))
                    cur = []
                elif depth == 0:
                    parts.append("".join(cur))
                else:
                    cur.append("]")
                j += 1
                continue
            cur.append(cj)
            j += 1
        if depth != 0:  # unbalanced: leave untouched
            out.append(pattern[i:])
            break
        inner = [p for p in parts if p.startswith("[")]
        if not inner:
            out.append(pattern[i:j])
            i = j
            continue
        alts = []
        outer_chars = "".join(p for p in parts if not p.startswith("["))
        neg = outer_chars.startswith("^")
        if neg:
            outer_chars = outer_chars[1:]
        if outer_chars:
            alts.append(("[^" if neg else "[") + outer_chars + "]")
        alts.extend(inner)
        out.append("(?:" + "|".join(alts) + ")")
        i = j
    return "".join(out)


@dataclass
class SrxRule:
    brk: bool
    before: object  # compiled regex (may be None for empty pattern)
    after: object
    combined: object  # before(?=after), used for candidate scans


class Rules:
    """An ordered, compiled rule list for one language resolution."""

    def __init__(self, rules: List[SrxRule], skipped: int = 0):
        self.rules = rules
        self.skipped = skipped
        self._yes = [
            (order, r) for order, r in enumerate(rules) if r.brk
        ]

    def __len__(self) -> int:
        return len(self.rules)

    def _matches_at(self, rule: SrxRule, text: str, pos: int) -> bool:
        """True when rule.before has a match ENDING at pos and rule.after
        matches starting at pos (SRX rule applicability at a position)."""
        if rule.after is not None and rule.after.match(text, pos) is None:
            return False
        if rule.before is None:
            return True
        w = max(0, pos - _BEFORE_WINDOW)
        if _HAVE_REGEX:
            for m in rule.before.finditer(text, w, pos, overlapped=True):
                if m.end() == pos:
                    return True
            return False
        for s in range(w, pos + 1):  # pragma: no cover - stdlib fallback
            m = rule.before.match(text, s, pos)
            if m is not None and m.end() == pos:
                return True
        return False

    def break_positions(self, text: str) -> List[int]:
        """Positions strictly inside `text` where a break="yes" rule is
        the first matching rule."""
        candidates = {}  # pos -> lowest yes-rule order proposing it
        for order, rule in self._yes:
            if rule.combined is None:
                continue
            if _HAVE_REGEX:
                it = rule.combined.finditer(text, overlapped=True)
            else:  # pragma: no cover
                it = rule.combined.finditer(text)
            for m in it:
                pos = m.end()
                if 0 < pos < len(text):
                    prev = candidates.get(pos)
                    if prev is None or order < prev:
                        candidates[pos] = order
        out = []
        for pos in sorted(candidates):
            yes_order = candidates[pos]
            decided = True
            for order in range(yes_order):
                r = self.rules[order]
                if not r.brk and self._matches_at(r, text, pos):
                    decided = False
                    break
            if decided:
                out.append(pos)
        return out

    def split(self, text: str) -> List[str]:
        """Segment text; concatenation of the result equals the input
        (no trimming — the caller trims, rag_engine.rs:1257-1261)."""
        if not text:
            return []
        prev = 0
        segs = []
        for pos in self.break_positions(text):
            segs.append(text[prev:pos])
            prev = pos
        segs.append(text[prev:])
        return segs


class SRX:
    def __init__(self, maps: List[Tuple[object, str]], rules_by_name, cascade: bool):
        self._maps = maps
        self._rules_by_name = rules_by_name
        self._cascade = cascade

    @classmethod
    def from_file(cls, path: str) -> "SRX":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_str(f.read())

    @classmethod
    def from_str(cls, xml_text: str) -> "SRX":
        root = ET.fromstring(xml_text)
        header = root.find(_NS + "header")
        cascade = (header.get("cascade", "yes") if header is not None else "yes") == "yes"
        rules_by_name = {}
        for lr in root.iter(_NS + "languagerule"):
            name = lr.get("languagerulename")
            entries = []
            for r in lr.findall(_NS + "rule"):
                brk = r.get("break", "yes") == "yes"
                bb = r.find(_NS + "beforebreak")
                ab = r.find(_NS + "afterbreak")
                entries.append(
                    (
                        brk,
                        bb.text if bb is not None and bb.text else "",
                        ab.text if ab is not None and ab.text else "",
                    )
                )
            rules_by_name[name] = entries
        maps = []
        for lm in root.iter(_NS + "languagemap"):
            pat = lm.get("languagepattern", "")
            try:
                maps.append((_re.compile(pat), lm.get("languagerulename")))
            except Exception:  # noqa: BLE001 - skip uncompilable maps
                logger.warning("SRX: skipping languagemap pattern %r", pat)
        return cls(maps, rules_by_name, cascade)

    def language_rules(self, code: str, anchored: bool = False) -> Rules:
        """Resolve the rule list for a language string. anchored=False is
        the srx crate's `Regex::is_match` behavior (see module docstring);
        anchored=True is SRX-spec whole-code matching."""
        compiled: List[SrxRule] = []
        skipped = 0
        for pat, name in self._maps:
            hit = (
                pat.fullmatch(code) if anchored else pat.search(code)
            )
            if hit is None:
                continue
            for brk, before, after in self._rules_by_name.get(name, []):
                rule = _compile_rule(brk, before, after)
                if rule is None:
                    skipped += 1
                else:
                    compiled.append(rule)
            if not self._cascade:
                break
        return Rules(compiled, skipped)


def _compile_rule(brk: bool, before: str, after: str) -> Optional[SrxRule]:
    try:
        b = _shim_java_class_union(before)
        a = _shim_java_class_union(after)
        before_re = _re.compile(b) if b else None
        after_re = _re.compile(a) if a else None
        combined = None
        if brk:
            if b and a:
                combined = _re.compile(f"(?:{b})(?=(?:{a}))")
            elif b:
                combined = _re.compile(b)
            elif a:
                combined = _re.compile(f"(?=(?:{a}))")
        return SrxRule(brk, before_re, after_re, combined)
    except Exception:  # noqa: BLE001
        logger.warning(
            "SRX: skipping uncompilable rule before=%r after=%r",
            before,
            after,
        )
        return None


_SEGMENTER: Optional[Rules] = None
_SEGMENTER_KEY: Optional[Tuple[str, str]] = None
_WARNED_NO_REGEX = False


def load_segmenter() -> Optional[Rules]:
    """The configured full-ruleset segmenter, or None (built-in splitter).

    RAG_TPU_SRX_FILE points at an SRX 2.0 document (e.g. the LanguageTool
    `segment.srx` the reference embeds); RAG_TPU_SRX_LANGUAGE (default
    "English", the reference's literal argument) selects the rules."""
    global _SEGMENTER, _SEGMENTER_KEY, _WARNED_NO_REGEX
    path = os.environ.get("RAG_TPU_SRX_FILE", "").strip()
    if path and not _HAVE_REGEX and not _WARNED_NO_REGEX:
        _WARNED_NO_REGEX = True
        logger.warning("SRX: RAG_TPU_SRX_FILE is set but the regex module is missing; "
                       "using the built-in splitter")
    if not path or not _HAVE_REGEX:
        _SEGMENTER = None
        _SEGMENTER_KEY = None
        return None
    lang = os.environ.get("RAG_TPU_SRX_LANGUAGE", "English")
    key = (path, lang)
    if _SEGMENTER_KEY == key:
        return _SEGMENTER
    try:
        rules = SRX.from_file(path).language_rules(lang)
        logger.info(
            "SRX segmenter: %d rules for %r from %s (%d skipped)",
            len(rules), lang, path, rules.skipped,
        )
        _SEGMENTER = rules
        _SEGMENTER_KEY = key
    except Exception as e:  # noqa: BLE001 - fall back to builtin splitter
        logger.warning("SRX: failed to load %s: %s", path, e)
        _SEGMENTER = None
        _SEGMENTER_KEY = key
    return _SEGMENTER
