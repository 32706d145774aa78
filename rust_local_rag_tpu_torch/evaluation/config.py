"""A reader for the subset of YAML that eval_harness/configs/*.yaml use:
`key: value` lines, maps nested by indentation, comments (whole lines and
after a value), and plain, single- or double-quoted scalars resolved as
yaml.safe_load resolves them (null, booleans, ints, floats, strings). It is
not a general YAML parser: sequences, flow collections, anchors, tags and
multi-line scalars raise ValueError."""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_OCTAL = re.compile(r"[-+]?0[0-7_]+$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_KEY = re.compile(r"([^\s:#'\"][^:#]*?|'[^']*'|\"[^\"]*\")\s*:(\s|$)")


def _strip_comment(s: str) -> str:
    """s without a trailing ` # comment` outside quotes."""
    quote = None
    skip = False
    for i, c in enumerate(s):
        if skip:
            skip = False
        elif quote:
            if c == quote == "'" and s[i + 1:i + 2] == "'":
                skip = True  # '' inside single quotes
            elif c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or s[i - 1] in " :"):
            quote = c
        elif c == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip()
    return s.rstrip()


def scalar(text: str) -> Any:
    """A scalar resolved as yaml.safe_load resolves it."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] == '"':
        return bytes(t[1:-1], "utf-8").decode("unicode_escape") if "\\" in t else t[1:-1]
    if len(t) >= 2 and t[0] == t[-1] == "'":
        return t[1:-1].replace("''", "'")
    if t and t[0] in "[{&*!|>-" and (t[0] != "-" or t[1:2] in (" ", "")):
        raise ValueError(f"unsupported YAML construct: {t!r}")
    if t in _NULL:
        return None
    if t in _TRUE:
        return True
    if t in _FALSE:
        return False
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _OCTAL.match(t):
        return int(t.replace("_", ""), 8)
    if _FLOAT.match(t) and any(ch.isdigit() for ch in t):
        return float(t.replace("_", ""))
    if t.lower() in (".inf", "+.inf", "-.inf", ".nan"):
        return float(t.lower().replace(".", ""))
    return t


def parse(text: str) -> dict:
    """The mapping of a YAML document in the supported subset."""
    lines: List[Tuple[int, str, int]] = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {n}: tab indentation")
        body = _strip_comment(raw)
        if body.strip() in ("", "---"):
            continue
        lines.append((len(body) - len(body.lstrip(" ")), body.strip(), n))
    root: dict = {}
    stack: List[Tuple[int, dict]] = [(-1, root)]
    for i, (indent, body, n) in enumerate(lines):
        m = _KEY.match(body)
        if not m:
            raise ValueError(f"line {n}: not a `key: value` line: {body!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        key = scalar(m.group(1))
        rest = body[m.end():].strip()
        target = stack[-1][1]
        if rest:
            target[key] = scalar(rest)
        elif i + 1 < len(lines) and lines[i + 1][0] > indent:
            target[key] = child = {}
            stack.append((indent, child))
        else:
            target[key] = None
    return root


def load(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return parse(f.read())
