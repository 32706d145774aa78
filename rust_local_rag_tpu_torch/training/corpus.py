"""Training-corpus harvesting from locally installed documentation (the
port's copy of rust_local_rag_tpu/training/corpus.py: standard library
only, plus eval_passage_hashes).

Zero-egress environments cannot download pretraining data; what they DO
have is tens of MB of high-quality technical English sitting in the
docstrings and doc files of installed Python packages (numpy/scipy prose
is professionally edited). This module harvests, cleans, and dedups that
text into a paragraph list used to train the tokenizer and the contrastive
embedding encoder.

Honesty guard: `harvest(exclude_hashes=...)` lets callers hold the quality
eval's corpus passages out of training (eval_harness/corpus.py passes its
passage hashes), so retrieval-quality numbers are not memorization.
"""

from __future__ import annotations

import ast
import glob
import hashlib
import os
import re
from typing import Iterable, List, Optional, Sequence, Set

# Packages mined for docstring prose (alphabetical; only those installed
# are used). Chosen for volume and prose quality.
DEFAULT_PACKAGES = (
    "aiohttp",
    "chex",
    "flax",
    "jax",
    "matplotlib",
    "numpy",
    "optax",
    "orbax",
    "pandas",
    "scipy",
    "sklearn",
    "statsmodels",
    "torch",
    "transformers",
)

# Packages RESERVED as the out-of-domain junk source for judge training
# (train_reranker.py --junk-doc-frac): their docstring prose never joins
# the training corpus, so crop-queries drawn from them are real technical
# questions the corpus genuinely cannot answer — the serving rejection
# case (near-domain junk like the dev split's DNS/Kubernetes questions),
# in unlimited supply. The template banks in training/ood.py top out at
# ~200 unique junk queries, which the judge memorizes over a 6k-step run
# (the round-5 v13 diagnosis: the held-template probe leak GROWS with
# training steps). Never add these to DEFAULT_PACKAGES; their wheel
# READMEs are excluded from harvest_readmes for the same reason.
# NEVER a package whose prose any eval corpus is built from: pygame is
# EXCLUDED because the third-party eval split ingests pygame's bundled
# API reference (eval_harness/thirdparty.py) — a judge taught "pygame
# questions are unanswerable" would reject that split's gold queries.
JUNK_HOLDOUT_PACKAGES = (
    "PIL",
    "click",
    "jinja2",
    "networkx",
    "nltk",
    "pydantic",
    "rich",
    "seaborn",
    "sympy",
    "tornado",
)

# wheel (dist-info) names for JUNK_HOLDOUT_PACKAGES — PIL ships as pillow
JUNK_HOLDOUT_WHEELS = (
    "pillow",
    "click",
    "jinja2",
    "networkx",
    "nltk",
    "pydantic",
    "rich",
    "seaborn",
    "sympy",
    "tornado",
)

_MIN_WORDS = 12
_MAX_WORDS = 220
_MIN_ALPHA_RATIO = 0.72

# rst/markdown noise commonly embedded in docstrings and READMEs
_RST_ROLE = re.compile(r":[a-z]+:`([^`]*)`")
_BACKTICKS = re.compile(r"``?([^`]*)``?")
_UNDERLINE = re.compile(r"^[-=~^\"'#*]{3,}$")
_DIRECTIVE = re.compile(r"^\.\. [a-z]+::.*$")
_MD_IMAGE = re.compile(r"!\[[^\]]*\]\([^)]*\)")
_MD_LINK = re.compile(r"\[([^\]]*)\]\([^)]*\)")
_RST_LINK = re.compile(r"`([^`<]*)<[^>]*>`_+")
_BARE_URL = re.compile(r"https?://\S+")


def _clean_line(line: str) -> str:
    line = _MD_IMAGE.sub("", line)
    line = _MD_LINK.sub(r"\1", line)
    line = _RST_LINK.sub(r"\1", line)
    line = _RST_ROLE.sub(r"\1", line)
    line = _BACKTICKS.sub(r"\1", line)
    line = _BARE_URL.sub("", line)
    return line.strip()


def paragraphs_from_text(text: str) -> List[str]:
    """Blank-line-separated paragraphs, cleaned of rst markup, with code
    blocks (doctest '>>>' lines, deeply indented blocks) dropped."""
    paras: List[str] = []
    cur: List[str] = []
    in_fence = False
    for raw in text.splitlines():
        stripped = raw.strip()
        if stripped.startswith("```") or stripped.startswith("~~~"):
            in_fence = not in_fence
            if cur:
                paras.append(" ".join(cur))
                cur = []
            continue
        if in_fence:
            continue
        if (
            not stripped
            or stripped.startswith(">>>")
            or stripped.startswith("...")
            or _UNDERLINE.match(stripped)
            or _DIRECTIVE.match(stripped)
        ):
            if cur:
                paras.append(" ".join(cur))
                cur = []
            continue
        cur.append(_clean_line(stripped))
    if cur:
        paras.append(" ".join(cur))
    return paras


def _looks_like_prose(p: str) -> bool:
    words = p.split()
    if not (_MIN_WORDS <= len(words) <= _MAX_WORDS):
        return False
    alpha = sum(1 for w in words if any(c.isalpha() for c in w))
    return alpha / len(words) >= _MIN_ALPHA_RATIO


def normalized_hash(p: str) -> str:
    """Whitespace/case-insensitive content hash used for dedup and for the
    eval-passage holdout."""
    norm = " ".join(p.lower().split())
    return hashlib.blake2b(norm.encode("utf-8"), digest_size=12).hexdigest()


def _package_root(name: str) -> Optional[str]:
    import importlib.util

    try:
        spec = importlib.util.find_spec(name)
    except (ModuleNotFoundError, ValueError, ImportError):
        return None
    if spec is None or not spec.submodule_search_locations:
        return None
    return list(spec.submodule_search_locations)[0]


def _iter_docstrings(py_path: str) -> Iterable[str]:
    try:
        with open(py_path, encoding="utf-8", errors="ignore") as f:
            tree = ast.parse(f.read())
    except (SyntaxError, ValueError, OSError):
        return
    for node in ast.walk(tree):
        if isinstance(
            node,
            (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
        ):
            doc = ast.get_docstring(node)
            if doc:
                yield doc


def harvest(
    packages: Sequence[str] = DEFAULT_PACKAGES,
    exclude_hashes: Optional[Set[str]] = None,
    max_paragraphs: Optional[int] = None,
) -> List[str]:
    """Deterministic paragraph list from installed packages' docstrings and
    bundled .rst/.md/.txt doc files. Order is stable (sorted paths) so runs
    are reproducible; duplicates (and any `exclude_hashes` holdout — e.g.
    the quality-eval passages) are dropped."""
    exclude = exclude_hashes or set()
    seen: Set[str] = set()
    out: List[str] = []

    def _add(paragraphs: Iterable[str]) -> bool:
        for p in paragraphs:
            if not _looks_like_prose(p):
                continue
            h = normalized_hash(p)
            if h in seen or h in exclude:
                continue
            seen.add(h)
            out.append(p)
            if max_paragraphs is not None and len(out) >= max_paragraphs:
                return True
        return False

    for pkg in packages:
        root = _package_root(pkg)
        if root is None:
            continue
        for path in sorted(glob.glob(os.path.join(root, "**", "*.py"), recursive=True)):
            for doc in _iter_docstrings(path):
                if _add(paragraphs_from_text(doc)):
                    return out
        for ext in ("rst", "md", "txt"):
            for path in sorted(
                glob.glob(os.path.join(root, "**", f"*.{ext}"), recursive=True)
            ):
                try:
                    with open(path, encoding="utf-8", errors="ignore") as f:
                        text = f.read()
                except OSError:
                    continue
                if _add(paragraphs_from_text(text)):
                    return out
    return out


def harvest_readmes(
    exclude_hashes: Optional[Set[str]] = None,
    already_seen: Optional[Set[str]] = None,
    exclude_packages: Sequence[str] = JUNK_HOLDOUT_WHEELS,
) -> List[str]:
    """Authored-manual-style prose from wheel `*.dist-info/METADATA` files
    (every wheel embeds its project README in PyPI metadata).

    Why a second source: `harvest()` is ~99.6% docstring prose (69k vs 254
    docfile paragraphs), and the round-4 rejection diagnosis showed the
    judge's absolute yes-probability does not transfer to authored manual
    prose — junk yes-p read mean 0.09/max 0.68 on harvested passages but
    mean 0.21/max 0.98 on authored pages (training/ood.py honest-baseline
    note). READMEs are the one sizeable local corpus in that register
    (~5.7k paragraphs): narrative feature descriptions, install guides,
    usage walkthroughs — the style the serving deployments' PDFs use.
    """
    import site

    exclude = exclude_hashes or set()
    seen = set(already_seen or ())
    roots = []
    for sp in site.getsitepackages() + [site.getusersitepackages()]:
        if sp and os.path.isdir(sp) and sp not in roots:
            roots.append(sp)
    out: List[str] = []
    for root in roots:
        for path in sorted(
            glob.glob(os.path.join(root, "*.dist-info", "METADATA"))
        ):
            # "<name>-<version>.dist-info" — skip junk-holdout wheels so
            # their README prose cannot answer the doc-junk queries
            dist = os.path.basename(os.path.dirname(path))
            name = dist.split("-", 1)[0].lower().replace("_", "-")
            if name in {p.lower() for p in exclude_packages or ()}:
                continue
            try:
                with open(path, encoding="utf-8", errors="ignore") as f:
                    text = f.read()
            except OSError:
                continue
            # METADATA = RFC-822 headers, blank line, README body — only
            # the body is prose (headers would add "Requires-Dist:" soup)
            body = text.split("\n\n", 1)
            text = body[1] if len(body) == 2 else ""
            for p in paragraphs_from_text(text):
                if not _looks_like_prose(p):
                    continue
                h = normalized_hash(p)
                if h in seen or h in exclude:
                    continue
                seen.add(h)
                out.append(p)
    return out


def save_paragraphs(paragraphs: Sequence[str], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for p in paragraphs:
            f.write(p.replace("\n", " ") + "\n")


def load_paragraphs(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def eval_passage_hashes() -> Set[str]:
    """The set eval_harness.corpus.passage_hashes() gives, computed with this
    module's normalized_hash (that function imports the JAX package's
    copy): every authored eval page, with and without its heading line,
    every distractor page and its paragraphs, and the third-party eval
    documents where their sources are installed."""
    from eval_harness.corpus import DOCS, _ascii, load_distractors

    out: Set[str] = set()
    for doc in DOCS:
        for page in doc["pages"]:
            body = _ascii(page)
            out.add(normalized_hash(body))
            parts = body.split("\n", 1)
            if len(parts) == 2:
                out.add(normalized_hash(parts[1]))
    docs = list(load_distractors())
    try:
        from eval_harness.thirdparty import thirdparty_docs

        docs += list(thirdparty_docs())
    except Exception:  # noqa: BLE001 - as passage_hashes: sources absent on some hosts
        pass
    for doc in docs:
        for page in doc["pages"]:
            out.add(normalized_hash(page))
            for para in page.split("\n\n"):
                out.add(normalized_hash(para))
    return out
