"""The benchmark's inputs, made from --seed: chunk texts, queries, the
sizes of documents and the slab's rows.

Words are drawn by Zipf over a vocabulary as large as Heaps' law gives
for the source's whole text (`vocabulary_size`). Its most frequent ranks
are the whole-word entries of the tokenizer the system loads (lowercase
ASCII words of three letters or more that it maps to one id, in
vocabulary order, which is frequency order for a trained WordPiece
vocabulary); every rarer rank is a word made of one of those and a "##"
continuation piece, which the tokenizer splits into exactly those two
pieces (`vocabulary` picks the pairs so that it must). So the WordPiece
count of every text is known from its words (`Vocabulary.pieces`), and
the BM25 tokens of a text are its words. Lengths are a fixed multiset,
the quantiles of a clipped log-normal around the source's mean, put in
an order drawn from the seed: every seed does the same amount of work.
"""

from __future__ import annotations

import bisect
import math
import re
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

_WORD = re.compile(r"[a-z]{3,}")
_LETTERS = re.compile(r"[a-z]+")
_SUFFIX = re.compile(r"##([a-z]+)")

# independent streams of one seed (a query stream's lengths take stream + 100)
CORPUS, CORPUS_ORDER, QUERIES = 0, 1, 2
WARM, SAMPLE, ROWS, DOCS = 4, 5, 6, 7
TABLE = 1 << 24
PAIRS = 20240418  # the fixed stream that orders the two-piece words (not a seed of a run)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), stream]))


def torch_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([int(seed) % (1 << 64), stream]).generate_state(1, np.uint64)[0] >> 1)


class Vocabulary:
    """Words by rank (`words`, an object array) with their WordPiece counts
    (`pieces`: 1 for the first `n_whole` ranks, 2 for the rest)."""

    def __init__(self, words: Sequence[str], n_whole: int):
        self.words = np.array(words, dtype=object)
        self.n_whole = int(n_whole)
        self.pieces = np.ones(len(words), dtype=np.int64)
        self.pieces[n_whole:] = 2
        self._whole = set(words[:n_whole])

    def __len__(self) -> int:
        return len(self.words)

    def __getitem__(self, i):
        return self.words[i]

    def tokens(self, texts: "Texts") -> np.ndarray:
        """WordPiece pieces of each text's words (without [CLS] / [SEP])."""
        total = np.zeros(len(texts.ids) + 1, dtype=np.int64)
        np.cumsum(self.pieces[texts.ids], out=total[1:])
        return total[texts.offsets[1:]] - total[texts.offsets[:-1]]

    def text_pieces(self, text: str) -> int:
        """WordPiece pieces of a text made of this vocabulary's words."""
        words = text.split()
        return 2 * len(words) - sum(w in self._whole for w in words)


def vocabulary_size(cfg: dict) -> int:
    """Heaps' law, V = k T^beta, at the source's whole text: T is its
    published documents times their mean words."""
    spec = cfg["corpus"]
    documents = cfg.get("published", {}).get("documents", spec["documents"])
    return int(round(spec["heaps_k"] * (documents * spec["mean_words"]) ** spec["heaps_beta"]))


def vocabulary(tok, size: int) -> Vocabulary:
    """`size` words: the tokenizer's one-id whole words in id order, then
    words base + suffix in an order fixed by PAIRS, where base is a whole
    word that no longer entry of the tokenizer starts with and "##" +
    suffix is a continuation entry. Greedy longest-match WordPiece then
    takes base (nothing longer matches at the start) and "##suffix" (the
    whole rest), so each is two pieces; the bases being prefix-free, no two
    such words are equal, and none is an entry. Words holding an added
    entry of the tokenizer are passed over."""
    whole = [w for _, w in sorted((i, w) for w, i in tok._vocab.items() if _WORD.fullmatch(w))
             if len(tok.tokenize(w)) == 3]
    if size <= len(whole):
        return Vocabulary(whole[:size], size)
    letters = sorted(w for w in tok._vocab if _LETTERS.fullmatch(w))
    bases = []
    for w in whole:
        j = bisect.bisect_right(letters, w)
        if j == len(letters) or not letters[j].startswith(w):
            bases.append(w)
    suffixes = [w[2:] for _, w in sorted((i, w) for w, i in tok._vocab.items() if _SUFFIX.fullmatch(w))]
    extra = size - len(whole)
    # an added entry (the judge's "yes") is split out wherever it occurs: no word may hold one
    added = [w for w in list(tok._raw_added) + list(tok._norm_added) if _LETTERS.fullmatch(w)]
    pairs = len(bases) * len(suffixes)
    pick = np.random.default_rng(PAIRS).choice(pairs, size=min(pairs, extra + extra // 8 + 64), replace=False)
    words = []
    for i, j in zip(*(x.tolist() for x in np.divmod(pick, len(suffixes)))):
        w = bases[i] + suffixes[j]
        if not any(a in w for a in added):
            words.append(w)
            if len(words) == extra:
                return Vocabulary(whole + words, len(whole))
    raise ValueError(f"only {len(words)} two-piece words for a vocabulary of {size}")


def lengths(n: int, spec: dict, order: np.random.Generator) -> np.ndarray:
    """n lengths: the quantiles (i + 0.5) / n of a log-normal of mean
    spec["mean_words"] and shape spec["length_sigma"], rounded and clipped
    to [min_words, max_words], in a random order."""
    sigma = float(spec["length_sigma"])
    u = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    x = float(spec["mean_words"]) * torch.exp(sigma * z - sigma * sigma / 2.0)
    out = np.clip(np.rint(x.numpy()), spec["min_words"], spec["max_words"]).astype(np.int64)
    return out[order.permutation(n)]


def document_sizes(spec: dict, seed: int) -> np.ndarray:
    """The passages of each document of a cycle, in an order drawn from the
    seed: with spec["range"] = [lo, hi] every size from lo to hi once;
    otherwise spec["cycle"] sizes, the quantiles (i + 0.5) / n of a
    geometric distribution on 1, 2, ... of mean spec["mean"]."""
    if "range" in spec:
        lo, hi = (int(v) for v in spec["range"])
        sizes = np.arange(lo, hi + 1, dtype=np.int64)
    else:
        n = int(spec["cycle"])
        u = (np.arange(n, dtype=np.float64) + 0.5) / n
        sizes = np.maximum(1, np.ceil(np.log1p(-u) / math.log1p(-1.0 / float(spec["mean"])))).astype(np.int64)
    return sizes[rng(seed, DOCS).permutation(len(sizes))]


def zipf_ids(g: np.random.Generator, n: int, vocab: int, s: float, skip: int = 0) -> np.ndarray:
    """n word ids by Zipf of exponent s over ranks skip+1 .. vocab, drawn
    through a table of 2^24 entries in which each id holds its share
    (largest remainders), so each probability is exact to 2^-24."""
    ranks = np.arange(skip + 1, vocab + 1, dtype=np.float64)
    p = ranks ** -float(s)
    want = p / p.sum() * TABLE
    counts = np.floor(want).astype(np.int64)
    short = TABLE - int(counts.sum())
    counts[np.argsort(counts - want, kind="stable")[:short]] += 1
    table = np.repeat(np.arange(skip, vocab, dtype=np.int32), counts)
    return table[g.integers(0, TABLE, n)]


@dataclass
class Texts:
    """Texts as word ids (ids[offsets[i]:offsets[i + 1]]) and as strings."""

    ids: np.ndarray
    offsets: np.ndarray
    texts: List[str]

    def __len__(self) -> int:
        return len(self.texts)

    def words(self, i: int) -> np.ndarray:
        return self.ids[self.offsets[i]:self.offsets[i + 1]]


def make_texts(vocab: Vocabulary, lens: np.ndarray, g: np.random.Generator, s: float, skip: int = 0) -> Texts:
    offsets = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    ids = zipf_ids(g, int(offsets[-1]), len(vocab), s, skip)
    words = vocab.words[ids]
    texts = [" ".join(words[a:b]) for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]
    return Texts(ids, offsets, texts)


def corpus(vocab: Vocabulary, spec: dict, n: int, seed: int) -> Texts:
    """n chunk texts of the configuration's corpus."""
    return make_texts(vocab, lengths(n, spec, rng(seed, CORPUS_ORDER)), rng(seed, CORPUS), spec["zipf_s"])


def queries(vocab: Vocabulary, spec: dict, n: int, seed: int, stream: int = QUERIES) -> Texts:
    """n distinct queries (Zipf, skipping the most frequent ranks)."""
    g = rng(seed, stream)
    extra = max(16, n // 8)
    lens = lengths(n + extra, spec, rng(seed, stream + 100))
    t = make_texts(vocab, lens, g, spec["zipf_s"], spec["skip_ranks"])
    seen, keep = set(), []
    for i, q in enumerate(t.texts):
        if q not in seen:
            seen.add(q)
            keep.append(i)
        if len(keep) == n:
            break
    if len(keep) < n:
        raise RuntimeError(f"only {len(keep)} distinct queries of {n}")
    lens_k = np.diff(t.offsets)[keep]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens_k, out=offsets[1:])
    ids = np.concatenate([t.words(i) for i in keep]) if keep else t.ids[:0]
    return Texts(ids, offsets, [t.texts[i] for i in keep])


def slab_dtype(cfg: dict) -> torch.dtype:
    """The dtype the configuration stores its rows in."""
    return torch.bfloat16 if cfg["settings"].get("RAG_TPU_CORPUS_DTYPE") == "bf16" else torch.float32


def rows(n: int, dim: int, seed: int, device) -> torch.Tensor:
    """[n, dim] f32 unit rows, drawn on `device` from the seed."""
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, ROWS))
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    block = 1 << 17
    for lo in range(0, n, block):
        x = torch.randn((min(block, n - lo), dim), generator=g, device=device)
        out[lo:lo + x.shape[0]] = x / x.norm(dim=1, keepdim=True)
    return out
