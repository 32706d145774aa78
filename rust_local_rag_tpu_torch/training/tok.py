"""WordPiece vocabulary training on the standard library (port of
rust_local_rag_tpu/training/tok.py, which drives the ``tokenizers``
package's WordPieceTrainer).

    python -m rust_local_rag_tpu_torch.training.tok [--corpus FILE] [--out PATH] [--vocab-size 8192] [--force]

The default --out is the committed rust_local_rag_tpu/assets/tokenizer.json.
The CLI refuses to overwrite an existing file unless --force is given: a
retrained vocabulary has the committed piece set but other ids, and the
committed encoder's and judge's embedding rows would no longer match them.

The vocabulary is the one WordPieceTrainer learns under the JAX package's
setup: words are the normalised (NFD, lowercase, accents stripped) and
pre-tokenised (whitespace split, punctuation isolated) pieces of each
paragraph, counted; the five specials come first, then every character
seen, then every character seen past the start of a word behind the "##"
prefix; then byte-pair merges of the most frequent adjacent pair (ties to
the pair of smaller ids) until the vocabulary holds vocab_size entries. A
merge of (a, b) adds a + b, with b's "##" dropped. The merge loop is the
trainer's own, step for step: a queue of (count, pair, words) entries,
counts kept up to date incrementally from each merge's changes, stale
entries re-queued with their current count, and only the entry's words
merged (a pair that gains new occurrences after its merge is merged again
in those words, adding no entry to the vocabulary).

Ids are deterministic: specials, the alphabet by code point, the "##"
characters by code point, merges in merge order, then the added words.
``tokenizers`` assigns the "##" characters in hash-map order, so its ids
differ from run to run while its piece set does not; the piece set is the
one this module must reproduce. "yes" and "no" must each be one piece (the
reranker reads their logits): a word the vocabulary splits is appended as
an added token, as the JAX trainer's add_tokens appends it.

The file is tokenizer.json in the schema ``tokenizers`` writes; the port's
WordPieceTokenizer and NativeWordPieceTokenizer and
``tokenizers.Tokenizer.from_file`` load it.
"""

from __future__ import annotations

import argparse
import heapq
import json
import os
import tempfile
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

from rust_local_rag_tpu_torch.models.tokenizer import WordPieceTokenizer, _normalize, _pre_tokenize

VOCAB_SIZE = 8192
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
PREFIX = "##"
MAX_INPUT_CHARS_PER_WORD = 64
FORCED_WORDS = ("yes", "no")

Pair = Tuple[int, int]


def word_counts(paragraphs: Sequence[str]) -> Counter:
    """{word: occurrences} over the normalised, pre-tokenised paragraphs."""
    counts: Counter = Counter()
    for p in paragraphs:
        counts.update(_pre_tokenize(_normalize(p)))
    return counts


def _merge_word(syms: List[int], a: int, b: int, new: int) -> List[Tuple[Pair, int]]:
    """Merge every (a, b) of syms into new, left to right, in place; -> the
    pair count changes of this word (the merged pair's own not included)."""
    changes: List[Tuple[Pair, int]] = []
    i = 0
    while i < len(syms):
        if syms[i] == a and i + 1 < len(syms) and syms[i + 1] == b:
            if i > 0:
                prev = syms[i - 1]
                changes.append(((prev, a), -1))
                changes.append(((prev, new), 1))
            syms[i:i + 2] = [new]
            if i < len(syms) - 1:
                nxt = syms[i + 1]
                changes.append(((b, nxt), -1))
                changes.append(((new, nxt), 1))
        i += 1
    return changes


def train_vocab(counts: Dict[str, int], vocab_size: int = VOCAB_SIZE,
                prefixed_order: Optional[Sequence[str]] = None) -> List[str]:
    """The vocabulary, in id order, that WordPieceTrainer learns from these
    word counts (see the module docstring). `prefixed_order` gives the ids
    of the "##" characters (default: by code point), the one choice
    ``tokenizers`` leaves to its hash maps."""
    id_to_word: List[str] = []
    word_to_id: Dict[str, int] = {}

    def add(token: str) -> int:
        if token not in word_to_id:
            word_to_id[token] = len(id_to_word)
            id_to_word.append(token)
        return word_to_id[token]

    for s in SPECIALS:
        add(s)
    for c in sorted({c for w in counts for c in w}):
        add(c)
    prefixed = sorted({PREFIX + c for w in counts for c in w[1:]})
    if prefixed_order is not None:
        if sorted(prefixed_order) != prefixed:
            raise ValueError("prefixed_order is not the set of continuing characters")
        prefixed = list(prefixed_order)
    for token in prefixed:
        add(token)
    words = [[word_to_id[w[0]]] + [word_to_id[PREFIX + c] for c in w[1:]] for w in counts]
    weights = list(counts.values())

    pair_counts: Dict[Pair, int] = defaultdict(int)
    where: Dict[Pair, Set[int]] = defaultdict(set)
    for i, (syms, n) in enumerate(zip(words, weights)):
        for pair in zip(syms, syms[1:]):
            pair_counts[pair] += n
            where[pair].add(i)
    # max count first, ties to the smaller pair; seq keeps equal keys in
    # push order and never lets the heap compare two word sets
    queue: list = []
    seq = 0

    def push_updates() -> None:
        """Queue each pair of `where` with its words and current count."""
        nonlocal seq
        for pair, pos in where.items():
            count = pair_counts[pair]
            if count > 0:
                heapq.heappush(queue, (-count, pair[0], pair[1], seq, pos))
                seq += 1
        where.clear()

    push_updates()
    while len(id_to_word) < vocab_size and queue:
        neg, a, b, order, pos = heapq.heappop(queue)
        count = pair_counts[(a, b)]
        if -neg != count:
            heapq.heappush(queue, (-count, a, b, order, pos))
            continue
        if count < 1:
            break
        part_b = id_to_word[b]
        new = add(id_to_word[a] + (part_b[len(PREFIX):] if part_b.startswith(PREFIX) else part_b))
        for i in pos:
            n = weights[i]
            for pair, change in _merge_word(words[i], a, b, new):
                pair_counts[pair] += change * n
                if change > 0:
                    where[pair].add(i)
        push_updates()
    return id_to_word


def _added(content: str, tid: int, special: bool) -> dict:
    return {"id": tid, "content": content, "single_word": False, "lstrip": False, "rstrip": False,
            "normalized": not special, "special": special}


def _template(pair: bool) -> list:
    seq = [{"SpecialToken": {"id": "[CLS]", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
           {"SpecialToken": {"id": "[SEP]", "type_id": 0}}]
    if pair:
        seq += [{"Sequence": {"id": "B", "type_id": 0}}, {"SpecialToken": {"id": "[SEP]", "type_id": 0}}]
    return seq


def tokenizer_spec(vocab: Sequence[str], added: Sequence[str] = ()) -> dict:
    """tokenizer.json of a WordPiece vocabulary (ids in list order) with the
    JAX trainer's normaliser, pre-tokeniser, template and decoder, and the
    `added` words appended after the vocabulary."""
    ids = {t: i for i, t in enumerate(vocab)}
    added_tokens = [_added(s, ids[s], True) for s in SPECIALS]
    added_tokens += [_added(w, len(vocab) + i, False) for i, w in enumerate(added)]
    return {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": added_tokens,
        "normalizer": {"type": "Sequence", "normalizers": [{"type": "NFD"}, {"type": "Lowercase"},
                                                          {"type": "StripAccents"}]},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [{"type": "WhitespaceSplit"},
                                                               {"type": "Punctuation", "behavior": "Isolated"}]},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": _template(False),
            "pair": _template(True),
            "special_tokens": {t: {"id": t, "ids": [ids[t]], "tokens": [t]} for t in ("[CLS]", "[SEP]")},
        },
        "decoder": {"type": "WordPiece", "prefix": PREFIX, "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": PREFIX,
                  "max_input_chars_per_word": MAX_INPUT_CHARS_PER_WORD, "vocab": ids},
    }


def _pieces(tok: WordPieceTokenizer, word: str) -> List[int]:
    ids = tok.tokenize_full(word)
    return ids[1:-1]  # without [CLS] ... [SEP]


def train_tokenizer(paragraphs: Sequence[str], out_path: str, vocab_size: int = VOCAB_SIZE) -> None:
    """Train a WordPiece vocabulary on `paragraphs` and write tokenizer.json
    to out_path (see the module docstring)."""
    vocab = train_vocab(word_counts(paragraphs), vocab_size)
    spec = tokenizer_spec(vocab)
    tok = WordPieceTokenizer(out_path, spec=spec)
    added = [w for w in FORCED_WORDS if len(_pieces(tok, w)) != 1]
    if added:
        spec = tokenizer_spec(vocab, added)
        tok = WordPieceTokenizer(out_path, spec=spec)
    for w in FORCED_WORDS:
        if len(_pieces(tok, w)) != 1:
            raise RuntimeError(f"{w!r} is not a single piece: {_pieces(tok, w)}")
    write_spec(spec, out_path)


def write_spec(spec: dict, path: str) -> None:
    """The JSON as ``tokenizers`` saves it (two-space indent, UTF-8 text),
    written atomically."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(spec, f, ensure_ascii=False, indent=2)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _default_out() -> str:
    from rust_local_rag_tpu_torch.models.encoder import default_asset

    return default_asset("tokenizer.json")


def main(argv: Optional[List[str]] = None) -> None:
    from rust_local_rag_tpu_torch.training.corpus import harvest, load_paragraphs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", help="pre-harvested paragraph file (one/line)")
    ap.add_argument("--out", default=_default_out())
    ap.add_argument("--vocab-size", type=int, default=VOCAB_SIZE)
    ap.add_argument("--force", action="store_true", help="overwrite --out if it exists")
    args = ap.parse_args(argv)
    if os.path.exists(args.out) and not args.force:
        ap.error(f"{args.out} exists (the committed checkpoints' ids depend on it); pass --force to overwrite it")

    paragraphs = load_paragraphs(args.corpus) if args.corpus else harvest()
    print(f"training WordPiece vocab={args.vocab_size} on {len(paragraphs)} paragraphs")
    train_tokenizer(paragraphs, args.out, args.vocab_size)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
