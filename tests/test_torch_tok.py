"""The port's WordPiece trainer (training/tok.py, standard library only)
against the JAX package's (rust_local_rag_tpu/training/tok.py, the
``tokenizers`` package's WordPieceTrainer) on the CPU.

``tokenizers`` gives the "##" characters their ids in hash-map order, which
changes from run to run, and breaks ties between pairs of equal count by
those ids; on a small corpus a tie can change which pieces make the cut,
so its own piece set varies between runs there. The parity test therefore
reads the "##" order out of each JAX file and runs the port from that
order: the port must then write the very same file, byte for byte (every
id, the forced "yes" / "no", the JSON). With its own order (by code point)
the port must reproduce the committed tokenizer's piece set from the
committed corpus, and write the same bytes twice.

Corpora: paragraphs of the eval corpus's authored pages
(eval_harness/corpus_data.py) and of its distractors
(eval_harness/distractors.jsonl), 400 drawn per seed.
"""

import functools
import json
import os

import numpy as np
import pytest
from tokenizers import Tokenizer

from eval_harness.corpus_data import DOCS
from rust_local_rag_tpu.training import tok as jtok
from rust_local_rag_tpu_torch.models.native_tokenizer import NativeWordPieceTokenizer
from rust_local_rag_tpu_torch.models.tokenizer import WordPieceTokenizer
from rust_local_rag_tpu_torch.training import tok

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(ROOT, "rust_local_rag_tpu", "assets", "tokenizer.json")
CORPUS = os.path.join(ROOT, ".cache", "train_corpus.txt")


@functools.lru_cache(maxsize=1)
def _paragraphs():
    out = []
    for d in DOCS:
        for page in d["pages"]:
            out += [p for p in page.split("\n") if p.strip()]
    with open(os.path.join(ROOT, "eval_harness", "distractors.jsonl"), encoding="utf-8") as f:
        for line in f:
            if line.strip():
                for page in json.loads(line)["pages"]:
                    out += [p for p in page.split("\n\n") if p.strip()]
    return tuple(out)


def _corpus(seed: int, n: int = 400):
    pars = _paragraphs()
    rng = np.random.default_rng(seed)
    return [pars[i] for i in rng.choice(len(pars), size=n, replace=False)]


def _pieces(path):
    """Every piece of a tokenizer.json: its vocabulary and added tokens."""
    with open(path, encoding="utf-8") as f:
        d = json.load(f)
    return set(d["model"]["vocab"]) | {t["content"] for t in d["added_tokens"]}


def _prefixed_order(path):
    """The "##" characters of a tokenizer.json in id order."""
    with open(path, encoding="utf-8") as f:
        vocab = json.load(f)["model"]["vocab"]
    return [t for t in sorted(vocab, key=vocab.get) if t.startswith(tok.PREFIX) and len(t) == len(tok.PREFIX) + 1]


@pytest.mark.parametrize("vocab_size", [300, 600, 1000])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_file_as_jax_from_its_prefixed_order(seed, vocab_size, tmp_path, monkeypatch):
    pars = _corpus(seed)
    jtok.train_tokenizer(pars, str(tmp_path / "jax.json"), vocab_size)
    order = _prefixed_order(tmp_path / "jax.json")
    monkeypatch.setattr(tok, "train_vocab", functools.partial(tok.train_vocab, prefixed_order=order))
    tok.train_tokenizer(pars, str(tmp_path / "port.json"), vocab_size)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_own_order_reproduces_the_committed_piece_set(tmp_path):
    """The committed tokenizer was trained on .cache/train_corpus.txt at
    8,192: the port's own ids give exactly its piece set ("yes" added)."""
    from rust_local_rag_tpu_torch.training.corpus import load_paragraphs

    out = tmp_path / "tokenizer.json"
    tok.train_tokenizer(load_paragraphs(CORPUS), str(out))
    got, want = _pieces(out), _pieces(COMMITTED)
    assert len(got) == 8193 and got == want
    with open(out, encoding="utf-8") as f:
        spec = json.load(f)
    assert spec["added_tokens"][-1] == {"id": 8192, "content": "yes", "single_word": False, "lstrip": False,
                                        "rstrip": False, "normalized": True, "special": False}
    vocab = spec["model"]["vocab"]
    assert [t for t in sorted(vocab, key=vocab.get)][:5] == tok.SPECIALS
    # ids: specials, the alphabet by code point, the "##" characters by code point, then merges
    order = sorted(vocab, key=vocab.get)
    alphabet = [t for t in order[5:] if len(t) == 1]
    prefixed = _prefixed_order(out)
    assert order[5:5 + len(alphabet)] == sorted(alphabet)
    assert order[5 + len(alphabet):5 + len(alphabet) + len(prefixed)] == sorted(prefixed)


def test_two_runs_write_the_same_bytes(tmp_path):
    pars = _corpus(3)
    tok.train_tokenizer(pars, str(tmp_path / "a.json"), 800)
    tok.train_tokenizer(list(reversed(pars)), str(tmp_path / "b.json"), 800)
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()


def test_file_loads_in_tokenizers_and_the_ports_tokenizers(tmp_path):
    pars = _corpus(4)
    path = str(tmp_path / "tokenizer.json")
    tok.train_tokenizer(pars, path, 1000)
    hf = Tokenizer.from_file(path)
    py = WordPieceTokenizer(path)
    native = NativeWordPieceTokenizer(path)
    rng = np.random.default_rng(5)
    texts = [" ".join(rng.choice(p.split(), size=min(12, len(p.split())), replace=False)) for p in _corpus(6, 64)]
    texts += ["Yes, no: déjà vu — naïve café façade!", "YES or NO?", "", "a" * 70]
    for t in texts:
        want = hf.encode(t).ids
        assert py.tokenize_full(t) == want, t
        assert native.tokenize_full(t) == want, t
    # the file tokenizers itself writes from it is the same file
    hf.save(str(tmp_path / "resaved.json"))
    assert (tmp_path / "resaved.json").read_bytes() == open(path, "rb").read()


@pytest.mark.parametrize("vocab_size", [300, 3000])
def test_yes_and_no_are_single_pieces(vocab_size, tmp_path):
    """Split by a small vocabulary, both are appended as added tokens after
    it ("yes" first), as the JAX trainer's add_tokens appends them."""
    pars = list(_corpus(7, 1000)) + ["yes no yes no"] * 50
    path = str(tmp_path / "tokenizer.json")
    tok.train_tokenizer(pars, path, vocab_size)
    hf = Tokenizer.from_file(path)
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)
    n = len(spec["model"]["vocab"])
    added = {t["content"]: t["id"] for t in spec["added_tokens"] if not t["special"]}
    for word in tok.FORCED_WORDS:
        ids = hf.encode(word).ids
        assert len(ids) == 3 and WordPieceTokenizer(path).tokenize_full(word) == ids
    if vocab_size == 300:
        assert added == {"yes": n, "no": n + 1}
    else:
        assert added == {} and {"yes", "no"} <= set(spec["model"]["vocab"])


def test_cli_matches_jax(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(_corpus(8)) + "\n", encoding="utf-8")
    tok.main(["--corpus", str(corpus), "--out", str(tmp_path / "port" / "t.json"), "--vocab-size", "500"])
    port_out = capsys.readouterr().out.replace(str(tmp_path / "port"), "<out>")
    jtok.main(["--corpus", str(corpus), "--out", str(tmp_path / "jax" / "t.json"), "--vocab-size", "500"])
    jax_out = capsys.readouterr().out.replace(str(tmp_path / "jax"), "<out>")
    assert port_out == jax_out and port_out.startswith("training WordPiece vocab=500 on 400 paragraphs")
    assert len(_pieces(tmp_path / "port" / "t.json")) == len(_pieces(tmp_path / "jax" / "t.json"))


def test_cli_refuses_to_overwrite_without_force(tmp_path, monkeypatch, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(_corpus(8)) + "\n", encoding="utf-8")
    written = []
    monkeypatch.setattr(tok, "train_tokenizer", lambda paragraphs, out, vocab_size: written.append(out))
    # the default --out is the committed asset: refused before any training
    with pytest.raises(SystemExit) as exc:
        tok.main(["--corpus", str(corpus)])
    assert exc.value.code == 2 and written == []
    assert "--force" in capsys.readouterr().err
    out = tmp_path / "t.json"
    out.write_text("{}", encoding="utf-8")
    with pytest.raises(SystemExit):
        tok.main(["--corpus", str(corpus), "--out", str(out)])
    assert written == [] and out.read_text(encoding="utf-8") == "{}"
    tok.main(["--corpus", str(corpus), "--out", str(out), "--force"])
    assert written == [str(out)]
