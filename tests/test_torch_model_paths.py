"""ROADMAP C13: the port resolves its model files as the JAX package does
(explicit argument, then ENCODER_WEIGHTS / RERANKER_WEIGHTS /
TOKENIZER_PATH, then the committed asset), starts from a seeded random
init with JAX's log line where a named weights file does not exist, and
keys its mining caches on the resolved files.

The checkpoints are small JAX models written with the JAX package's own
save_params, with the metadata its trainers write; the tokenizer is
trained on eval-corpus paragraphs by the JAX package's trainer (400
pieces, so its ids differ from the committed tokenizer's).

Tolerances, as in tests/test_torch_encoder.py and test_torch_reranker.py:
embeddings max |diff| <= 2e-2 on unit vectors and cosine >= 0.999 (bf16
activations rounded at other places); yes-probabilities within 0.01 and
logprobs within 0.05; token ids identical. The random inits cannot equal
JAX's (threefry is not torch's generator: ROADMAP C, pinned), so they are
held by the log line, the config, the shapes and the same output for the
same seed.
"""

import logging
import os

import jax
import numpy as np
import pytest

from eval_harness.corpus_data import DOCS
from rust_local_rag_tpu.models import checkpoint as jckpt
from rust_local_rag_tpu.models import embedding_service as jemb
from rust_local_rag_tpu.models import encoder as jenc
from rust_local_rag_tpu.models import reranker as jrr
from rust_local_rag_tpu.models import reranker_service as jsvc
from rust_local_rag_tpu.training import tok as jtok
from rust_local_rag_tpu_torch.models import embedding_service as temb
from rust_local_rag_tpu_torch.models import encoder as tenc
from rust_local_rag_tpu_torch.models import reranker as trr
from rust_local_rag_tpu_torch.models import reranker_service as tsvc
from rust_local_rag_tpu_torch.training import mining

EMB_ATOL, MIN_COS = 2e-2, 0.999
SCORE_ATOL, LOGPROB_ATOL = 0.01, 0.05
ENC = dict(vocab_size=512, dim=64, depth=2, heads=4, ffn_dim=96, max_len=128, out_dim=48)
RR = dict(vocab_size=512, dim=64, depth=2, heads=4, ffn_dim=96, max_len=256)
TRAIN_SEQ_LEN = 96
TEXTS = ["How do I replace the pump seal?", "Torque the flange bolts to 45 Nm in a star pattern.",
         "Sourdough needs a mature starter", "galaxies and nebulae"]
MODEL_VARS = ("ENCODER_WEIGHTS", "RERANKER_WEIGHTS", "TOKENIZER_PATH", "RAG_TPU_FAKE_ENCODER",
              "RAG_TPU_FAKE_RERANKER", "RAG_TPU_FUSED_ATTN")


def _paragraphs(n=300):
    out = [p for d in DOCS for page in d["pages"] for p in page.split("\n") if p.strip()]
    return out[:n]


def _encoder_file(path, seed):
    cfg = jenc.EncoderConfig(**ENC)
    params = jenc.init_encoder_params(jax.random.PRNGKey(seed), cfg)
    jckpt.save_params(params, str(path), metadata={"encoder_config": cfg.to_json(), "query_prefix": "search_query: ",
                                                   "document_prefix": "search_document: "})
    return str(path)


def _reranker_file(path, seed):
    cfg = jrr.RerankerConfig(**RR)
    params = jrr.init_reranker_params(jax.random.PRNGKey(seed), cfg)
    jckpt.save_params(params, str(path), metadata={"reranker_config": cfg.to_json(),
                                                   "train_seq_len": str(TRAIN_SEQ_LEN)})
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("model_paths")
    tok = str(d / "tokenizer.json")
    jtok.train_tokenizer(_paragraphs(), tok, 400)
    return {"tokenizer": tok, "encoder": _encoder_file(d / "encoder.safetensors", 3),
            "encoder2": _encoder_file(d / "encoder2.safetensors", 5),
            "reranker": _reranker_file(d / "reranker.safetensors", 4),
            "reranker2": _reranker_file(d / "reranker2.safetensors", 6), "dir": str(d)}


@pytest.fixture
def env(monkeypatch):
    for k in MODEL_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= EMB_ATOL
    assert (np.sum(a * b, axis=1) >= MIN_COS).all()


def _prompts():
    return [f"Query: {q}\nDocument: m.pdf\nPage: 1\n\nChunk:\n{t}\n\nDoes this chunk contain relevant information "
            f"for the query?\nAnswer:" for q, t in zip(TEXTS, reversed(TEXTS))]


def test_encoder_weights_and_tokenizer_path_reach_the_service(files, env):
    env.setenv("ENCODER_WEIGHTS", files["encoder"])
    env.setenv("TOKENIZER_PATH", files["tokenizer"])
    t, j = temb.build_default_service(device="cpu"), jemb.build_default_service()
    assert t.dim == j.dim == 48
    assert t._model.cfg.to_json() == j._model.cfg.to_json() == jenc.EncoderConfig(**ENC).to_json()
    assert t._model._query_prefix == j._model._query_prefix == "search_query: "
    _close(t.get_query_embeddings(TEXTS), j.get_query_embeddings(TEXTS))
    _close(t.embed_in_batches(TEXTS), j.embed_in_batches(TEXTS))
    for text in TEXTS:
        assert list(t._model.tokenizer.tokenize(text)) == [int(x) for x in j._model.tokenizer.tokenize(text)]


def test_tokenizer_path_changes_the_ids(files, env):
    committed = tenc.TransformerEncoderModel.from_assets(weights_path=files["encoder"], device="cpu")
    env.setenv("TOKENIZER_PATH", files["tokenizer"])
    named = tenc.TransformerEncoderModel.from_assets(weights_path=files["encoder"], device="cpu")
    jnamed = jenc.TransformerEncoderModel(weights_path=files["encoder"])
    ids = [named.tokenizer.tokenize(x) for x in TEXTS]
    assert ids == [[int(i) for i in jnamed.tokenizer.tokenize(x)] for x in TEXTS]
    assert ids != [committed.tokenizer.tokenize(x) for x in TEXTS]


def test_reranker_weights_reach_the_service(files, env):
    env.setenv("RERANKER_WEIGHTS", files["reranker"])
    env.setenv("TOKENIZER_PATH", files["tokenizer"])
    env.setenv("RAG_TPU_RERANK_MODEL", "tpu-reranker")
    t, j = tsvc.build_default_reranker("cpu"), jsvc.build_default_reranker()
    assert (t._model.judge_seq_len, t._model._yes_id, t._model._no_id) == (
        j._model.judge_seq_len, j._model._yes_id, j._model._no_id)
    assert t._model.judge_seq_len == TRAIN_SEQ_LEN and t._model.cfg.to_json() == j._model.cfg.to_json()
    got, want = np.asarray(t.score_prompts(_prompts())), np.asarray(j.score_prompts(_prompts()))
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=LOGPROB_ATOL, rtol=0)


def _messages(caplog, name):
    return [r.getMessage() for r in caplog.records if r.name.endswith(name) and "random init" in r.getMessage()]


def test_missing_weights_start_from_a_seeded_random_init(files, env, caplog):
    missing = os.path.join(files["dir"], "missing.safetensors")
    env.setenv("ENCODER_WEIGHTS", missing)
    env.setenv("RERANKER_WEIGHTS", missing)
    env.setenv("TOKENIZER_PATH", files["tokenizer"])
    caplog.set_level(logging.INFO)
    cfg = tenc.EncoderConfig(**ENC)
    a = tenc.TransformerEncoderModel.from_assets(cfg=cfg, device="cpu")
    j = jenc.TransformerEncoderModel(cfg=jenc.EncoderConfig(**ENC))
    assert _messages(caplog, "models.encoder") == ["Encoder running with seeded random init (no weights file)"] * 2
    b = tenc.TransformerEncoderModel.from_assets(cfg=cfg, device="cpu")
    c = tenc.TransformerEncoderModel.from_assets(cfg=cfg, device="cpu", seed=7)
    ea, eb, ec, ej = (m.encode(TEXTS) for m in (a, b, c, j))
    assert ea.shape == ej.shape == (4, 48) and a.cfg.to_json() == j.cfg.to_json()
    assert np.array_equal(ea, eb) and not np.allclose(ea, ec)
    np.testing.assert_allclose(np.linalg.norm(ea, axis=1), 1.0, atol=1e-5)

    caplog.clear()
    rcfg = trr.RerankerConfig(**RR)
    ra = trr.TransformerReranker.from_assets(cfg=rcfg, device="cpu")
    rj = jrr.TransformerReranker(cfg=jrr.RerankerConfig(**RR))
    assert _messages(caplog, "models.reranker") == ["Reranker running with seeded random init"] * 2
    rb = trr.TransformerReranker.from_assets(cfg=rcfg, device="cpu")
    assert ra.judge_seq_len == rj.judge_seq_len == 192 and ra.cfg.to_json() == rj.cfg.to_json()
    sa, sb = np.asarray(ra.score_prompts(_prompts())), np.asarray(rb.score_prompts(_prompts()))
    assert sa.shape == (4, 3) and np.isfinite(sa).all() and np.array_equal(sa, sb)


def test_services_with_missing_weights_serve_the_default_configs(files, env, caplog):
    """build_default_service / build_default_reranker with a named file that
    does not exist: random models at the default configs on both sides,
    never the committed assets."""
    missing = os.path.join(files["dir"], "missing.safetensors")
    env.setenv("ENCODER_WEIGHTS", missing)
    env.setenv("RERANKER_WEIGHTS", missing)
    env.setenv("TOKENIZER_PATH", files["tokenizer"])
    env.setenv("RAG_TPU_RERANK_MODEL", "tpu-reranker")
    caplog.set_level(logging.INFO)
    t = temb.build_default_service(device="cpu")
    assert t._model.cfg == tenc.EncoderConfig() and t.dim == 768
    assert t.get_query_embeddings(TEXTS[:1]).shape == (1, 768)
    r = tsvc.build_default_reranker("cpu")
    assert r is not None and r._model.cfg == trr.RerankerConfig() and r._model.judge_seq_len == 192
    assert _messages(caplog, "models.encoder") == ["Encoder running with seeded random init (no weights file)"]
    assert _messages(caplog, "models.reranker") == ["Reranker running with seeded random init"]


def test_explicit_arguments_win_over_the_variables(files, env):
    env.setenv("ENCODER_WEIGHTS", files["encoder"])
    env.setenv("RERANKER_WEIGHTS", files["reranker"])
    env.setenv("TOKENIZER_PATH", files["tokenizer"])
    enc = tenc.TransformerEncoderModel.from_assets(weights_path=tenc.default_asset("encoder.safetensors"),
                                                   tokenizer_path=tenc.default_asset("tokenizer.json"), device="cpu")
    assert (enc.cfg.dim, enc.dim) == (512, 768)
    assert enc.tokenizer.tokenize("yes") != tenc.TransformerEncoderModel.from_assets(device="cpu").tokenizer.tokenize("yes")
    rr = trr.TransformerReranker.from_assets(weights_path=tenc.default_asset("reranker.safetensors"),
                                             tokenizer_path=tenc.default_asset("tokenizer.json"), device="cpu")
    assert (rr.cfg.dim, rr.judge_seq_len, rr._yes_id, rr._no_id) == (384, 192, 8192, 667)
    assert tenc.resolve_model_file("x", "ENCODER_WEIGHTS", "encoder.safetensors") == "x"
    env.delenv("ENCODER_WEIGHTS")
    assert tenc.resolve_model_file(None, "ENCODER_WEIGHTS", "encoder.safetensors") == tenc.default_asset(
        "encoder.safetensors")


def test_reranker_start_up_failure_gives_none_as_jax(files, env, tmp_path):
    """A named judge that cannot be loaded (here a truncated file) is
    logged and gives no reranker on both sides: JAX catches Exception."""
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(b"\x10\x00\x00\x00\x00\x00\x00\x00{")
    env.setenv("RERANKER_WEIGHTS", str(bad))
    env.setenv("RAG_TPU_RERANK_MODEL", "tpu-reranker")
    assert tsvc.build_default_reranker("cpu") is None
    assert jsvc.build_default_reranker() is None


def _cache_files(home):
    d = os.path.join(home, ".cache", "rag_tpu_premine")
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def test_mining_follows_the_variables(files, env, tmp_path):
    """The dense and junk mining caches are keyed on the resolved weights:
    a new ENCODER_WEIGHTS or RERANKER_WEIGHTS is a new key, the same ones
    hit the cache; a named encoder that does not exist stops dense mining
    (and its gate), as the committed asset's absence did."""
    env.setenv("HOME", str(tmp_path))
    env.setenv("TOKENIZER_PATH", files["tokenizer"])
    env.setenv("ENCODER_WEIGHTS", files["encoder"])
    env.setenv("RERANKER_WEIGHTS", files["reranker"])
    texts = _paragraphs(24)
    table, stats = mining.cached_denoised_table(texts, n_neighbors=2, device="cpu")
    assert table.shape == (24, 2) and stats["pairs"] > 0
    first = _cache_files(str(tmp_path))
    assert len(first) == 1
    again, _ = mining.cached_denoised_table(texts, n_neighbors=2, device="cpu")
    assert np.array_equal(again, table) and _cache_files(str(tmp_path)) == first
    env.setenv("RERANKER_WEIGHTS", files["reranker2"])
    mining.cached_denoised_table(texts, n_neighbors=2, device="cpu")
    env.setenv("ENCODER_WEIGHTS", files["encoder2"])
    mining.cached_denoised_table(texts, n_neighbors=2, device="cpu")
    assert len(_cache_files(str(tmp_path))) == 3

    junk = ["wormhole nonsense", "quantum tomato"]
    mining.mine_junk_neighbors(junk, texts, device="cpu")
    env.setenv("ENCODER_WEIGHTS", files["encoder"])
    mining.mine_junk_neighbors(junk, texts, device="cpu")
    mining.mine_junk_neighbors(junk, texts, device="cpu")
    assert len([f for f in _cache_files(str(tmp_path)) if "junk_" in f]) == 2

    env.setenv("ENCODER_WEIGHTS", os.path.join(files["dir"], "missing.safetensors"))
    assert mining.mine_dense_neighbors(texts, device="cpu") is None
    with pytest.raises(RuntimeError, match="encoder"):
        mining.cached_denoised_table(texts[:10], n_neighbors=2, device="cpu")
    env.setenv("RERANKER_WEIGHTS", os.path.join(files["dir"], "missing.safetensors"))
    with pytest.raises(RuntimeError, match="reranker"):
        mining.denoise_with_reranker(texts, table, device="cpu")
