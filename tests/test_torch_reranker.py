"""Port parity of the reranker: the model (a small random JAX config carried
across with params_from_jax), the committed checkpoint through both
TransformerRerankers, the judge's head + tail tokenisation, and the
reranker service's prompts, fallback and calibration.

Tolerances, each from what differs between the two sides:
  * small random model, last-position logits: atol 2e-2 and the same
    argmax, fused attention on (Pallas in interpret mode / the port's plain
    twin) and off. Both run bf16 activations with f32 accumulation but
    round to bf16 at other places; the differences seen are ~5e-3 on
    logits of magnitude ~1. This tightens the JAX package's own bound of
    atol 0.1 / rtol 0.05 between its fused and plain paths
    (tests/test_attention.py), and the same 2e-2 holds the port's fused and
    plain paths together;
  * committed reranker, 5 prompts: yes/no logprobs within 0.05 and scores
    (yes-probabilities) within 0.01; the differences seen are 0.021 and
    0.004, the same bf16 rounding through 4 layers;
  * token ids, prompt strings: identical.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_local_rag_tpu.models import reranker as jrr
from rust_local_rag_tpu.models import reranker_service as jsvc
from rust_local_rag_tpu.models.tokenizer import load_tokenizer as jax_load_tokenizer
from rust_local_rag_tpu_torch.models import reranker as trr
from rust_local_rag_tpu_torch.models import reranker_service as tsvc
from rust_local_rag_tpu_torch.models.checkpoint import params_from_jax
from rust_local_rag_tpu_torch.models.encoder import default_asset
from rust_local_rag_tpu_torch.models.tokenizer import HashTokenizer as THash
from rust_local_rag_tpu_torch.models.tokenizer import load_tokenizer

LOGIT_ATOL = 2e-2
LOGPROB_ATOL = 0.05
SCORE_ATOL = 0.01

SMALL = dict(vocab_size=512, dim=128, depth=2, heads=2, ffn_dim=256)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small_pair():
    jcfg = jrr.RerankerConfig(**SMALL)
    params = jrr.init_reranker_params(jax.random.PRNGKey(1), jcfg)
    model = trr.Reranker(trr.RerankerConfig(**SMALL))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, model


def _ids(seed, b=4, l=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 512, size=(b, l)).astype(np.int32)
    lens = rng.integers(4, l, size=b)
    lens[0] = 1
    mask = (np.arange(l)[None] < lens[:, None]).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("fused", [False, True])
def test_small_reranker_logits_match_jax(fused):
    jcfg, params, model = _small_pair()
    ids, mask = _ids(1)
    want = np.asarray(
        jrr.reranker_forward_last_logits(params, jnp.asarray(ids), jnp.asarray(mask), jcfg, fused_attn=fused)
    )
    with torch.inference_mode():
        got = model.forward_last_logits(torch.from_numpy(ids), torch.from_numpy(mask), fused_attn=fused)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)
    assert np.array_equal(got.numpy().argmax(axis=1), want.argmax(axis=1))


def test_small_reranker_fused_matches_plain_and_yes_no():
    _, _, model = _small_pair()
    ids, mask = _ids(2, b=5, l=192)
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.inference_mode():
        off = model.forward_last_logits(t_ids, t_mask, fused_attn=False).numpy()
        on = model.forward_last_logits(t_ids, t_mask, fused_attn=True).numpy()
        y, n = trr.yes_no_logprobs(model, t_ids, t_mask, 7, 9, fused_attn=False)
    np.testing.assert_allclose(on, off, atol=LOGIT_ATOL, rtol=0)
    assert np.array_equal(on.argmax(axis=1), off.argmax(axis=1))
    lp = torch.log_softmax(torch.from_numpy(off), dim=-1)
    np.testing.assert_allclose(y.numpy(), lp[:, 7].numpy(), atol=1e-6)
    np.testing.assert_allclose(n.numpy(), lp[:, 9].numpy(), atol=1e-6)


def test_state_dict_names_and_config():
    model = trr.Reranker(trr.RerankerConfig(**SMALL), torch.Generator().manual_seed(3))
    names = set(model.state_dict())
    assert {"embed", "final_norm", "lm_head", "layers.0.wq", "layers.1.w_down"} <= names
    cfg = trr.RerankerConfig(**SMALL)
    assert trr.RerankerConfig.from_json(cfg.to_json()) == cfg
    assert cfg.to_json() == jrr.RerankerConfig(**SMALL).to_json()


def test_softmax_yes_no_matches_jax():
    for y, n in [(-0.1, -2.3), (None, -1.0), (-3.0, None), (None, None), (-50.0, -0.01)]:
        assert trr.softmax_yes_no(y, n) == jrr.softmax_yes_no(y, n)


def _prompts():
    rng = np.random.default_rng(0)
    words = "pump valve seal bearing motor pressure leak shaft replace inspect the a of to and".split()
    return [
        "Query: how to replace the pump seal\nDocument: m.pdf\nPage: 3\n\nChunk:\n"
        + " ".join(rng.choice(words, n))
        + "\n\nDoes this chunk contain relevant information for the query?\nAnswer:"
        for n in (5, 30, 80, 200, 400)
    ]


@pytest.fixture(scope="module")
def committed_pair():
    j = jrr.TransformerReranker(
        weights_path=default_asset("reranker.safetensors"), tokenizer_path=default_asset("tokenizer.json")
    )
    t = trr.TransformerReranker.from_assets(device="cpu")
    return j, t


def test_committed_reranker_matches_jax(committed_pair, monkeypatch):
    monkeypatch.delenv("RAG_TPU_FUSED_ATTN", raising=False)
    j, t = committed_pair
    assert (t.judge_seq_len, t._yes_id, t._no_id) == (j.judge_seq_len, j._yes_id, j._no_id) == (192, 8192, 667)
    assert t.cfg.to_json() == j.cfg.to_json()
    prompts = _prompts()
    want = np.asarray(j.score_prompts(prompts))
    got = np.asarray(t.score_prompts(prompts))
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=LOGPROB_ATOL, rtol=0)
    split = t.fetch_prompts(t.dispatch_prompts(prompts))
    np.testing.assert_array_equal(np.asarray(split), got)
    assert t.score_prompts([]) == []


def test_committed_reranker_fused_path(committed_pair, monkeypatch):
    """RAG_TPU_FUSED_ATTN=1 routes the judge through fused_attention (on
    the CPU its plain twin); the scores stay within the stated bounds of
    the plain path."""
    _, t = committed_pair
    prompts = _prompts()
    monkeypatch.setenv("RAG_TPU_FUSED_ATTN", "0")
    off = np.asarray(t.score_prompts(prompts))
    monkeypatch.setenv("RAG_TPU_FUSED_ATTN", "1")
    on = np.asarray(t.score_prompts(prompts))
    np.testing.assert_allclose(on[:, 0], off[:, 0], atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(on[:, 1:], off[:, 1:], atol=LOGPROB_ATOL, rtol=0)


def test_batch_padding_rows(committed_pair):
    _, t = committed_pair
    ids, mask = t.encode(_prompts()[:3])
    assert ids.shape == mask.shape == (4, 192) and ids.dtype == np.int32
    assert mask[3].tolist() == [1] + [0] * 191 and ids[3].sum() == 0


@pytest.mark.parametrize("n_words", [3, 40, 150, 600])
def test_headtail_ids_match_jax_tokenizer(n_words):
    """Prompts shorter and longer than 192 ids: head 64 + tail 128 ids."""
    path = default_asset("tokenizer.json")
    jt = jax_load_tokenizer(path, vocab_size=8193, max_len=512)
    tt = load_tokenizer(path, vocab_size=8193, max_len=512)
    rng = np.random.default_rng(n_words)
    words = "the pump's seal (rev. B) failed; replace it, then check torque: 45 Nm! Ölfilter café".split()
    texts = [" ".join(rng.choice(words, n_words)) + " Answer:" for _ in range(3)] + [""]
    j_ids, j_mask = jt.encode_batch_headtail(texts, 192)
    t_ids, t_mask = tt.encode_batch_headtail(texts, 192)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_mask, j_mask)
    assert t_ids.dtype == np.int32 and t_ids.shape == (4, 192)


def test_hash_tokenizer_headtail_matches_jax():
    from rust_local_rag_tpu.models.tokenizer import HashTokenizer as JHash

    texts = ["word " * 300, "short text", ""]
    for a, b in zip(THash(512).encode_batch_headtail(texts, 64), JHash(512).encode_batch_headtail(texts, 64)):
        np.testing.assert_array_equal(a, b)


def _candidates(mod):
    return [
        mod.RerankerCandidate("c1", "manual.pdf", "  Replace the seal.  ", 0, None, 0.9),
        mod.RerankerCandidate("c2", "guide.pdf", "Torque to 45 Nm.", 7, "  Assembly  ", 0.5),
        mod.RerankerCandidate("c3", "notes.pdf", "{query} stays literal", 2, "   ", 0.1),
    ]


@pytest.mark.parametrize("prompts_dir", ["repo", "empty"])
def test_build_prompt_matches_jax(prompts_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("PROMPTS_DIR", os.path.join(REPO, "prompts") if prompts_dir == "repo" else str(tmp_path))
    j = jsvc.RerankerService(jrr.FakeReranker())
    t = tsvc.RerankerService(trr.FakeReranker())
    if prompts_dir == "empty":
        assert tsvc.load_prompt_template() == jsvc.DEFAULT_PROMPT_TEMPLATE == tsvc.DEFAULT_PROMPT_TEMPLATE
    for tc, jc in zip(_candidates(tsvc), _candidates(jsvc)):
        assert t.build_prompt("  pump seal? ", tc) == j.build_prompt("  pump seal? ", jc)
    p = t.build_prompt("q", _candidates(tsvc)[0])
    assert "Page: unknown" in p and "Replace the seal." in p


def test_rerank_sorts_and_falls_back_with_count():
    t = tsvc.RerankerService(trr.FakeReranker())
    j = jsvc.RerankerService(jrr.FakeReranker())
    got = t.rerank("replace seal", _candidates(tsvc))
    want = j.rerank("replace seal", _candidates(jsvc))
    assert [(r.chunk_id, r.relevance, r.yes_logprob, r.no_logprob) for r in got] == [
        (r.chunk_id, r.relevance, r.yes_logprob, r.no_logprob) for r in want
    ]
    assert t.fallbacks == 0

    class Broken:
        model_name = "broken"

        def score_prompts(self, prompts):
            raise RuntimeError("device lost")

    b = tsvc.RerankerService(Broken())
    res = b.rerank("q", _candidates(tsvc))
    assert [r.chunk_id for r in res] == ["c1", "c2", "c3"]
    assert [r.relevance for r in res] == [0.9, 0.5, 0.1] and res[0].yes_logprob is None
    assert b.fallbacks == 1
    with pytest.raises(ValueError):
        b.calibrate_timeout("q", [], 3)


def test_calibrate_timeout_nearest_rank():
    t = tsvc.RerankerService(trr.FakeReranker())
    cands = _candidates(tsvc) * 4
    stats = t.calibrate_timeout("q", cands, 10)
    assert stats.sample_size == 10
    assert 0 < stats.median_ms <= stats.p95_ms <= stats.p99_ms <= stats.max_ms
    assert stats.mean_ms <= stats.max_ms


def test_build_default_reranker(monkeypatch):
    monkeypatch.delenv("RAG_TPU_RERANK_MODEL", raising=False)
    monkeypatch.delenv("OLLAMA_RERANK_MODEL", raising=False)
    assert tsvc.build_default_reranker("cpu") is None
    monkeypatch.setenv("OLLAMA_RERANK_MODEL", "judge-v15")
    svc = tsvc.build_default_reranker("cpu")
    assert svc.model_name == "judge-v15" and isinstance(svc._model, trr.TransformerReranker)


def test_transformer_reranker_refuses_cuda_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = trr.Reranker(trr.RerankerConfig(**SMALL))
    with pytest.raises(RuntimeError, match="cuda"):
        trr.TransformerReranker(model, THash(512))
