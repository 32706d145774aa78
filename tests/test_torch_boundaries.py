"""Boundaries of the port: what it may import, and that its CUDA entry
points refuse to run when there is no card instead of using the CPU."""

import ast
import os

import jax  # noqa: F401
import pytest
import torch

import rust_local_rag_tpu_torch
from rust_local_rag_tpu_torch.config import QueryWeights, ResolvedWeights, reset_weight_cache
from rust_local_rag_tpu_torch.device import resolve_device
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkStore
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine
from rust_local_rag_tpu_torch.kernels import build
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService
from rust_local_rag_tpu_torch.models.encoder import Encoder, EncoderConfig, TransformerEncoderModel
from rust_local_rag_tpu_torch.models.tokenizer import HashTokenizer

PKG = os.path.dirname(rust_local_rag_tpu_torch.__file__)
ROOT = os.path.dirname(PKG)
FORBIDDEN = ("jax", "jaxlib", "rust_local_rag_tpu", "safetensors", "tokenizers", "aiohttp")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            yield from (a.value for a in node.args[:1] if isinstance(a, ast.Constant))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_nothing_forbidden(path):
    bad = [m for m in _imported(path) if m and m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_ast_check_sees_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom rust_local_rag_tpu.ops import hybrid\n")
    assert [m.split(".")[0] for m in _imported(str(p))] == ["jax", "rust_local_rag_tpu"]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_refuses_cuda_without_card(no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    with pytest.raises(ValueError):
        resolve_device("meta")


class _Fake:
    dim, model_name = 8, "fake"

    def encode(self, texts):
        raise AssertionError("not reached")


def test_entry_points_default_to_cuda_and_refuse(no_card, tmp_path):
    with pytest.raises(RuntimeError):
        ChunkStore(8)
    with pytest.raises(RuntimeError):
        RagEngine(str(tmp_path), EmbeddingService(_Fake()))
    with pytest.raises(RuntimeError):
        TransformerEncoderModel(Encoder(EncoderConfig(vocab_size=16, dim=8, depth=1, heads=2, ffn_dim=8, out_dim=8)),
                                HashTokenizer(16))
    with pytest.raises(RuntimeError):
        RagEngine.create(str(tmp_path))
    assert not os.listdir(tmp_path)


def test_kernel_build_is_content_addressed():
    a = build.library_path("score_segmax")
    assert a == build.library_path("score_segmax")
    assert os.path.dirname(a) == build.BUILD_DIR and "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert set(build.SIGNATURES) == {"score_segmax", "attention"}
    assert build.library_path("attention") != a


def test_weights_resolve_like_jax(monkeypatch):
    from rust_local_rag_tpu import config as jcfg

    monkeypatch.setenv("RAG_EMBEDDING_WEIGHT", "0.9")
    monkeypatch.setenv("RAG_LEXICAL_WEIGHT", "nan")
    reset_weight_cache()
    jcfg.reset_weight_cache()
    try:
        for w in (None, QueryWeights(embedding=0.2, lexical=2.0), QueryWeights(reranker="x", initial=0.5)):
            jw = jcfg.QueryWeights(w.embedding, w.lexical, w.reranker, w.initial) if w else None
            a = ResolvedWeights.from_query_weights(w)
            b = jcfg.ResolvedWeights.from_query_weights(jw)
            assert [getattr(a, k) for k in a.__slots__] == [getattr(b, k) for k in b.__slots__]
    finally:
        reset_weight_cache()
        jcfg.reset_weight_cache()
