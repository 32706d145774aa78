"""Boundaries of the port: what it may import, and that its CUDA entry
points refuse to run when there is no card instead of using the CPU."""

import ast
import os
import subprocess
import sys

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
from rust_local_rag_tpu_torch.server.app import build_runtime

PKG = os.path.dirname(rust_local_rag_tpu_torch.__file__)
ROOT = os.path.dirname(PKG)
# the card's machine has none of safetensors, tokenizers, aiohttp and the
# JAX training stack (optax, flax, orbax: installed here, so a trainer that
# picked one up would pass on the CPU only); the eval harness's client and
# runner import requests and yaml, its CLI rich; scripts/ holds the JAX
# experiments
FORBIDDEN = ("jax", "jaxlib", "rust_local_rag_tpu", "scripts", "safetensors", "tokenizers", "aiohttp", "requests",
             "yaml", "rich", "optax", "flax", "orbax")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "score_segmax_timing.py")]
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


# eval_harness's stdlib modules (corpus, its data, metrics) are the port's to
# use; these three import requests and yaml
FORBIDDEN_MODULES = ("eval_harness.client", "eval_harness.runner", "eval_harness.run")


def _forbidden_modules(path):
    """Imports of FORBIDDEN_MODULES in path, `from eval_harness import
    client` included."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            names = [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            names = [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
        hits = [m for m in FORBIDDEN_MODULES for n in names if isinstance(n, str) and (n == m or n.startswith(m + "."))]
        yield from dict.fromkeys(hits)


def test_port_imports_no_eval_harness_client_or_runner(tmp_path):
    bad = {os.path.relpath(p, ROOT): list(_forbidden_modules(p)) for p in _port_files()}
    assert not {k: v for k, v in bad.items() if v}
    p = tmp_path / "m.py"
    p.write_text("from eval_harness import metrics, client\nimport eval_harness.runner\n"
                 "from eval_harness.run import main\nfrom eval_harness.corpus import generate_corpus\n")
    assert list(_forbidden_modules(str(p))) == ["eval_harness.client", "eval_harness.runner", "eval_harness.run"]


def test_ast_check_sees_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom rust_local_rag_tpu.ops import hybrid\n")
    assert [m.split(".")[0] for m in _imported(str(p))] == ["jax", "rust_local_rag_tpu"]


def test_ast_check_sees_the_jax_training_stack(tmp_path):
    """optax, flax and orbax are importable on this host, so only the
    check keeps the trainers off them; it sees every import form."""
    import importlib.util

    assert importlib.util.find_spec("optax") is not None
    p = tmp_path / "m.py"
    p.write_text("import optax\nfrom flax import linen as nn\nimport orbax.checkpoint as ocp\n"
                 "def f():\n    return __import__('optax')\n")
    hits = [m for m in _imported(str(p)) if m.split(".")[0] in FORBIDDEN]
    assert hits == ["optax", "flax", "orbax.checkpoint", "optax"]
    assert any(os.path.relpath(f, PKG).startswith("training") for f in _port_files())


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


def test_entry_points_default_to_cuda_and_refuse(no_card, tmp_path, monkeypatch):
    with pytest.raises(RuntimeError):
        ChunkStore(8)
    with pytest.raises(RuntimeError):
        RagEngine(str(tmp_path), EmbeddingService(_Fake()))
    with pytest.raises(RuntimeError):
        TransformerEncoderModel(Encoder(EncoderConfig(vocab_size=16, dim=8, depth=1, heads=2, ffn_dim=8, out_dim=8)),
                                HashTokenizer(16))
    with pytest.raises(RuntimeError):
        RagEngine.create(str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        build_runtime(str(tmp_path / "data"), str(tmp_path / "documents"))
    for k in ("DATA_DIR", "DOCUMENTS_DIR", "LOG_DIR"):
        monkeypatch.setenv(k, str(tmp_path / k.lower()))
    monkeypatch.delenv("RAG_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_runtime()  # DATA_DIR / DOCUMENTS_DIR from the environment
    assert not os.listdir(tmp_path)
    # the server's entry point: without RAG_TPU_PLATFORM=cpu it asks for
    # the card, and with none visible it exits 1 before building or binding
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", MCP_HTTP_BIND="127.0.0.1:0",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "rust_local_rag_tpu_torch"], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "Startup failed" in proc.stderr and "cuda" in proc.stderr
    assert sorted(os.listdir(tmp_path)) == ["log_dir"]  # the log file only


@pytest.mark.parametrize("name", ["split_pipeline", "split2", "stream_kernel", "isolate_kernel", "isolate2",
                                  "dma_probe"])
def test_experiment_entry_points_refuse_without_card(no_card, name):
    """`python -m rust_local_rag_tpu_torch.experiments.<name>` runs on the
    card by default and raises without one, before it makes any data."""
    import importlib

    mod = importlib.import_module(f"rust_local_rag_tpu_torch.experiments.{name}")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])


def test_kernel_build_is_content_addressed(tmp_path, monkeypatch):
    a = build.library_path("score_segmax")
    assert a == build.library_path("score_segmax")
    assert os.path.dirname(a) == build.BUILD_DIR and "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert set(build.SIGNATURES) == {"score_segmax", "attention", "segmax", "stream_probe", "resident_dot",
                                     "lexical", "wordpiece", "serializer", "pdftext"}
    assert build.library_path("attention") != a
    # the host sources and the g++ flags are part of every library's hash
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("score_segmax.cu", "lexical.cpp"):
        (csrc / name).write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    before = build.library_path("score_segmax"), build.library_path("lexical")
    (csrc / "lexical.cpp").write_text("// v2\n")
    after = build.library_path("score_segmax"), build.library_path("lexical")
    monkeypatch.setattr(build, "GXX_FLAGS", build.GXX_FLAGS + ("-g",))
    assert len({before, after, (build.library_path("score_segmax"), build.library_path("lexical"))}) == 3
    assert all(x != y for x, y in zip(before, after))


def test_host_libraries_build_with_gxx_and_never_ask_for_nvcc(monkeypatch):
    """The host tier builds and loads on a machine without nvcc (as the CPU
    tests run), from the port's own csrc/*.cpp, never native/."""
    def no_nvcc():
        raise AssertionError("a host library asked for nvcc")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    res = build.build_all(build.HOST_LIBRARIES)
    for name in build.HOST_LIBRARIES:
        assert res[name].path == build.library_path(name) and os.path.exists(res[name].path)
        assert build._source(name) == os.path.join(build.CSRC_DIR, f"{name}.cpp")
        lib = build.load(name)
        assert os.path.dirname(lib._name) == build.BUILD_DIR
        for fn in build.SIGNATURES[name]:
            assert getattr(lib, fn).argtypes is not None


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


@pytest.mark.parametrize("module", ["train_encoder", "train_reranker"])
def test_trainers_default_to_cuda_and_refuse(no_card, module, tmp_path):
    """`python -m rust_local_rag_tpu_torch.training.<module>` trains on the
    card unless --device cpu is given, and raises without one before it
    reads any data."""
    import importlib

    mod = importlib.import_module(f"rust_local_rag_tpu_torch.training.{module}")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(["--corpus", str(tmp_path / "missing.txt"), "--out", str(tmp_path / "m.safetensors")])
    assert not os.listdir(tmp_path)
