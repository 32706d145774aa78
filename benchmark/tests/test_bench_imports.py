"""Nothing under benchmark/ imports JAX or the JAX package, and nothing
under benchmark/reference/ imports the program or the harness around it
(top-level names compared whole: rust_local_rag_tpu_torch begins with the
JAX package's name)."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = {"jax", "jaxlib", "flax", "rust_local_rag_tpu"}


def _sources(sub=""):
    root = os.path.join(BENCH, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) and node.value.startswith("module:"):
            names.add(node.value[len("module:"):].split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not _imported(path) & NEVER


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_no_program(path):
    assert not _imported(path) & {"rust_local_rag_tpu_torch", "harness", "drivers"}


def test_the_check_sees_whole_names(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import rust_local_rag_tpu_torch.ops\nfrom jax import numpy\n")
    assert _imported(str(p)) == {"rust_local_rag_tpu_torch", "jax"}
