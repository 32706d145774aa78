"""Local model-asset discovery (port of rust_local_rag_tpu/models/discovery.py).

The reference's TUI populates its model dropdowns by asking Ollama which
models are pulled (bin/rag_tui/ollama.rs:71-111). A local deployment has
no model server to ask; the equivalent inventory is the set of local
checkpoint artifacts: the committed assets, any file pointed at by
ENCODER_WEIGHTS / RERANKER_WEIGHTS, and every *.safetensors under
RAG_TPU_MODELS_DIR — plus the hermetic fake backends, which are real,
selectable operating modes of this framework.

Each entry: {"name", "kind", "path", "detail"} where kind is
"checkpoint" | "hermetic" | "disabled". A checkpoint's detail comes from
its safetensors header alone (models/checkpoint.read_safetensors_header):
no tensor is read.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from rust_local_rag_tpu_torch.models.checkpoint import read_safetensors_header
from rust_local_rag_tpu_torch.models.encoder import default_asset


def _checkpoint_detail(path: str) -> str:
    """Architecture summary from the safetensors metadata, if embedded."""
    try:
        _, meta = read_safetensors_header(path)
        cfg = meta.get("encoder_config") or meta.get("reranker_config")
        if cfg:
            c = json.loads(cfg)
            arch = f"{c.get('depth', '?')}L x {c.get('dim', '?')}d" + (
                f" -> {c['out_dim']}d" if c.get("out_dim") and c.get("out_dim") != c.get("dim") else "")
            extra = meta.get("trained_steps")
            return arch + (f", {extra} steps" if extra else "")
        return "no embedded config"
    except Exception:  # noqa: BLE001 — unreadable/foreign file
        return "unreadable metadata"


def _seen_add(out: List[Dict], seen: set, path: str, name: str) -> None:
    real = os.path.realpath(path)
    if real in seen or not os.path.isfile(path):
        return
    seen.add(real)
    out.append({"name": name, "kind": "checkpoint", "path": path, "detail": _checkpoint_detail(path)})


def discover_encoder_models() -> List[Dict]:
    out: List[Dict] = []
    seen: set = set()
    _seen_add(out, seen, default_asset("encoder.safetensors"), "assets/encoder.safetensors")
    env = os.environ.get("ENCODER_WEIGHTS")
    if env:
        _seen_add(out, seen, env, env)
    models_dir = os.environ.get("RAG_TPU_MODELS_DIR")
    if models_dir:
        for path in sorted(glob.glob(os.path.join(models_dir, "*.safetensors"))):
            _seen_add(out, seen, path, path)
    out.append({"name": "hash-encoder", "kind": "hermetic", "path": None,
                "detail": "deterministic vocabulary-free encoder (RAG_TPU_FAKE_ENCODER=1)"})
    return out


def discover_rerank_models() -> List[Dict]:
    out: List[Dict] = []
    seen: set = set()
    _seen_add(out, seen, default_asset("reranker.safetensors"), "assets/reranker.safetensors")
    env = os.environ.get("RERANKER_WEIGHTS")
    if env:
        _seen_add(out, seen, env, env)
    models_dir = os.environ.get("RAG_TPU_MODELS_DIR")
    if models_dir:
        for path in sorted(glob.glob(os.path.join(models_dir, "*reranker*.safetensors"))):
            _seen_add(out, seen, path, path)
    out.append({"name": "fake-rr", "kind": "hermetic", "path": None,
                "detail": "deterministic reranker (RAG_TPU_FAKE_RERANKER=1)"})
    out.append({"name": "", "kind": "disabled", "path": None, "detail": "reranking disabled (empty model name)"})
    return out


def discover_models() -> Dict[str, List[Dict]]:
    return {"embedding": discover_encoder_models(), "rerank": discover_rerank_models()}


def choices_for_key(key: str) -> Optional[List[str]]:
    """Dropdown choices for a settings key (the TUI's ollama.rs:71-111
    analog); None when the key has no discoverable choices."""
    if key == "ENCODER_WEIGHTS":
        return [m["path"] for m in discover_encoder_models() if m["kind"] == "checkpoint"] + [""]
    if key == "RERANKER_WEIGHTS":
        return [m["path"] for m in discover_rerank_models() if m["kind"] == "checkpoint"] + [""]
    if key == "RAG_TPU_RERANK_MODEL":
        return [m["name"] for m in discover_rerank_models()]
    return None
