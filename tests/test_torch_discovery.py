"""The port's model discovery (models/discovery.py) and its header-only
safetensors reader (models/checkpoint.read_safetensors_header) against the
JAX package's discovery on the CPU.

Checkpoints are written by the port's save_params: an encoder and a
reranker with their config and step count in the metadata, one with no
metadata, a symlink to one of them (listed once), a file that is not
safetensors at all, and environment paths that do not exist. Every
combination of ENCODER_WEIGHTS, RERANKER_WEIGHTS and RAG_TPU_MODELS_DIR
must give JAX's entries in JAX's order, and the same dropdown choices.
"""

import itertools
import os
import struct

import numpy as np
import pytest
import torch

from rust_local_rag_tpu.models import discovery as j_discovery
from rust_local_rag_tpu_torch.models import discovery as t_discovery
from rust_local_rag_tpu_torch.models.checkpoint import read_safetensors, read_safetensors_header, save_params
from rust_local_rag_tpu_torch.models.encoder import Encoder, EncoderConfig
from rust_local_rag_tpu_torch.models.reranker import Reranker, RerankerConfig

ENV = ("ENCODER_WEIGHTS", "RERANKER_WEIGHTS", "RAG_TPU_MODELS_DIR")
KEYS = ("ENCODER_WEIGHTS", "RERANKER_WEIGHTS", "RAG_TPU_RERANK_MODEL", "DATA_DIR", "MCP_HTTP_BIND")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    gen = torch.Generator().manual_seed(0)
    ecfg = EncoderConfig(vocab_size=32, dim=8, depth=2, heads=2, ffn_dim=16, max_len=8, out_dim=12)
    save_params(Encoder(ecfg, gen), str(d / "enc_a.safetensors"),
                metadata={"encoder_config": ecfg.to_json(), "trained_steps": "120"})
    same = EncoderConfig(vocab_size=32, dim=8, depth=1, heads=2, ffn_dim=16, max_len=8, out_dim=8)
    save_params(Encoder(same, gen), str(d / "enc_b.safetensors"), metadata={"encoder_config": same.to_json()})
    save_params(Encoder(same, gen), str(d / "bare.safetensors"))
    rcfg = RerankerConfig(vocab_size=32, dim=8, depth=1, heads=2, ffn_dim=16, max_len=16)
    save_params(Reranker(rcfg, gen), str(d / "tiny_reranker.safetensors"),
                metadata={"reranker_config": rcfg.to_json(), "trained_steps": "9"})
    (d / "junk_reranker.safetensors").write_bytes(b"not a safetensors file")
    os.symlink(d / "enc_a.safetensors", d / "link.safetensors")
    (d / "notes.txt").write_text("ignored")
    return d


def _settings(models):
    return {
        "ENCODER_WEIGHTS": [None, str(models / "enc_b.safetensors"), str(models / "missing.safetensors"),
                            str(models / "link.safetensors")],
        "RERANKER_WEIGHTS": [None, str(models / "tiny_reranker.safetensors"), str(models / "bare.safetensors")],
        "RAG_TPU_MODELS_DIR": [None, str(models), str(models / "empty")],
    }


def _apply(monkeypatch, models, combo):
    for k, i in zip(ENV, combo):
        v = _settings(models)[k][i]
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)


COMBOS = list(itertools.product(range(4), range(3), range(3)))


@pytest.mark.parametrize("combo", COMBOS, ids=[f"enc{a}-rr{b}-dir{c}" for a, b, c in COMBOS])
def test_discovery_equals_jax(models, monkeypatch, combo):
    _apply(monkeypatch, models, combo)
    assert t_discovery.discover_models() == j_discovery.discover_models()
    for key in KEYS:
        assert t_discovery.choices_for_key(key) == j_discovery.choices_for_key(key), key


def test_discovery_details_and_duplicates(models, monkeypatch):
    details = set()
    for combo in COMBOS:
        _apply(monkeypatch, models, combo)
        details |= {m["detail"] for ms in t_discovery.discover_models().values() for m in ms
                    if m["kind"] == "checkpoint"}
    assert {"2L x 8d -> 12d, 120 steps", "1L x 8d", "no embedded config", "1L x 8d, 9 steps",
            "unreadable metadata"} <= details
    monkeypatch.setenv("RAG_TPU_MODELS_DIR", str(models))
    monkeypatch.setenv("ENCODER_WEIGHTS", str(models / "link.safetensors"))
    names = [m["name"] for m in t_discovery.discover_encoder_models()]
    # enc_a and its symlink are one file: listed once, under the first path seen
    assert names.count(str(models / "link.safetensors")) == 1 and str(models / "enc_a.safetensors") not in names


def test_header_reader_reads_no_tensor(models, tmp_path):
    path = str(models / "enc_a.safetensors")
    header, meta = read_safetensors_header(path)
    tensors, meta_full = read_safetensors(path)
    assert meta == meta_full and meta["trained_steps"] == "120"
    assert set(header) == set(tensors)
    for name, info in header.items():
        assert info["shape"] == list(tensors[name].shape) and info["dtype"] == "F32"
    # the tensor bytes cut away: the header still reads, the tensors do not
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack("<Q", raw[:8])
    cut = tmp_path / "cut.safetensors"
    cut.write_bytes(raw[: 8 + n])
    assert read_safetensors_header(str(cut)) == (header, meta)
    with pytest.raises(ValueError, match="outside the file"):
        read_safetensors(str(cut))
    for bad in (b"\x01\x02", struct.pack("<Q", 10 ** 9) + b"{}"):
        (tmp_path / "bad.safetensors").write_bytes(bad)
        with pytest.raises(ValueError):
            read_safetensors_header(str(tmp_path / "bad.safetensors"))
    assert np.isfinite(tensors["embed"]).all()
