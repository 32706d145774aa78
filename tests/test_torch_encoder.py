"""Port parity of the encoder: a small random JAX config carried into the
port with params_from_jax, the safetensors reader, the embedding service,
and the committed assets (opted in with explicit paths).

Tolerance: both frameworks run bf16 activations with f32 accumulation but
round to bf16 at different places (fused vs separate ops, silu inside or
outside f32), so embeddings agree to bf16 precision after a few layers:
max |diff| <= 2e-2 on unit vectors and cosine >= 0.999.
"""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_local_rag_tpu.models import encoder as jenc
from rust_local_rag_tpu.models.embedding_service import EmbeddingService as JService
from rust_local_rag_tpu.models.tokenizer import HashTokenizer as JHash
from rust_local_rag_tpu_torch.models import encoder as tenc
from rust_local_rag_tpu_torch.models.checkpoint import params_from_jax, read_safetensors
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService as TService
from rust_local_rag_tpu_torch.models.tokenizer import HashTokenizer as THash

ATOL = 2e-2
MIN_COS = 0.999

SMALL = dict(vocab_size=97, dim=64, depth=2, heads=4, ffn_dim=96, max_len=64, out_dim=48)


def _pair(cfg_kwargs, seed=0):
    jcfg = jenc.EncoderConfig(**cfg_kwargs)
    jparams = jenc.init_encoder_params(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    model = tenc.Encoder(tenc.EncoderConfig(**cfg_kwargs))
    model.load_state_dict(params_from_jax(np_params))
    return jcfg, jparams, model


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= ATOL
    assert (np.sum(a * b, axis=1) >= MIN_COS).all()


@pytest.mark.parametrize("out_dim", [48, 64])
def test_encoder_forward_matches_jax(rng, out_dim):
    cfg = dict(SMALL, out_dim=out_dim)
    jcfg, jparams, model = _pair(cfg)
    assert hasattr(model, "out_proj") == (out_dim != 64)
    ids = rng.integers(0, 97, size=(5, 32)).astype(np.int32)
    mask = np.zeros((5, 32), np.int32)
    for i, n in enumerate([32, 20, 7, 1, 16]):
        mask[i, :n] = 1
    want = jenc._jit_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-5)


def test_state_dict_names_are_safetensors_names():
    model = tenc.Encoder(tenc.EncoderConfig(**SMALL))
    names = set(model.state_dict())
    assert {"embed", "final_norm", "out_proj", "layers.0.wq", "layers.1.w_down"} <= names
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_encoder_random_init_uses_generator():
    cfg = tenc.EncoderConfig(**SMALL)
    a = tenc.Encoder(cfg, torch.Generator().manual_seed(1))
    b = tenc.Encoder(cfg, torch.Generator().manual_seed(1))
    c = tenc.Encoder(cfg, torch.Generator().manual_seed(2))
    assert torch.equal(a.embed, b.embed) and not torch.equal(a.embed, c.embed)


def _write_safetensors(path, tensors, meta):
    header = {"__metadata__": meta}
    blobs, off = [], 0
    for name, (dtype, arr) in tensors.items():
        raw = arr.tobytes()
        header[name] = {"dtype": dtype, "shape": list(arr.shape), "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def test_read_safetensors_dtypes(tmp_path, rng):
    x = rng.standard_normal((3, 4)).astype(np.float32)
    bf16 = (x.view(np.uint32) >> 16).astype(np.uint16)
    path = tmp_path / "t.safetensors"
    _write_safetensors(
        path,
        {"a": ("F32", x), "b": ("F16", x.astype(np.float16)), "c": ("BF16", bf16)},
        {"k": "v"},
    )
    tensors, meta = read_safetensors(str(path))
    assert meta == {"k": "v"}
    np.testing.assert_array_equal(tensors["a"], x)
    np.testing.assert_array_equal(tensors["b"], x.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(tensors["c"], (bf16.astype(np.uint32) << 16).view(np.float32))
    _write_safetensors(path, {"a": ("I64", np.zeros(2, np.int64))}, {})
    with pytest.raises(ValueError):
        read_safetensors(str(path))


def test_read_safetensors_matches_library_on_asset():
    from safetensors.numpy import load_file

    path = tenc.default_asset("encoder.safetensors")
    tensors, meta = read_safetensors(path)
    ref = load_file(path)
    assert set(tensors) == set(ref)
    for k in ("embed", "layers.0.wq", "layers.5.w_down"):
        np.testing.assert_array_equal(tensors[k], ref[k].astype(np.float32))
    cfg = json.loads(meta["encoder_config"])
    assert (cfg["depth"], cfg["dim"], cfg["heads"], cfg["ffn_dim"], cfg["out_dim"], cfg["vocab_size"]) == (
        6, 512, 8, 1408, 768, 8193,
    )


class _Model:
    """Duck-typed encoder for the services: the same hash tokenizer and a
    small port/JAX encoder pair behind encode / encode_queries."""

    def __init__(self, fn, dim):
        self.fn, self.dim, self.model_name = fn, dim, "tiny"
        self.calls = 0

    def encode(self, texts):
        self.calls += 1
        return self.fn(list(texts))

    def encode_queries(self, texts):
        return self.encode(["q: " + t for t in texts])


def test_embedding_service_matches_jax(monkeypatch):
    monkeypatch.setenv("EMBEDDING_BATCH_SIZE", "3")
    jcfg, jparams, model = _pair(SMALL)
    jt, tt = JHash(vocab_size=97, max_len=64), THash(vocab_size=97, max_len=64)

    def jfn(texts):
        ids, mask = jt.encode_batch(texts)
        return np.asarray(jenc._jit_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))

    def tfn(texts):
        ids, mask = tt.encode_batch(texts)
        with torch.inference_mode():
            return model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()

    texts = ["pump seal", "a much longer text about the valve and its gasket", "x", "bearing noise at speed"] * 2
    js, ts = JService(_Model(jfn, 48)), TService(_Model(tfn, 48))
    seen = []
    out = ts.embed_in_batches(texts, batch_callback=lambda *a: seen.append(a))
    _close(out, js.embed_in_batches(texts))
    assert seen == [(1, 3, 8, 3), (2, 3, 8, 3), (3, 3, 8, 2)]
    _close(ts.get_query_embeddings(["pump", "valve"]), js.get_query_embeddings(["pump", "valve"]))
    calls = ts._model.calls
    ts.get_query_embeddings(["pump", "valve"])  # LRU hit: no model call
    assert ts._model.calls == calls
    assert ts.get_query_embeddings_device(["pump"]) is None  # no device path
    ts.close()


def test_committed_encoder_matches_jax():
    """Opt-in to the committed assets: the port and the JAX package load
    the same files and embed the same texts (documents and queries)."""
    wpath, tpath = tenc.default_asset("encoder.safetensors"), tenc.default_asset("tokenizer.json")
    jm = jenc.TransformerEncoderModel(weights_path=wpath, tokenizer_path=tpath)
    tm = tenc.TransformerEncoderModel.from_assets(wpath, tpath, device="cpu")
    assert tm.dim == jm.dim == 768 and tm._query_prefix == jm._query_prefix
    texts = [
        "Replace the pump seal when the shaft leaks.",
        "Café naïve résumé: non-ASCII text goes through the same tokenizer.",
        "bearing " * 90,
    ]
    _close(tm.encode(texts), jm.encode(texts))
    _close(tm.encode_queries(texts[:2]), jm.encode_queries(texts[:2]))
    dev = tm.encode_queries_device(texts)
    assert tuple(dev.shape) == (4, 768) and dev.device.type == "cpu"
