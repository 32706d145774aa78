"""The port's fused attention (ops/attention.py) against the JAX package's
Pallas kernel, run in interpret mode on the CPU as tests/conftest.py sets.

On CPU tensors the port's wrapper takes attention_plain, the plain twin of
csrc/attention.cu; the kernel itself runs only on the card (chip_smoke.py
holds it against attention_plain there). Inputs are seeded numpy arrays
rounded to bf16 the same way in both frameworks (round to nearest even).

Tolerance: atol = rtol = 2e-2 on the bf16 outputs, as
tests/test_attention.py holds the Pallas kernel against XLA: both sides sum
the same exact bf16 products in f32 in different orders, and round the
probabilities and the outputs to bf16 (one bf16 ulp at |x| ~ 2 is 1.6e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_local_rag_tpu.models import encoder as jenc
from rust_local_rag_tpu.ops.attention import fused_attention as jax_fused_attention
from rust_local_rag_tpu_torch.models import encoder as tenc
from rust_local_rag_tpu_torch.models.checkpoint import params_from_jax
from rust_local_rag_tpu_torch.ops import attention as tatt

ATOL = RTOL = 2e-2


def _inputs(seed, b, h, l, dh):
    """q, k, v ~ N(0, 1) and masks of random lengths: row 0 has length 1
    and the last row is all masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, l, dh)).astype(np.float32) for _ in range(3))
    lens = rng.integers(1, l + 1, size=b)
    lens[0] = 1
    lens[-1] = 0
    mask = (np.arange(l)[None, :] < lens[:, None]).astype(np.int32)
    return q, k, v, mask


def _both(q, k, v, mask, causal):
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    want = jax_fused_attention(jq, jk, jv, jnp.asarray(mask), causal=causal)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tatt.fused_attention(tq, tk, tv, torch.from_numpy(mask), causal=causal)
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,l,dh", [(2, 2, 64, 64), (3, 2, 192, 64), (2, 3, 128, 64)])
def test_attention_plain_matches_pallas_kernel(b, h, l, dh, causal):
    q, k, v, mask = _inputs(b * 100 + l, b, h, l, dh)
    before = tatt.fused_attention.launches
    got, want = _both(q, k, v, mask, causal)
    assert tatt.fused_attention.launches == before  # CPU tensors: the plain twin, no launch
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, l, dh)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    # every row is compared: padded query rows and the all-masked batch row too
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,h,l", [(3, 2, 64), (4, 2, 192), (3, 1, 100)])
def test_non_prefix_causal_masks_match_pallas_kernel(b, h, l):
    """Masks that are not prefixes, under causal: row 0 has key 0 masked and
    later keys valid, row 1 is masked in its first half, the last row has no
    valid key, the rest are random. A query whose keys up to its position
    are all masked sees -1e9 on those keys and on the valid keys above the
    diagonal alike (f32 rounds s/8 - 1e9 to -1e9), so the TPU kernel spreads
    it over both; attention_plain, the function the CUDA kernel is held to,
    must do the same. Same tolerance as above: atol = rtol = 2e-2."""
    q, k, v, _ = _inputs(b * 1000 + l, b, h, l, 64)
    rng = np.random.default_rng(l)
    mask = (rng.random((b, l)) < 0.7).astype(np.int32)
    mask[0, 0] = 0
    mask[0, 1::2] = 1
    mask[1, : l // 2] = 0
    mask[-1] = 0
    got, want = _both(q, k, v, mask, True)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # row 0, query 0: key 0 is masked, key 1 (valid, above the diagonal)
    # and every key above it score -1e9 or -2e9: the mean of V over the
    # keys at -1e9, the masked ones up to 0 and the valid ones above it
    vb = torch.from_numpy(v[0]).to(torch.bfloat16).float()
    at_neg = torch.from_numpy(mask[0] > 0)
    at_neg[0] = True
    np.testing.assert_allclose(got[0, :, 0], vb[:, at_neg].mean(dim=1).numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_all_masked_row_is_uniform(causal):
    """The finite bias keeps an all-masked row defined: each query row
    averages the values of the keys it may see (all of them, or those up
    to the diagonal when causal, where a masked key above it gets -2e9)."""
    q, k, v, mask = _inputs(7, 2, 2, 64, 64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = tatt.attention_plain(tq, tk, tv, torch.from_numpy(mask), causal=causal)[-1].float()
    vb = tv[-1].float()
    if causal:
        want = torch.cumsum(vb, dim=1) / torch.arange(1, 65)[None, :, None]
    else:
        want = vb.mean(dim=1, keepdim=True).expand_as(vb)
    np.testing.assert_allclose(out.numpy(), want.to(torch.bfloat16).float().numpy(), atol=ATOL, rtol=RTOL)


def test_use_fused_attention_reads_env(monkeypatch):
    monkeypatch.delenv("RAG_TPU_FUSED_ATTN", raising=False)
    assert tatt.use_fused_attention() is False
    monkeypatch.setenv("RAG_TPU_FUSED_ATTN", "1")
    assert tatt.use_fused_attention() is True
    monkeypatch.setenv("RAG_TPU_FUSED_ATTN", "0")
    assert tatt.use_fused_attention() is False


def test_wrapper_checks_and_refuses_other_devices():
    q = torch.zeros((1, 1, 8, 64), dtype=torch.bfloat16)
    mask = torch.ones((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="mask"):
        tatt.fused_attention(q, q, q, torch.ones((1, 7), dtype=torch.int32))
    with pytest.raises(ValueError, match="one shape"):
        tatt.fused_attention(q, q, q[:, :, :4], mask)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tatt.fused_attention(meta, meta, meta, mask.to("meta"))


def test_kernel_arithmetic_step_for_step():
    """attention_plain is the TPU kernel's arithmetic: f32 scores scaled by
    Dh^-0.5, the finite biases added (-2e9 where a key is masked and above
    the diagonal), max-subtracted exp over the row sum, bf16 probabilities,
    f32 PV, bf16 out. Recomputed here in float64 from the same bf16 inputs,
    for the batch rows with a valid key: in the all-masked row f32 rounds
    every -1e9 + s/8 to -1e9 (the ulp there is 64), which makes the row
    uniform, while float64 keeps the score differences."""
    q, k, v, mask = _inputs(11, 2, 1, 32, 64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tatt.attention_plain(tq, tk, tv, torch.from_numpy(mask), causal=True).double()
    qd, kd, vd = (t.double() for t in (tq, tk, tv))
    pos = torch.arange(32)
    bias = torch.where(torch.from_numpy(mask)[:, None, None, :] > 0, 0.0, -1e9).double()
    bias = bias + torch.where(pos[None, :] > pos[:, None], -1e9, 0.0).double()
    s = qd @ kd.transpose(-1, -2) * 0.125 + bias
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).double()
    want = (p @ vd).to(torch.bfloat16).double()
    np.testing.assert_allclose(got[:-1].numpy(), want[:-1].numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fused", [False, True])
def test_encoder_fused_option_matches_jax(fused):
    """The encoder's fused_attn option against the JAX encoder's (Pallas in
    interpret mode when fused): embeddings within 2e-2 and cosine > 0.999,
    the bound tests/test_attention.py sets between the JAX fused and plain
    encoders, and the port's fused and plain paths within the same bound."""
    cfg = dict(vocab_size=512, dim=128, depth=2, heads=2, ffn_dim=256, out_dim=128)
    jcfg = jenc.EncoderConfig(**cfg)
    params = jenc.init_encoder_params(jax.random.PRNGKey(0), jcfg)
    model = tenc.Encoder(tenc.EncoderConfig(**cfg))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 512, size=(4, 128)).astype(np.int32)
    lens = rng.integers(4, 128, size=4)
    mask = (np.arange(128)[None] < lens[:, None]).astype(np.int32)
    want = np.asarray(jenc.encoder_forward(params, jnp.asarray(ids), jnp.asarray(mask), jcfg, fused_attn=fused))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask), fused_attn=fused).numpy()
        other = model(torch.from_numpy(ids), torch.from_numpy(mask), fused_attn=not fused).numpy()
    for a, b in ((got, want), (got, other)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        assert (np.sum(a * b, axis=1) > 0.999).all()
