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
@pytest.mark.parametrize(
    "b,h,l,dh", [(2, 2, 64, 64), (3, 2, 192, 64), (2, 3, 128, 64), (2, 2, 256, 64), (2, 1, 512, 64)]
)
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


@pytest.mark.parametrize("b,h,l", [(3, 2, 64), (4, 2, 192), (3, 1, 100), (3, 2, 256), (3, 1, 512)])
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


def _float64_reference(tq, tk, tv, mask, causal):
    """The TPU kernel's function recomputed in float64 from the bf16 inputs:
    softmax over the biased scores, p rounded to bf16, PV, output in bf16."""
    l = tq.shape[2]
    qd, kd, vd = (t.double() for t in (tq, tk, tv))
    bias = torch.where(torch.from_numpy(mask)[:, None, None, :] > 0, 0.0, -1e9).double()
    if causal:
        pos = torch.arange(l)
        bias = bias + torch.where(pos[None, :] > pos[:, None], -1e9, 0.0).double()
    s = qd @ kd.transpose(-1, -2) * 0.125 + bias
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).double()
    return (p @ vd).to(torch.bfloat16).double()


def _fma32(a, b, c):
    """float32 a * b + c with one rounding (a product of two float32 is
    exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _wgmma_body_order(tq, tk, tv, mask, causal):
    """csrc/attention.cu's wgmma body in its own order, in float32. A
    warpgroup takes 256 keys (keys 256 w .. 256 w + 255; one warpgroup up to
    L 256, the keys past L biased -inf) in two halves of 128: per half the
    scaled, biased scores, their row max m_h, e = 2^(s log2 e - m_h log2 e)
    (0 for a half wholly past L) and the row sum l_h. Then m_w = max m_h,
    f_h = 2^((m_h - m_w) log2 e) (1 where m_h = m_w), l_w = l_A f_A + l_B
    f_B; across the warpgroups the same with F_w, and p = e (f_h F_w) (1 /
    l) rounded to bf16; PV summed in f32 a warpgroup, the two sums added,
    bf16 out."""
    b, h, l, _ = tq.shape
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    inf = torch.tensor(float("inf"))
    bias = torch.where(torch.from_numpy(mask)[:, None, None, :] > 0, 0.0, -1e9).float()
    if causal:
        pos = torch.arange(l)
        bias = bias + torch.where(pos[None, :] > pos[:, None], -1e9, 0.0).float()
    s = torch.matmul(tq.float(), tk.float().transpose(-1, -2)) * 0.125 + bias
    width = 512 if l > 256 else 256
    s = torch.cat([s, torch.full((b, h, l, width - l), -inf)], dim=-1)  # keys past L
    v = torch.cat([tv.float(), torch.zeros(b, h, width - l, 64)], dim=2)

    def ex2(x):
        return torch.exp2(x)

    ranges = []  # a warpgroup: (e of both halves, f of both halves, m_w, l_w)
    for k0 in range(0, width, 256):
        es, ms, ls = [], [], []
        for half in (k0, k0 + 128):
            part = s[..., half : half + 128]
            m_h = part.amax(dim=-1, keepdim=True)
            ml = torch.where(m_h == -inf, 0.0, m_h * log2e)
            e = ex2(_fma32(part, log2e.expand_as(part), -ml.expand_as(part)))
            es.append(e)
            ms.append(m_h)
            ls.append(e.sum(dim=-1, keepdim=True))
        m_w = torch.maximum(ms[0], ms[1])
        fs = [torch.where(m_h == m_w, 1.0, ex2((m_h - m_w) * log2e)) for m_h in ms]
        ranges.append((es, fs, m_w, ls[0] * fs[0] + ls[1] * fs[1]))
    if len(ranges) == 1:
        es, fs, _, l_w = ranges[0]
        coefs = [[f * (1.0 / l_w) for f in fs]]
    else:
        (_, _, m0, l0), (_, _, m1, l1) = ranges
        m = torch.maximum(m0, m1)
        big = [torch.where(m_w == m, 1.0, ex2((m_w - m) * log2e)) for m_w in (m0, m1)]
        inv = 1.0 / (l0 * big[0] + l1 * big[1])
        coefs = [[(f * big[w]) * inv for f in ranges[w][1]] for w in range(2)]
    out = None
    for w, (es, _, _, _) in enumerate(ranges):
        p = torch.cat([(e * c).to(torch.bfloat16).float() for e, c in zip(es, coefs[w])], dim=-1)
        part = torch.matmul(p, v[..., 256 * w : 256 * w + 256, :])
        out = part if out is None else out + part
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,l", [(3, 2, 100), (3, 2, 192), (3, 2, 256), (3, 2, 300), (3, 1, 512)])
def test_wgmma_body_order_matches_plain_and_float64(b, h, l, causal):
    """The wgmma body's order of the arithmetic (each half of a warpgroup's
    keys exponentiated against its own max, rescaled by exp(m_h - m) before
    the division by the row sum) emulated in float32 from seeded bf16
    inputs, held against attention_plain on every row and against the
    float64 recomputation on the rows with a valid key (the all-masked row:
    see test_kernel_arithmetic_step_for_step), at atol = rtol = 2e-2. L 100
    leaves a half wholly past L, L 300 a half of the second warpgroup."""
    q, k, v, mask = _inputs(b * 7 + l, b, h, l, 64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = _wgmma_body_order(tq, tk, tv, mask, causal).float()
    plain = tatt.attention_plain(tq, tk, tv, torch.from_numpy(mask), causal=causal).float()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=RTOL)
    want = _float64_reference(tq, tk, tv, mask, causal)
    np.testing.assert_allclose(got[:-1].double().numpy(), want[:-1].numpy(), atol=ATOL, rtol=RTOL)


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
