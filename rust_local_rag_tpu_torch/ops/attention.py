"""Fused attention: the CUDA kernel csrc/attention.cu and its plain PyTorch
version.

Port of the TPU kernel fused_attention (rust_local_rag_tpu/ops/attention.py:
44-147): softmax(QK^T * Dh^-0.5 + bias) V on [B, H, L, Dh] bf16 with the
[B, H, L, L] scores kept out of device memory. The bias is a finite -1e9
on masked keys and, when causal, above the diagonal (both add, so a masked
key above the diagonal gets -2e9); the softmax is exact, f32 and
max-subtracted; probabilities are cast to the input type before PV. Rows
whose keys are all masked come out uniform, and padded query rows are
computed like the others.

fused_attention launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors; there is no fallback from one to the other.
The kernel has two bodies (BODIES): mma.sync up to L 64 and wgmma beyond;
body_for(L) names the one a length takes, and launch_body runs a named one
(for timing one against the other; it counts no launch).
The encoder and the reranker take this path only when use_fused_attention()
is on (RAG_TPU_FUSED_ATTN=1), as in the JAX package.
"""

from __future__ import annotations

import math
import os

import torch

from rust_local_rag_tpu_torch.kernels import build

NEG = -1e9  # finite mask bias: a fully masked row stays well defined
HEAD_DIM = 64
MAX_LEN = 512


def use_fused_attention() -> bool:
    """Opt-in, off by default (RAG_TPU_FUSED_ATTN=1), as in the JAX package."""
    return os.environ.get("RAG_TPU_FUSED_ATTN", "0") == "1"


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Plain version, step for step the TPU kernel's arithmetic: f32 scores
    of the inputs' values, scale, key bias (+ causal bias), max-subtracted
    exp, division by the row sum, cast to q's type, PV in f32 -> q's type."""
    b, h, l, dh = q.shape
    bias = torch.where(mask.float() > 0.5, 0.0, NEG)[:, None, None, :]  # [B, 1, 1, L] f32
    if causal:
        pos = torch.arange(l, device=q.device)
        bias = bias + torch.where(pos[None, :] > pos[:, None], NEG, 0.0)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(dh)) + bias
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> None:
    dev = q.device
    if any(t.device != dev for t in (k, v, mask)):
        raise ValueError("fused_attention: tensors on different devices")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"fused_attention: expects q, k, v [B, H, L, Dh] of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, l, _ = q.shape
    if tuple(mask.shape) != (b, l):
        raise ValueError(f"fused_attention: mask must be [B, L] = {(b, l)}, got {tuple(mask.shape)}")
    if dev.type != "cuda":
        return
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("fused_attention: q, k and v must be bfloat16")
    if mask.dtype != torch.int32 or not mask.is_contiguous():
        raise TypeError("fused_attention: mask must be contiguous int32")
    if q.shape[3] != HEAD_DIM or not 1 <= l <= MAX_LEN or b > 65535 or q.shape[1] > 65535:
        raise ValueError(
            f"fused_attention: needs Dh = {HEAD_DIM}, 1 <= L <= {MAX_LEN}, B and H <= 65535, "
            f"got {tuple(q.shape)}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 2 for s in t.stride()[:3]) or t.data_ptr() % 4:
            raise ValueError(
                f"fused_attention: {name} needs a unit depth stride, even strides and "
                f"4-byte alignment (strides {t.stride()})"
            )


# csrc/attention.cu's bodies by their C numbers (0 lets the kernel choose);
# the mma.sync body takes L <= 192 when named (MMA_SYNC_MAX_L there)
BODIES = {1: "mma.sync", 2: "wgmma"}
MMA_SYNC_MAX_LEN = 192


def body_for(l: int) -> str:
    """The body the kernel takes at length l (asks the built library)."""
    return BODIES[build.load("attention").attention_body(l)]


def bodies_for(l: int) -> dict:
    """{number: name} of the bodies launch_body takes at length l."""
    return {n: name for n, name in BODIES.items() if name == "wgmma" or l <= MMA_SYNC_MAX_LEN}


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """q, k, v [B, H, L, 64] bf16 (any strides with a unit depth stride),
    mask [B, L] int32 (> 0 = valid key) -> [B, H, L, 64] bf16 contiguous.

    CUDA tensors launch the kernel (and count the launch in
    ``fused_attention.launches``); CPU tensors take attention_plain."""
    _check(q, k, v, mask)
    dev = q.device
    if dev.type == "cpu":
        return attention_plain(q, k, v, mask, causal)
    if dev.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {dev}")
    lib = build.load("attention")
    b, h, l, _ = q.shape
    out = torch.empty((b, h, l, HEAD_DIM), dtype=torch.bfloat16, device=dev)
    err = lib.attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, h, l, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.attention_error_string(err).decode()
        raise RuntimeError(f"fused_attention kernel launch failed: {msg} ({err})")
    fused_attention.launches += 1
    return out


def launch_body(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, causal: bool, body: int
) -> torch.Tensor:
    """fused_attention's kernel on CUDA tensors with the body named (a key
    of BODIES), for timing one body against the other; counts no launch."""
    _check(q, k, v, mask)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {dev}")
    lib = build.load("attention")
    b, h, l, _ = q.shape
    out = torch.empty((b, h, l, HEAD_DIM), dtype=torch.bfloat16, device=dev)
    err = lib.attention_fwd_body(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, h, l, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), dev.index, torch.cuda.current_stream(dev).cuda_stream, body,
    )
    if err != 0:
        msg = lib.attention_error_string(err).decode()
        raise RuntimeError(f"fused_attention kernel launch failed: {msg} ({err})")
    return out


fused_attention.launches = 0
