"""Masked query x corpus scores plus per-segment maxima: the CUDA kernel
csrc/score_segmax.cu and its plain PyTorch version.

Port of the TPU kernel fused_score_segmax_masked
(rust_local_rag_tpu/ops/pallas_topk.py:217-319). The segmented exact top-k
(ops/fast_topk.py) needs the scores and the max of every 128-row segment;
the kernel produces both in one pass over the corpus, with -inf at invalid
slots in both, so the selection stays exact on slabs with freed slots.
The segment maxima come back as [Q, N/128] (the JAX kernel's [N/128, Q]
was a TPU store-alignment layout).

score_segmax launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from rust_local_rag_tpu_torch.kernels import build

SEG = 128  # segment size, rows per kernel block


def score_segmax_plain(queries: torch.Tensor, corpus: torch.Tensor, valid_mask: torch.Tensor):
    """Plain version: f32 matmul (a bf16 slab is widened exactly), mask,
    amax over [Q, N/128, 128]. -> (scores [Q, N] f32, segmax [Q, N/128] f32)."""
    q = queries.shape[0]
    n = corpus.shape[0]
    scores = torch.matmul(queries.float(), corpus.float().T)
    scores = torch.where(valid_mask[None, :], scores, float("-inf"))
    return scores, scores.view(q, n // SEG, SEG).amax(dim=2)


def _check(queries: torch.Tensor, corpus: torch.Tensor, valid_mask: torch.Tensor) -> None:
    dev = corpus.device
    if queries.device != dev or valid_mask.device != dev:
        raise ValueError(
            f"score_segmax: tensors on different devices "
            f"({queries.device}, {corpus.device}, {valid_mask.device})"
        )
    if queries.dim() != 2 or corpus.dim() != 2 or valid_mask.dim() != 1:
        raise ValueError("score_segmax: expects queries [Q, D], corpus [N, D], mask [N]")
    q, d = queries.shape
    n = corpus.shape[0]
    if corpus.shape[1] != d or valid_mask.shape[0] != n:
        raise ValueError(
            f"score_segmax: shapes {tuple(queries.shape)}, {tuple(corpus.shape)}, "
            f"{tuple(valid_mask.shape)} do not agree"
        )
    if valid_mask.dtype != torch.bool:
        raise TypeError(f"score_segmax: mask must be bool, got {valid_mask.dtype}")
    if q < 1 or n % SEG:
        raise ValueError(f"score_segmax: need Q >= 1 and N % {SEG} == 0 (Q={q}, N={n})")
    if dev.type == "cuda":
        if queries.dtype != torch.float32:
            raise TypeError(f"score_segmax: queries must be float32, got {queries.dtype}")
        if corpus.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"score_segmax: corpus must be float32 or bfloat16, got {corpus.dtype}")
        if d % 8:
            raise ValueError(f"score_segmax: D must be a multiple of 8 (D={d})")
        if n // SEG > 65535:
            raise ValueError(f"score_segmax: at most {65535 * SEG} rows (N={n})")
        for name, t in (("queries", queries), ("corpus", corpus), ("mask", valid_mask)):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"score_segmax: {name} must be contiguous and 16-byte aligned")


def score_segmax(queries: torch.Tensor, corpus: torch.Tensor, valid_mask: torch.Tensor):
    """queries [Q, D] f32, corpus [N, D] f32 or bf16, valid_mask [N] bool
    -> (scores [Q, N] f32 with -inf at invalid slots, segmax [Q, N/128] f32).

    CUDA tensors launch the kernel (and count the launch in
    ``score_segmax.launches``); CPU tensors take score_segmax_plain."""
    _check(queries, corpus, valid_mask)
    dev = corpus.device
    if dev.type == "cpu":
        return score_segmax_plain(queries, corpus, valid_mask)
    if dev.type != "cuda":
        raise ValueError(f"score_segmax: unsupported device {dev}")
    lib = build.load("score_segmax")
    q, d = queries.shape
    n = corpus.shape[0]
    scores = torch.empty((q, n), dtype=torch.float32, device=dev)
    segmax = torch.empty((q, n // SEG), dtype=torch.float32, device=dev)
    err = lib.score_segmax_masked(
        queries.data_ptr(), corpus.data_ptr(), valid_mask.data_ptr(),
        scores.data_ptr(), segmax.data_ptr(), q, n, d,
        int(corpus.dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.score_segmax_error_string(err).decode()
        raise RuntimeError(f"score_segmax kernel launch failed: {msg} ({err})")
    score_segmax.launches += 1
    return scores, segmax


score_segmax.launches = 0
