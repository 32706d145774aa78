"""Query x corpus scores plus per-segment maxima, masked and unmasked: the
CUDA kernels of csrc/score_segmax.cu and their plain PyTorch versions.

Ports of the TPU kernels fused_score_segmax_masked
(rust_local_rag_tpu/ops/pallas_topk.py:217-319), the first stage of the
hybrid search, and fused_score_segmax (:65-185), the unmasked form behind
pallas_segmented_topk (:189-214). The segmented exact top-k
(ops/fast_topk.py) needs the scores and the max of every 128-row segment;
the kernels produce both in one pass over the corpus. The masked form puts
-inf at invalid slots in both, so the selection stays exact on slabs with
freed slots. The segment maxima come back as [Q, N/128] (the JAX kernels'
[N/128, Q] was a TPU store-alignment layout).

Queries are f32, or bf16 on a bf16 slab. On the card f32 queries at
Q <= 16 take the persistent CUDA-core stream; every other case on a bf16
slab takes the tensor-core stream, which splits f32 queries into three
bf16 terms (split_terms_plain is the same split in torch) and takes bf16
queries as one; f32 queries on an f32 slab at Q > 16 take the register-
tiled f32 FMA body (query tiles of 32, 64 or 128). Every body runs a
persistent grid, so no segment count is refused.

score_segmax and fused_score_segmax launch their kernels for CUDA tensors
and run the plain versions only for CPU tensors; there is no fallback from
one to the other.
"""

from __future__ import annotations

import torch

from rust_local_rag_tpu_torch.kernels import build
from rust_local_rag_tpu_torch.ops.fast_topk import segmented_select_from

SEG = 128  # segment size, rows per kernel block
STREAM_MAX_Q = 16  # f32 queries up to this count take the CUDA-core stream


def score_segmax_plain(queries: torch.Tensor, corpus: torch.Tensor, valid_mask: torch.Tensor):
    """Plain version: f32 matmul (a bf16 slab is widened exactly), mask,
    amax over [Q, N/128, 128]. -> (scores [Q, N] f32, segmax [Q, N/128] f32)."""
    q = queries.shape[0]
    n = corpus.shape[0]
    scores = torch.matmul(queries.float(), corpus.float().T)
    scores = torch.where(valid_mask[None, :], scores, float("-inf"))
    return scores, scores.view(q, n // SEG, SEG).amax(dim=2)


def fused_score_segmax_plain(queries: torch.Tensor, corpus: torch.Tensor):
    """Plain version of the unmasked pass -> (scores [Q, N] f32,
    segmax [Q, N/128] f32)."""
    scores = torch.matmul(queries.float(), corpus.float().T)
    return scores, scores.view(queries.shape[0], corpus.shape[0] // SEG, SEG).amax(dim=2)


def split_terms_plain(queries: torch.Tensor) -> torch.Tensor:
    """f32 queries [Q, D] -> their three bf16 terms [3, Q, D]: h = bf16(q),
    m = bf16(q - h), l = bf16(q - h - m), each rounded to nearest even.
    Each residual is exact in f32 and h + m + l == q for every normal f32
    q below 2^128 (1 - 2^-9), where bf16 rounding stays finite, so each
    term's product with a bf16 value is exact in f32 (8 x 8 significant
    bits). The tensor-core body's split_terms does the same on the card."""
    x = queries.float()
    h = x.to(torch.bfloat16)
    r = x - h.float()
    m = r.to(torch.bfloat16)
    return torch.stack((h, m, (r - m.float()).to(torch.bfloat16)))


def score_segmax_terms_plain(queries: torch.Tensor, corpus: torch.Tensor, valid_mask=None):
    """The tensor-core body's arithmetic in plain torch: f32 queries split
    into three bf16 terms (bf16 queries are one), each term's exact product
    with the widened bf16 slab summed in f32, then the mask and the segment
    max -> (scores [Q, N] f32, segmax [Q, N/128] f32)."""
    terms = queries[None] if queries.dtype == torch.bfloat16 else split_terms_plain(queries)
    c = corpus.float().T
    scores = torch.matmul(terms[0].float(), c)
    for t in terms[1:]:
        scores = scores + torch.matmul(t.float(), c)
    if valid_mask is not None:
        scores = torch.where(valid_mask[None, :], scores, float("-inf"))
    return scores, scores.view(queries.shape[0], corpus.shape[0] // SEG, SEG).amax(dim=2)


def _check(queries: torch.Tensor, corpus: torch.Tensor, valid_mask=None) -> None:
    dev = corpus.device
    tensors = (queries, corpus) if valid_mask is None else (queries, corpus, valid_mask)
    if any(t.device != dev for t in tensors):
        raise ValueError(
            f"score_segmax: tensors on different devices ({[str(t.device) for t in tensors]})"
        )
    if queries.dim() != 2 or corpus.dim() != 2 or (valid_mask is not None and valid_mask.dim() != 1):
        raise ValueError("score_segmax: expects queries [Q, D], corpus [N, D], mask [N]")
    q, d = queries.shape
    n = corpus.shape[0]
    if corpus.shape[1] != d or (valid_mask is not None and valid_mask.shape[0] != n):
        raise ValueError(
            f"score_segmax: shapes {[tuple(t.shape) for t in tensors]} do not agree"
        )
    if valid_mask is not None and valid_mask.dtype != torch.bool:
        raise TypeError(f"score_segmax: mask must be bool, got {valid_mask.dtype}")
    if q < 1 or n % SEG:
        raise ValueError(f"score_segmax: need Q >= 1 and N % {SEG} == 0 (Q={q}, N={n})")
    if corpus.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"score_segmax: corpus must be float32 or bfloat16, got {corpus.dtype}")
    if queries.dtype != torch.float32 and not (
        queries.dtype == torch.bfloat16 and corpus.dtype == torch.bfloat16
    ):
        raise TypeError(
            f"score_segmax: queries must be float32, or bfloat16 on a bfloat16 slab "
            f"(got {queries.dtype} on {corpus.dtype})"
        )
    if dev.type == "cuda":
        if d % 8:
            raise ValueError(f"score_segmax: D must be a multiple of 8 (D={d})")
        for name, t in zip(("queries", "corpus", "mask"), tensors):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"score_segmax: {name} must be contiguous and 16-byte aligned")


def _scratch(queries: torch.Tensor, corpus: torch.Tensor):
    """The three bf16 terms' buffer the tensor-core body splits f32 queries
    into on a bf16 slab (the kernel allocates nothing); None otherwise."""
    if corpus.dtype == torch.bfloat16 and queries.dtype == torch.float32:
        return torch.empty(3 * queries.numel(), dtype=torch.bfloat16, device=queries.device)
    return None


def score_segmax(queries: torch.Tensor, corpus: torch.Tensor, valid_mask: torch.Tensor):
    """queries [Q, D] f32 (or bf16 on a bf16 slab), corpus [N, D] f32 or
    bf16, valid_mask [N] bool
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
    scratch = _scratch(queries, corpus)
    err = lib.score_segmax_masked(
        queries.data_ptr(), corpus.data_ptr(), valid_mask.data_ptr(),
        scores.data_ptr(), segmax.data_ptr(), q, n, d,
        int(corpus.dtype == torch.bfloat16), int(queries.dtype == torch.bfloat16),
        None if scratch is None else scratch.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.score_segmax_error_string(err).decode()
        raise RuntimeError(f"score_segmax kernel launch failed: {msg} ({err})")
    score_segmax.launches += 1
    return scores, segmax


score_segmax.launches = 0


def fused_score_segmax(queries: torch.Tensor, corpus: torch.Tensor):
    """queries [Q, D] f32 (or bf16 on a bf16 slab), corpus [N, D] f32 or
    bf16 -> (scores [Q, N] f32, segmax [Q, N/128] f32), with no mask.

    CUDA tensors launch the kernel (and count the launch in
    ``fused_score_segmax.launches``); CPU tensors take
    fused_score_segmax_plain."""
    _check(queries, corpus)
    dev = corpus.device
    if dev.type == "cpu":
        return fused_score_segmax_plain(queries, corpus)
    if dev.type != "cuda":
        raise ValueError(f"fused_score_segmax: unsupported device {dev}")
    lib = build.load("score_segmax")
    q, d = queries.shape
    n = corpus.shape[0]
    scores = torch.empty((q, n), dtype=torch.float32, device=dev)
    segmax = torch.empty((q, n // SEG), dtype=torch.float32, device=dev)
    scratch = _scratch(queries, corpus)
    err = lib.score_segmax_unmasked(
        queries.data_ptr(), corpus.data_ptr(), scores.data_ptr(), segmax.data_ptr(),
        q, n, d, int(corpus.dtype == torch.bfloat16), int(queries.dtype == torch.bfloat16),
        None if scratch is None else scratch.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.score_segmax_error_string(err).decode()
        raise RuntimeError(f"fused_score_segmax kernel launch failed: {msg} ({err})")
    fused_score_segmax.launches += 1
    return scores, segmax


fused_score_segmax.launches = 0


def segmented_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int, num_segments: int = 256):
    """Exact top-k by the unmasked score + segment-max pass and the
    segmented selection (counterpart of pallas_segmented_topk; exact for
    S = min(max(num_segments, k), N/128) >= k, the argument of
    ops/fast_topk.py). -> (values [Q, k] f32, indices [Q, k] int32)."""
    scores, segmax = fused_score_segmax(queries, corpus)
    return segmented_select_from(scores, segmax, k, num_segments=num_segments, segment_size=SEG)
