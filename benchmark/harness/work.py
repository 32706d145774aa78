"""The yardstick: one H100's published peaks, and the operations and bytes
the algorithms need, reckoned from their shapes (never from what the
program launches, so they read the same whatever implements them).

Peaks (NVIDIA H100 SXM data sheet, dense): 989 TFLOP/s bf16 on the tensor
cores, 67 TFLOP/s f32 outside them, 3.35 TB/s of HBM. A roofline bound
is the larger of bytes / bandwidth and operations / the peak of the
arithmetic the algorithm needs.
"""

from __future__ import annotations

from typing import Iterable

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SEGMENT = 128  # rows of the score + segment-max kernel's segment


def score_segmax_bound(q: int, live_rows: int, dim: int, corpus_bytes: int, query_bytes: int) -> float:
    """Least seconds of one masked score + segment-max over a slab of
    `live_rows` rows (rounded up to the segment): the rows, the queries and
    the mask read once, the [q, rows] scores and [q, rows / 128] segment
    maxima written once; 2 q rows dim operations at the f32 rate for an f32
    slab, and for a bf16 slab with f32 queries three bf16 products (the
    split of each f32 query into bf16 terms) at the bf16 rate."""
    rows = -(-live_rows // SEGMENT) * SEGMENT
    nbytes = rows * dim * corpus_bytes + q * dim * 4 + rows + q * rows * 4 + q * (rows // SEGMENT) * 4
    ops = 2.0 * q * rows * dim
    if corpus_bytes == 4:
        t_ops = ops / F32_FLOPS
    else:
        t_ops = ops * (3 if query_bytes == 4 else 1) / BF16_FLOPS
    return max(nbytes / HBM_BYTES_PER_S, t_ops)


def attention_bound(heads: int, head_dim: int, lengths: Iterable[int], causal: bool = False) -> float:
    """Least seconds of one bf16 attention over sequences of the valid
    `lengths`: q, k, v read once and the output written once at the valid
    tokens (2 bytes each), QK^T and PV at 2 * 2 * heads * head_dim
    operations a (query, key) pair, all pairs or the causal half."""
    tokens = pairs = 0
    for n in lengths:
        tokens += n
        pairs += n * (n + 1) // 2 if causal else n * n
    nbytes = 4 * tokens * heads * head_dim * 2
    ops = 4.0 * pairs * heads * head_dim
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS)


def transformer_flops(cfg: dict, n: int, causal: bool = False, head: int = 0) -> float:
    """Matmul operations of one sequence of n tokens through a pre-norm
    transformer of `cfg` (dim, ffn_dim, depth): the four projections, the
    SwiGLU's three, and attention's two products; plus `head` output
    columns on one position (the encoder's pooled projection, the judge's
    lm_head at its last token)."""
    d, f, depth = cfg["dim"], cfg["ffn_dim"], cfg["depth"]
    pairs = n * (n + 1) // 2 if causal else n * n
    per_layer = 2.0 * n * (4 * d * d + 3 * d * f) + 4.0 * pairs * d
    return depth * per_layer + 2.0 * d * head
