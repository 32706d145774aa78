"""Int8-quantised corpus, the capacity mode (port of
rust_local_rag_tpu/ops/quantized.py).

Per-row symmetric int8 stores a 10M x 768 corpus in 7.7 GB (+40 MB of f32
scales), half of a bf16 slab. The searches built on it (here the
uncertified two-phase helper, in ops/hybrid the certified first stage and
the full-f32 escalation) score the int8 rows against int8-quantised
queries and rescore a candidate pool against the f32 query.

The int8 x int8 -> int32 product is ``torch._int_mm`` (cuBLASLt's int8
GEMM on the card), as the JAX package computes it with a dot_general
outside any Pallas kernel. The card takes M > 16 and K and N multiples of
8, both operands K-major; int8_scores puts the queries on the M side, so
the scores come out query-major for the selection with no transpose, and
pads to that shape on every device, so the CPU runs the same call.
Nothing reroutes it: a shape the card refuses raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rust_local_rag_tpu_torch.ops.fast_topk import segmented_exact_topk_scores


class QuantizedCorpus(NamedTuple):
    values: torch.Tensor  # [N, D] int8
    scales: torch.Tensor  # [N, 1] f32 (per row)


def quantize_rows(rows: torch.Tensor):
    """[R, D] -> ([R, D] int8, [R, 1] f32 scale): per-row symmetric,
    scale = max(absmax, 1e-10) / 127, round half to even, clip to ±127
    (the corpus's rule and the queries')."""
    r32 = rows.float()
    absmax = r32.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-10) / 127.0
    return torch.clamp(torch.round(r32 / scale), -127, 127).to(torch.int8), scale


def quantize_corpus(corpus: torch.Tensor) -> QuantizedCorpus:
    """Per-row symmetric int8: row / (absmax / 127)."""
    values, scales = quantize_rows(corpus)
    return QuantizedCorpus(values=values, scales=scales)


def gather_dequantized(values: torch.Tensor, scales: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Rows of `slots` ([...] int) dequantised on the device -> [..., D] f32
    (``v.float() * s``, the JAX order)."""
    slots = slots.long()
    return values[slots].float() * scales[:, 0][slots][..., None]


def int8_scores(q_int8: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """[Q, D] int8 queries x [N, D] int8 rows -> [Q, N] int32.

    One ``torch._int_mm(q, values.t())``: the queries are the M side, the
    rows the N side, both K-major. Q pads to a multiple of 8 above 16, and
    D and N (where they are not) to multiples of 8, with zeros, which add
    nothing to a sum; a store's slab (capacity a power of two, D 768) is
    never copied. The sums are exact in int32 (|s| <= 127^2 * D)."""
    qn, d = q_int8.shape
    n = values.shape[0]
    d_pad, n_pad = -d % 8, -n % 8
    q = torch.nn.functional.pad(q_int8, (0, d_pad, 0, max(24, -(-qn // 8) * 8) - qn))
    v = torch.nn.functional.pad(values, (0, d_pad, 0, n_pad)) if d_pad or n_pad else values
    return torch._int_mm(q, v.t())[:qn, :n]


def quantized_topk(queries: torch.Tensor, corpus: QuantizedCorpus, k: int, candidates: int = 512):
    """[Q, D] queries vs the int8 corpus -> (values [Q, k] f32, indices
    [Q, k] int32), uncertified.

    Phase 1: int8 x int8 scoring (queries quantised per row) and the
    segmented selection of the top `candidates`. Phase 2: the candidates'
    rows dequantised and rescored against the f32 query, for the final
    order. The pool can miss a true top-k row at the int8 precision
    boundary; ops/hybrid.hybrid_topk_quantized certifies instead."""
    qn, d = queries.shape
    n = corpus.values.shape[0]
    c = min(max(candidates, k), n)
    q32 = queries.float()
    q_int8, q_scale = quantize_rows(q32)
    scores = int8_scores(q_int8, corpus.values).float() * q_scale * corpus.scales[:, 0][None, :]
    _, cand_idx = segmented_exact_topk_scores(scores, c)
    rows = gather_dequantized(corpus.values, corpus.scales, cand_idx)  # [Q, C, D]
    rescored = torch.bmm(rows, q32[:, :, None])[:, :, 0]
    vals, sel = torch.topk(rescored, k, dim=1)
    return vals, torch.gather(cand_idx.long(), 1, sel).to(torch.int32)
