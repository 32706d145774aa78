"""Dense similarity math (port of rust_local_rag_tpu/ops/similarity.py as
plain torch functions).

Semantics of the reference's loops:

  * normalize      — rag_engine.rs:1763-1771 (skip when ||v||^2 <= 1e-20)
  * cosine         — rag_engine.rs:1742-1759 (eps 1e-10, clamp [-1, 1])
  * dense scoring  — rag_engine.rs:524-541 (dot products of unit vectors)
  * hybrid blend   — rag_engine.rs:515-532 (lexical normalised by the
                     per-query max, floored at f32::EPSILON)

Products accumulate in f32 at full f32 (TF32 off, device.set_full_precision),
as Precision.HIGHEST does in the JAX package.
"""

from __future__ import annotations

import torch

# f32::EPSILON in Rust: the lexical max floor (rag_engine.rs:515-519)
F32_EPSILON = 1.1920929e-07


def normalize(v: torch.Tensor) -> torch.Tensor:
    """A vector at unit length; unchanged when ||v||^2 <= 1e-20."""
    norm_sq = (v.float() ** 2).sum()
    return torch.where(norm_sq > 1e-20, v / torch.sqrt(norm_sq).to(v.dtype), v)


def normalize_rows(m: torch.Tensor) -> torch.Tensor:
    """Row-wise unit normalisation of an [N, D] matrix (same skip rule)."""
    norm_sq = (m.float() ** 2).sum(dim=-1, keepdim=True)
    return torch.where(norm_sq > 1e-20, m / torch.sqrt(norm_sq).to(m.dtype), m)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine with the reference's edges: 0.0 for a norm below 1e-10, the
    result clamped to [-1, 1]."""
    eps = 1e-10
    a32, b32 = a.float(), b.float()
    dot = (a32 * b32).sum()
    norm_a = torch.sqrt((a32 * a32).sum())
    norm_b = torch.sqrt((b32 * b32).sum())
    cos = torch.clamp(dot / (norm_a * norm_b), -1.0, 1.0)
    return torch.where((norm_a < eps) | (norm_b < eps), torch.zeros_like(cos), cos)


def dense_scores(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """[Q, D] x [N, D] -> [Q, N] f32 dot products (both sides unit rows)."""
    return torch.matmul(queries.float(), corpus.float().T)


def blend_scores(
    embedding_scores: torch.Tensor,
    lexical_scores: torch.Tensor,
    embedding_weight: float,
    lexical_weight: float,
) -> torch.Tensor:
    """combined = w_e * emb + w_l * (lex / max(lex)) per query; lexical_scores
    are raw BM25 values on the same candidate axis (0.0 without a hit).
    Shapes [Q, N] both, or [N] both."""
    lex = lexical_scores.float()
    max_lex = torch.clamp(lex.amax(dim=-1, keepdim=True), min=F32_EPSILON)
    return embedding_weight * embedding_scores.float() + lexical_weight * (lex / max_lex)
