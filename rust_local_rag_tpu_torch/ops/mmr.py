"""Maximal Marginal Relevance diversification (port of
rust_local_rag_tpu/ops/mmr.py).

The reference runs MMR as a greedy host loop over Vec<f32> embeddings
(rag_engine.rs:767-839). The JAX package runs the greedy selection as an
XLA loop on the device (lax.fori_loop, no Pallas kernel); here it is a
Python loop of k steps over [Q, P] device tensors, a few small torch ops a
step, with no host round trip between steps.

Semantics kept exactly:
  * MMR(i) = (1 - lambda) * relevance_i - lambda * max_sim_to_selected_i
    (rag_engine.rs:808-809);
  * max similarity starts from a 0.0 floor (fold(0.0, max) at :800-804),
    so negative similarities never reward a candidate;
  * non-finite similarities are left out of the max (:803);
  * candidates with non-finite relevance are skipped in MMR steps (:794-797);
  * the first selection is always the top-ranked candidate, with no
    finiteness check (swap_remove(0) at :782-784);
  * selection stops early when no finite-scored candidate remains
    (:819-821): the unused tail of the output holds -1.
Tie-break: the first (lowest) index wins (torch.argmax returns the first
maximal index, on the CPU and on the card), as in the JAX package.
Similarities are f32 sums at full f32 (TF32 off), as Precision.HIGHEST;
bf16 rows go to f32 first, so bf16 x bf16 products are exact.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

NEG_INF = float("-inf")


def similarity_matrix(embeddings: torch.Tensor) -> torch.Tensor:
    """[P, D] -> [P, P] pairwise f32 dot products."""
    e = embeddings.float()
    return torch.matmul(e, e.T)


def similarity_matrices(embeddings: torch.Tensor) -> torch.Tensor:
    """[Q, P, D] -> [Q, P, P] pairwise f32 dot products of a batch of
    candidate pools."""
    e = embeddings.float()
    return torch.bmm(e, e.transpose(1, 2))


def mmr_select_host(sims: np.ndarray, relevance: np.ndarray, k: int, diversity_factor: float) -> list:
    """Greedy MMR over a precomputed similarity matrix on the host, with
    the semantics of mmr_select. -> selected indices in order."""
    p = sims.shape[0]
    if p == 0:
        return []
    lam = float(diversity_factor)
    rel = np.asarray(relevance, dtype=np.float32)

    selected = [0]  # swap_remove(0): unconditional first pick
    picked = np.zeros(p, dtype=bool)
    picked[0] = True
    max_sim = np.where(np.isfinite(sims[0]), sims[0], 0.0)
    max_sim = np.maximum(max_sim, 0.0)  # fold(0.0, max) floor

    while len(selected) < k:
        mmr = (1.0 - lam) * rel - lam * max_sim
        mmr[picked | ~np.isfinite(rel) | ~np.isfinite(mmr)] = -math.inf
        best = int(np.argmax(mmr))
        if mmr[best] == -math.inf:
            break
        selected.append(best)
        picked[best] = True
        row = np.where(np.isfinite(sims[best]), sims[best], 0.0)
        max_sim = np.maximum(max_sim, row)
    return selected


def mmr_select_batch(
    embeddings: torch.Tensor,    # [Q, P, D] candidate rows, by descending relevance
    relevance: torch.Tensor,     # [Q, P]
    k: int,
    diversity_factor: float,
    valid_counts: torch.Tensor,  # [Q]: candidates at index >= count are padding
) -> torch.Tensor:
    """Batched greedy MMR on the device: -> [Q, k] int32 indices into the
    candidate axis, -1 in unused slots (k may exceed P).

    Every pairwise similarity is computed once ([Q, P, P], one bmm) and a
    step gathers the chosen row, so a step is about ten small ops. Once a
    step of a query finds nothing, every later step finds nothing (the
    found flags are cumulated at the end), so the state a failed step
    updates is never read."""
    q, p, _ = embeddings.shape
    dev = embeddings.device
    if k <= 0:
        return torch.empty((q, 0), dtype=torch.int32, device=dev)
    lam = float(diversity_factor)
    emb = embeddings.float()
    rel = relevance.float()
    rows = torch.arange(q, device=dev)
    pos_valid = torch.arange(p, device=dev)[None, :] < valid_counts.to(dev)[:, None]
    sims = torch.bmm(emb, emb.transpose(1, 2))
    sims = torch.where(torch.isfinite(sims), sims, 0.0)  # non-finite: out of the max
    # candidates an MMR step may not take: padding, non-finite relevance, picked
    closed = ~(pos_valid & torch.isfinite(rel))
    base = (1.0 - lam) * rel
    max_sim = torch.zeros(q, p, device=dev)  # the fold(0.0, max) floor
    # step 0 takes the top-ranked valid candidate unconditionally
    best = pos_valid.to(torch.int32).argmax(dim=1)
    picks, found = [best], [pos_valid.any(dim=1)]
    for i in range(k):
        if i:
            mmr = base - lam * max_sim
            mmr = torch.where(torch.isfinite(mmr), mmr, NEG_INF).masked_fill_(closed, NEG_INF)
            best = mmr.argmax(dim=1)
            picks.append(best)
            found.append(mmr.amax(dim=1) > NEG_INF)
        max_sim = torch.maximum(max_sim, sims[rows, best])
        closed[rows, best] = True
    ok = torch.stack(found, dim=1).to(torch.int32).cummin(dim=1).values.bool()
    return torch.where(ok, torch.stack(picks, dim=1), -1).to(torch.int32)


def mmr_select(
    embeddings: torch.Tensor,
    relevance: torch.Tensor,
    k: int,
    diversity_factor: float,
    valid_count: Optional[int] = None,
) -> torch.Tensor:
    """Greedy MMR over one pool: [P, D] rows by descending relevance, [P]
    relevance -> [k] int32 indices, -1 in unused slots; candidates at index
    >= valid_count are padding."""
    p = embeddings.shape[0]
    count = torch.tensor([p if valid_count is None else int(valid_count)], device=embeddings.device)
    return mmr_select_batch(embeddings[None], relevance[None], k, diversity_factor, count)[0]
