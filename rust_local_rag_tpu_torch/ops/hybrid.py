"""Hybrid first stage: dense scores + BM25 blend + exact top-k, and the
MMR hot lane's one-call pool select + greedy MMR (port of
rust_local_rag_tpu/ops/hybrid.py, the f32 / bf16 slab functions).

The BM25 side arrives SPARSE: the host ships the top-L (slot, score)
pairs, never an N-sized array. The blend needs no scatter, by the union
argument of the JAX module:

    combined = w_e * emb + w_l * lex_norm, with lex_norm >= 0 and nonzero
    on at most L slots. A boost only moves an element UP, so the combined
    top-k lies in (embedding top-k) U (lexical slots), and an exact top-k
    over that k + L candidate union is exact overall.

Dense selection: at N >= 65536 with N % 16384 == 0 the masked score +
segment-max kernel (ops/score_segmax.py) feeds the segmented selection,
as the JAX package's Pallas branch does (its VMEM condition is the TPU's
and is dropped); otherwise a plain matmul + mask feeds the segmented
selection (N >= 65536) or torch.topk. Both branches give the same result.
f32 slabs score at full f32 (TF32 off, device.set_full_precision).
"""

from __future__ import annotations

import numpy as np
import torch

from rust_local_rag_tpu_torch.ops.fast_topk import (
    segmented_exact_topk_scores,
    segmented_select_from,
)
from rust_local_rag_tpu_torch.ops.mmr import mmr_select_batch
from rust_local_rag_tpu_torch.ops.score_segmax import score_segmax

NEG_INF = float("-inf")
F32_EPSILON = 1.1920929e-07

# default sparse width for lexical hits: top_k*5 <= 500 (MAX_TOP_K = 100)
LEX_WIDTH = 512
# the diversity path's pool*5 request needs the wider bucket
LEX_WIDTH_BUCKETS = (LEX_WIDTH, 2048)


def lex_width_for(request: int) -> int:
    """Smallest lexical-width bucket covering `request` hits (capped at the
    largest bucket)."""
    for b in LEX_WIDTH_BUCKETS:
        if request <= b:
            return b
    return LEX_WIDTH_BUCKETS[-1]


def uses_score_segmax(n: int) -> bool:
    """Slab sizes whose dense stage runs the score + segment-max kernel."""
    return n >= 65536 and n % 16384 == 0


def hybrid_topk(
    queries: torch.Tensor,      # [Q, D] f32 unit-normalised
    corpus: torch.Tensor,       # [N, D] f32 or bf16 slab (holed)
    valid_mask: torch.Tensor,   # [N] bool
    lex_slots: torch.Tensor,    # [Q, L] int32 slot of each BM25 hit (-1 = pad)
    lex_vals: torch.Tensor,     # [Q, L] f32 raw BM25 scores (0 on pads)
    w_embedding: torch.Tensor,  # 0-d f32
    w_lexical: torch.Tensor,    # 0-d f32
    k: int,
    with_sims: bool = False,
):
    """-> (combined [Q,k], embedding [Q,k], lexical_norm [Q,k], idx [Q,k]
    int32 [, cand_sims [Q,k,k] f32]). Invalid slots score -inf; fewer than
    k valid slots leave -inf / -1 sentinels in the tail. with_sims adds
    the pairwise similarities of the k selected candidates (for MMR; a
    -1 slot contributes row 0's vector, as in the JAX package)."""
    n = corpus.shape[0]
    k_eff = min(k, n)
    if uses_score_segmax(n):
        masked_emb, segmax = score_segmax(queries, corpus, valid_mask)
        e_vals, e_idx = segmented_select_from(masked_emb, segmax, k_eff)
    else:
        emb = torch.matmul(queries.float(), corpus.float().T)
        masked_emb = torch.where(valid_mask[None, :], emb, NEG_INF)
        if n >= 65536:
            e_vals, e_idx = segmented_exact_topk_scores(masked_emb, k_eff)
        else:
            e_vals, e_idx = torch.topk(masked_emb, k_eff, dim=1)
    out = _blend_union(
        masked_emb, e_vals, e_idx, lex_slots, lex_vals, w_embedding, w_lexical, k, k_eff
    )
    if not with_sims:
        return out
    # candidate pairwise similarities for MMR: f32 sums of f32 rows (a bf16
    # slab's rows go to f32 first), as Precision.HIGHEST
    cand = corpus[out[3].clamp(min=0).long()].float()  # [Q, k, D]
    return (*out, torch.bmm(cand, cand.transpose(1, 2)))


def _blend_union(masked_emb, e_vals, e_idx, lex_slots, lex_vals, w_embedding, w_lexical, k, k_eff):
    """Blend the exact embedding top-k with the sparse lexical hits over
    their union and select the combined top-k."""
    if k_eff < k:
        e_vals = torch.nn.functional.pad(e_vals, (0, k - k_eff), value=NEG_INF)
        e_idx = torch.nn.functional.pad(e_idx, (0, k - k_eff), value=-1)
    e_idx = e_idx.to(torch.int32)
    lex_slots = lex_slots.to(torch.int32)

    # lexical normalisation: per-query max over the hit list, floored at
    # f32::EPSILON (rag_engine.rs:515-519)
    lex_pad = lex_slots < 0
    lv = torch.where(lex_pad, 0.0, lex_vals.float())
    max_lex = torch.clamp(lv.amax(dim=1, keepdim=True), min=F32_EPSILON)
    lex_norm_sparse = lv / max_lex  # [Q, L]

    # embedding-side candidates take any lexical boost they have
    match_e = e_idx[:, :, None] == torch.where(lex_pad, -2, lex_slots)[:, None, :]
    e_lexn = torch.where(match_e, lex_norm_sparse[:, None, :], 0.0).sum(dim=2)  # [Q, k]
    e_invalid = e_idx < 0
    e_comb = torch.where(e_invalid, NEG_INF, w_embedding * e_vals + w_lexical * e_lexn)

    # lexical-side candidates: their embedding scores; drop pads, invalid
    # slots and slots already on the embedding side
    safe_slots = torch.where(lex_pad, 0, lex_slots).long()
    l_emb = torch.gather(masked_emb, 1, safe_slots)  # [Q, L]
    dup = (lex_slots[:, :, None] == torch.where(e_invalid, -2, e_idx)[:, None, :]).any(dim=2)
    l_dead = lex_pad | dup | ~torch.isfinite(l_emb)
    l_comb = torch.where(l_dead, NEG_INF, w_embedding * l_emb + w_lexical * lex_norm_sparse)

    # exact top-k over the union
    all_comb = torch.cat([e_comb, l_comb], dim=1)  # [Q, k+L]
    all_emb = torch.cat([e_vals, l_emb], dim=1)
    all_lexn = torch.cat([e_lexn, lex_norm_sparse], dim=1)
    all_idx = torch.cat([e_idx, lex_slots], dim=1)

    vals, sel = torch.topk(all_comb, k, dim=1)
    idx = torch.gather(all_idx, 1, sel)
    emb_k = torch.gather(all_emb, 1, sel)
    lex_k = torch.gather(all_lexn, 1, sel)
    idx = torch.where(vals == NEG_INF, -1, idx)
    return vals, emb_k, lex_k, idx.to(torch.int32)


def _pack(vals, emb_k, lex_k, idx) -> torch.Tensor:
    """[Q, 4, k] int32: the three float planes as their bits, then idx."""
    bits = lambda x: x.contiguous().view(torch.int32)  # noqa: E731
    return torch.stack([bits(vals), bits(emb_k), bits(lex_k), idx.to(torch.int32)], dim=1)


def hybrid_topk_packed(
    queries, corpus, valid_mask, lex_slots, lex_vals, w_embedding, w_lexical, k: int
) -> torch.Tensor:
    """hybrid_topk with the four outputs packed into one [Q, 4, k] int32
    tensor, float planes carried as their bits: 0=combined, 1=embedding,
    2=lexical_norm, 3=idx. One device->host copy fetches everything."""
    return _pack(*hybrid_topk(
        queries, corpus, valid_mask, lex_slots, lex_vals, w_embedding, w_lexical, k
    ))


def hybrid_topk_packed_mmr(
    queries, corpus, valid_mask, lex_slots, lex_vals, w_embedding, w_lexical,
    diversity: float, emb_floor: float, pool_k: int, out_k: int,
) -> torch.Tensor:
    """Diversity (MMR) search in one call with one packed result: the
    hybrid pool select (pool_k candidates; the score + segment-max kernel
    on large slabs), the confidence-floor gate, stable compaction, the
    gather of the candidates' rows, batched greedy MMR (ops/mmr) and the
    hot lane's packed [Q, 4, out_k] int32 layout, in MMR order.

    Semantics of the object lane (reference rag_engine.rs:717-759): the
    floor gates the POOL before MMR, the first pick is the top-ranked
    survivor, and the scores returned are the blend scores. Survivors are
    compacted to the front, keeping their order, because mmr_select_batch
    takes a valid prefix. emb_floor <= 0 disables the gate (a cosine can
    be negative, so 0.0 must not drop candidates)."""
    vals, emb_k, lex_k, idx = hybrid_topk(
        queries, corpus, valid_mask, lex_slots, lex_vals, w_embedding, w_lexical, pool_k
    )
    p = vals.shape[1]
    keep = (idx >= 0) & torch.isfinite(vals)
    if emb_floor > 0.0:
        keep = keep & (emb_k >= emb_floor)
    rank = torch.arange(p, device=vals.device)[None, :]
    order = torch.argsort(torch.where(keep, rank, rank + p), dim=1, stable=True)
    vals_c, emb_c, lex_c, idx_c = (torch.gather(a, 1, order) for a in (vals, emb_k, lex_k, idx))
    counts = keep.sum(dim=1)
    tail = rank >= counts[:, None]
    vals_c = torch.where(tail, NEG_INF, vals_c)
    idx_c = torch.where(tail, -1, idx_c)

    cand = corpus[idx_c.clamp(min=0).long()]  # [Q, P, D]
    sel = mmr_select_batch(cand, vals_c, out_k, diversity, counts).long()  # [Q, out_k]
    ok = sel >= 0
    safe = sel.clamp(min=0)
    take = lambda a: torch.gather(a, 1, safe)  # noqa: E731
    return _pack(
        torch.where(ok, take(vals_c), NEG_INF),
        torch.where(ok, take(emb_c), NEG_INF),
        torch.where(ok, take(lex_c), 0.0),
        torch.where(ok, take(idx_c), -1),
    )


def unpack_topk(arr, nq: int, k: int):
    """Host-side unpack of a fetched [Q, 4, k'] packed int32 result into
    (vals, emb, lex, idx) numpy views trimmed to [nq, k]."""
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype != np.int32:
        raise TypeError(f"packed top-k must be int32, got {arr.dtype}")
    f = arr.view(np.float32)
    return f[:nq, 0, :k], f[:nq, 1, :k], f[:nq, 2, :k], arr[:nq, 3, :k]


def pack_sparse_lex(pairs, slot_for_id, width: int = LEX_WIDTH):
    """[(chunk_id, score)] -> ([1, width] int32 slots, [1, width] f32
    vals), -1-padded; ids without a slot are skipped."""
    slots = np.full((1, width), -1, dtype=np.int32)
    vals = np.zeros((1, width), dtype=np.float32)
    j = 0
    for cid, score in pairs:
        slot = slot_for_id(cid)
        if slot is None or j >= width:
            continue
        slots[0, j] = slot
        vals[0, j] = score
        j += 1
    return slots, vals
