"""Hybrid first stage: dense scores + BM25 blend + exact top-k, the MMR
hot lane's one-call pool select + greedy MMR, and the int8 capacity
mode's certified first stage and full-f32 escalation (port of
rust_local_rag_tpu/ops/hybrid.py).

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

Int8 slabs (hybrid_topk_quantized) launch no score + segment-max kernel:
the int8 product is ops/quantized.int8_scores and the planes around it
are plain torch, as the JAX package's are plain XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_local_rag_tpu_torch.ops.fast_topk import (
    segmented_exact_topk_scores,
    segmented_select_from,
)
from rust_local_rag_tpu_torch.ops.mmr import mmr_select_batch
from rust_local_rag_tpu_torch.ops.quantized import gather_dequantized, int8_scores, quantize_rows
from rust_local_rag_tpu_torch.ops.score_segmax import score_segmax

NEG_INF = float("-inf")
F32_EPSILON = 1.1920929e-07

# default sparse width for lexical hits: top_k*5 <= 500 (MAX_TOP_K = 100)
LEX_WIDTH = 512
# the diversity path's pool*5 request needs the wider bucket
LEX_WIDTH_BUCKETS = (LEX_WIDTH, 2048)
# rows a block of the full-f32 escalation widens to f32 at once (403 MB at
# D 768): the f32 copy of the int8 slab is never whole
DEQUANT_BLOCK_ROWS = 1 << 17


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


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
        e_vals, e_idx = _select(masked_emb, k_eff)
    return _blend_union(
        masked_emb, e_vals, e_idx, lex_slots, lex_vals, w_embedding, w_lexical, k, k_eff,
        rows_fn=lambda safe: corpus[safe.long()], with_sims=with_sims,
    )


def _select(scores: torch.Tensor, k: int):
    """Exact top-k of a [Q, N] plane: the segmented selection at N >= 65536,
    else torch.topk (the JAX package's two branches)."""
    if scores.shape[1] >= 65536:
        return segmented_exact_topk_scores(scores, k)
    return torch.topk(scores, k, dim=1)


def _blend_union(
    masked_emb, e_vals, e_idx, lex_slots, lex_vals, w_embedding, w_lexical, k, k_eff,
    rows_fn=None, with_sims: bool = False,
):
    """Blend the exact embedding top-k with the sparse lexical hits over
    their union and select the combined top-k. With with_sims, also the
    pairwise similarities of the k selected candidates (for MMR), from
    rows_fn(safe_idx [Q, k]) -> [Q, k, D] rows (a -1 slot gives row 0's
    vector, as in the JAX package): f32 sums of f32 rows (a bf16 slab's
    rows go to f32 first), as Precision.HIGHEST."""
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
    idx = torch.where(vals == NEG_INF, -1, idx).to(torch.int32)
    if not with_sims:
        return vals, emb_k, lex_k, idx
    cand = rows_fn(idx.clamp(min=0)).float()  # [Q, k, D]
    return vals, emb_k, lex_k, idx, torch.bmm(cand, cand.transpose(1, 2))


def pack_topk(vals, emb_k, lex_k, idx, exact=None) -> torch.Tensor:
    """[Q, 4, k] int32: the three float planes as their bits, then idx;
    with an int8 certificate `exact` [Q] bool, [Q, 5, k] with it broadcast
    along k as channel 4 (1 = exact)."""
    bits = lambda x: x.contiguous().view(torch.int32)  # noqa: E731
    planes = [bits(vals), bits(emb_k), bits(lex_k), idx.to(torch.int32)]
    if exact is not None:
        planes.append(exact.to(torch.int32)[:, None].expand(-1, vals.shape[1]))
    return torch.stack(planes, dim=1)


def hybrid_topk_packed(
    queries, corpus, valid_mask, lex_slots, lex_vals, w_embedding, w_lexical, k: int
) -> torch.Tensor:
    """hybrid_topk with the four outputs packed into one [Q, 4, k] int32
    tensor, float planes carried as their bits: 0=combined, 1=embedding,
    2=lexical_norm, 3=idx. One device->host copy fetches everything."""
    return pack_topk(*hybrid_topk(
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
    return pack_topk(
        torch.where(ok, take(vals_c), NEG_INF),
        torch.where(ok, take(emb_c), NEG_INF),
        torch.where(ok, take(lex_c), 0.0),
        torch.where(ok, take(idx_c), -1),
    )


def _int8_p1(q32: torch.Tensor, values: torch.Tensor, scales: torch.Tensor):
    """Phase 1 of the int8 first stage -> (p1 [Q, N] f32, q_scale [Q, 1]):
    p1(i) = <q_i8, v_i8> * q_scale * scale_i, in that order. The int32
    sums are exact and below 2^24, so they widen to f32 exactly (inside the
    first multiply) and p1 is bit-identical to the JAX package's."""
    q_int8, q_scale = quantize_rows(q32)
    p1 = torch.mul(int8_scores(q_int8, values), q_scale)
    return p1.mul_(scales[:, 0][None, :]), q_scale


def _int8_upper(p1: torch.Tensor, q_scale: torch.Tensor, l1: torch.Tensor, valid_mask: torch.Tensor):
    """Upper bound u = p1 + eps of every row's true dequantised score,
    -inf at freed slots -> [Q, N] f32 (p1 is overwritten). eps =
    (q_scale / 2) * l1_i * 1.001 + 1e-6 (the JAX package's inflation for
    the rounding of p1)."""
    eps = torch.mul(q_scale * 0.5, l1[None, :])
    p1.add_(eps.mul_(1.001).add_(1e-6))
    return p1.masked_fill_(~valid_mask[None, :], NEG_INF)


def _first_occurrence(idx: torch.Tensor) -> torch.Tensor:
    """[Q, M] bool: True where idx[q, j] is not held by an earlier
    position of its row (JAX: argmax of the [Q, M, M] equality, taken here
    from a stable sort in O(M log M) instead)."""
    sorted_idx, order = torch.sort(idx, dim=1, stable=True)
    first = torch.ones_like(idx, dtype=torch.bool)
    first[:, 1:] = sorted_idx[:, 1:] != sorted_idx[:, :-1]
    return torch.empty_like(first).scatter_(1, order, first)


def hybrid_topk_quantized(
    queries: torch.Tensor,      # [Q, D] f32 unit-normalised
    values: torch.Tensor,       # [N, D] int8 slab
    scales: torch.Tensor,       # [N, 1] f32 per-row scales
    l1: torch.Tensor,           # [N] f32 scale_i * ||v_i8||_1
    valid_mask: torch.Tensor,   # [N] bool
    lex_slots: torch.Tensor,    # [Q, L] int32
    lex_vals: torch.Tensor,     # [Q, L] f32
    w_embedding: torch.Tensor,
    w_lexical: torch.Tensor,
    k: int,
    with_sims: bool = False,
    candidates: int = 0,        # phase-1 pool (0: the pow2 bucket of 4k)
):
    """The int8 capacity mode's first stage, EXACT with respect to the
    dequantised corpus and certified per query
    -> (combined, embedding, lexical_norm, idx, exact [Q] bool[, cand_sims]).

    Phase 1 scores p1(i) = <q_i8, v_i8> * q_scale * scale_i in int8. The
    query's quantisation error e = q - q_i8 * q_scale has |e_j| <=
    q_scale / 2, so the true score s(i) = <q, v_i8 * scale_i> lies within
    eps_i = (q_scale / 2) * scale_i * ||v_i8||_1 of p1(i) (Hoelder; the
    int32 dot is exact). The pool is the top C rows by the upper bound
    u = p1 + eps; the pool and the lexical hits are rescored in f32. Every
    row outside the pool has a true score <= tau = the pool's least u, so
    when the k-th rescored pool score is >= tau the top-k is exact
    (`exact`); the engine sends a query that fails to
    hybrid_topk_dequant_full. A pool that holds every valid row certifies
    (tau = -inf). tau stays on the device: nothing here waits for it.
    """
    qn, d = queries.shape
    n = values.shape[0]
    if candidates <= 0:
        candidates = min(_next_pow2(4 * k), n)
    c = min(max(candidates, k), n)

    q32 = queries.float()
    p1, q_scale = _int8_p1(q32, values, scales)
    u_vals, e_idx = _select(_int8_upper(p1, q_scale, l1, valid_mask), c)
    del p1
    # a -inf bound is a freed slot: the rescore must not bring it back
    e_idx = torch.where(u_vals == NEG_INF, -1, e_idx.to(torch.int32))
    tau = torch.where(valid_mask.sum() <= c, NEG_INF, u_vals[:, -1])  # [Q]

    # union with the lexical hits (the containment argument of hybrid_topk);
    # a slot held twice keeps its first position
    lex_slots = lex_slots.to(torch.int32)
    lex_pad = lex_slots < 0
    all_idx = torch.cat([e_idx, torch.where(lex_pad, -1, lex_slots)], dim=1)  # [Q, C+L]
    keep = _first_occurrence(all_idx) & (all_idx >= 0)

    # phase 2: the union's rows dequantised and rescored in f32
    rows = gather_dequantized(values, scales, all_idx.clamp(min=0))  # [Q, C+L, D]
    emb_f32 = torch.bmm(rows, q32[:, :, None])[:, :, 0]

    pool_scores = torch.where(e_idx >= 0, emb_f32[:, :c], NEG_INF)
    kth = torch.topk(pool_scores, min(k, c), dim=1).values[:, -1]
    exact = kth >= tau

    lv = torch.where(lex_pad, 0.0, lex_vals.float())
    lexn_sparse = lv / torch.clamp(lv.amax(dim=1, keepdim=True), min=F32_EPSILON)
    match_e = e_idx[:, :, None] == torch.where(lex_pad, -2, lex_slots)[:, None, :]
    e_lexn = torch.where(match_e, lexn_sparse[:, None, :], 0.0).sum(dim=2)
    lexn = torch.cat([e_lexn, lexn_sparse], dim=1)

    combined = torch.where(keep, w_embedding * emb_f32 + w_lexical * lexn, NEG_INF)
    if combined.shape[1] < k:
        padw = k - combined.shape[1]
        pad = torch.nn.functional.pad
        combined = pad(combined, (0, padw), value=NEG_INF)
        all_idx = pad(all_idx, (0, padw), value=-1)
        emb_f32 = pad(emb_f32, (0, padw), value=NEG_INF)
        lexn = pad(lexn, (0, padw))
        rows = pad(rows, (0, 0, 0, padw))
    vals, sel = torch.topk(combined, k, dim=1)
    idx = torch.gather(all_idx, 1, sel)
    emb_k = torch.gather(emb_f32, 1, sel)
    lex_k = torch.gather(lexn, 1, sel)
    idx = torch.where(vals == NEG_INF, -1, idx).to(torch.int32)
    if not with_sims:
        return vals, emb_k, lex_k, idx, exact
    cand = torch.gather(rows, 1, sel[:, :, None].expand(-1, -1, d))
    return vals, emb_k, lex_k, idx, exact, torch.bmm(cand, cand.transpose(1, 2))


def hybrid_topk_quantized_packed(
    queries, values, scales, l1, valid_mask, lex_slots, lex_vals, w_embedding, w_lexical, k: int,
    candidates: int = 0,
) -> torch.Tensor:
    """hybrid_topk_quantized packed into one [Q, 5, k] int32 tensor: the
    hot lane's four channels, then channel 4, the certificate (1 =
    exact) broadcast along k."""
    return pack_topk(*hybrid_topk_quantized(
        queries, values, scales, l1, valid_mask, lex_slots, lex_vals, w_embedding, w_lexical, k,
        candidates=candidates,
    ))


def hybrid_topk_dequant_full(
    queries: torch.Tensor,      # [Q, D] f32 unit-normalised
    values: torch.Tensor,       # [N, D] int8 slab
    scales: torch.Tensor,       # [N, 1] f32
    valid_mask: torch.Tensor,   # [N] bool
    lex_slots: torch.Tensor,
    lex_vals: torch.Tensor,
    w_embedding: torch.Tensor,
    w_lexical: torch.Tensor,
    k: int,
    with_sims: bool = False,
):
    """The unconditionally exact int8 lane, the escalation target of a
    failed certificate: every row scored in f32 against the dequantised
    slab, <q, v_i8> * scale_i (TF32 off; no query quantisation, no pool),
    then the exact selection and the union blend. The slab is widened to
    f32 DEQUANT_BLOCK_ROWS rows at a time, so the f32 corpus is never
    held whole; the [Q, N] plane is the failing queries' only."""
    n = values.shape[0]
    emb = dequant_scores(queries.float(), values, scales)
    emb.masked_fill_(~valid_mask[None, :], NEG_INF)
    k_eff = min(k, n)
    e_vals, e_idx = _select(emb, k_eff)
    return _blend_union(
        emb, e_vals, e_idx, lex_slots, lex_vals, w_embedding, w_lexical, k, k_eff,
        rows_fn=lambda safe: gather_dequantized(values, scales, safe), with_sims=with_sims,
    )


def dequant_scores(q32: torch.Tensor, values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[Q, N] f32 scores <q, v_i8> * scale_i of f32 queries against an
    int8 slab (TF32 off), the slab widened to f32 DEQUANT_BLOCK_ROWS rows at
    a time."""
    n = values.shape[0]
    emb = torch.empty((q32.shape[0], n), dtype=torch.float32, device=q32.device)
    for r0 in range(0, n, DEQUANT_BLOCK_ROWS):
        r1 = min(r0 + DEQUANT_BLOCK_ROWS, n)
        emb[:, r0:r1] = torch.mm(q32, values[r0:r1].float().t()) * scales[r0:r1, 0]
    return emb


def unpack_topk(arr, nq: int, k: int):
    """Host-side unpack of a fetched [Q, 4|5, k'] packed int32 result into
    (vals, emb, lex, idx) numpy views trimmed to [nq, k]; an int8 lane's
    certificate (channel 4) is left to the caller."""
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
