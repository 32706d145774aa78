"""Corpus-sharded exact first stages (port of
rust_local_rag_tpu/parallel/sharded_search.py).

The slab is row-sharded over one or more mesh axes. Each shard runs the
single-device first stage over its rows on its own device: the masked
score + segment-max kernel (ops/score_segmax.py) and the segmented
selection where ops/hybrid.uses_score_segmax(rows) holds, a full-f32
matmul and ops/hybrid._select otherwise (the JAX package's einsum at
Precision.HIGHEST; TF32 stays off). The shards' (score, global index)
candidates are then merged innermost axis first: every shard's [Q, w]
candidates are copied onto the lead device of its group in position
order and reduced to k, then the next axis out, so with axes ("slice",
"corpus") only k candidates a slice cross the slice axis.

Exactness (the JAX module's argument): a global top-k element on shard s
has fewer than k better elements globally, hence within s, so it is in
s's local top-k (or is one of s's lexical hits, which are all carried);
every level of the merge keeps it by the same argument. The order among
exactly tied scores may differ from the unsharded path's.

One process drives every shard (the JAX package's single controller): all
shards' work is queued before any merge copy, and nothing here waits on
the device. With data_axis, the query batch and its lexical rows split
into blocks along that axis; block r runs over mesh row r's shards and
the blocks' outputs are concatenated on the lead device. Mesh axes that
are neither the corpus axes nor data_axis replicate the work in JAX; here
their index-0 positions compute it once.

Tensors arrive as ShardedTensors laid out on the same mesh and axes (the
sharded ChunkStore's), used block by block, or as plain tensors (or
ShardedTensors of another layout), cut into blocks and moved here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rust_local_rag_tpu_torch.ops.fast_topk import segmented_select_from
from rust_local_rag_tpu_torch.ops.hybrid import (
    F32_EPSILON,
    _first_occurrence,
    _int8_p1,
    _int8_upper,
    _select,
    dequant_scores,
    uses_score_segmax,
)
from rust_local_rag_tpu_torch.ops.quantized import gather_dequantized
from rust_local_rag_tpu_torch.ops.score_segmax import score_segmax
from rust_local_rag_tpu_torch.parallel.mesh import Mesh, ShardedTensor, as_axes

NEG_INF = float("-inf")


class _Layout:
    """Where each shard of a call lives: `rows_by_block[r]` lists the mesh
    positions of data block r's shards in flat shard order (outer axis
    first)."""

    def __init__(self, mesh: Mesh, corpus_axis, data_axis: Optional[str], n: int, what: str):
        self.mesh = mesh
        self.axes = as_axes(corpus_axis)
        self.sizes = [mesh.shape[a] for a in self.axes]
        self.n_shards = int(np.prod(self.sizes))
        if n % self.n_shards:
            raise ValueError(what.format(n=n, s=self.n_shards))
        self.rows = n // self.n_shards
        self.dp = mesh.shape[data_axis] if data_axis else 1
        names = mesh.axis_names
        self.rows_by_block = []
        for r in range(self.dp):
            positions = []
            for cidx in np.ndindex(*self.sizes):
                pos = [0] * len(names)
                for a, i in zip(self.axes, cidx):
                    pos[names.index(a)] = i
                if data_axis:
                    pos[names.index(data_axis)] = r
                positions.append(tuple(pos))
            self.rows_by_block.append(positions)

    def block(self, x, pos: tuple, shard: int) -> torch.Tensor:
        """Shard `shard`'s rows of x on mesh.devices[pos]."""
        if isinstance(x, ShardedTensor) and x.mesh == self.mesh and x.axes == self.axes:
            return x.block(pos)
        if isinstance(x, ShardedTensor):
            x = x.full()
        return x[shard * self.rows:(shard + 1) * self.rows].to(self.mesh.devices[pos])

    def queries(self, x, r: int, pos: tuple) -> torch.Tensor:
        """Data block r of a [Q, ...] query-side tensor on mesh.devices[pos]."""
        if isinstance(x, ShardedTensor):
            x = x.full()
        if x.shape[0] % self.dp:
            raise ValueError(f"{x.shape[0]} query rows must divide across {self.dp} data blocks")
        b = x.shape[0] // self.dp
        return x[r * b:(r + 1) * b].to(self.mesh.devices[pos]).contiguous()

    def merge(self, cands: list, k: int) -> tuple:
        """cands[shard] = (vals [Q, w], *planes [Q, w]) on the shard's
        device -> the merged (vals [Q, <=k], *planes) on the block's lead
        device, innermost axis first."""
        for size in reversed(self.sizes):
            cands = [_reduce(cands[i:i + size], k) for i in range(0, len(cands), size)]
        return cands[0]


def _reduce(group: list, k: int) -> tuple:
    """One merge level: the group's candidates side by side in position
    order on its first member's device (JAX: all_gather, transpose,
    reshape), then the top min(k, width) of them."""
    dev = group[0][0].device
    planes = [torch.cat([g[p].to(dev) for g in group], dim=1) for p in range(len(group[0]))]
    vals, sel = torch.topk(planes[0], min(k, planes[0].shape[1]), dim=1)
    return (vals, *(torch.gather(p, 1, sel) for p in planes[1:]))


def _pad_k(vals, emb_k, lex_k, idx, k: int):
    """Pad a merged result to k (-inf / 0 / 0 / -1) and give every -inf
    value the index -1."""
    pad = k - vals.shape[1]
    if pad > 0:
        f = torch.nn.functional.pad
        vals, emb_k, lex_k = f(vals, (0, pad), value=NEG_INF), f(emb_k, (0, pad)), f(lex_k, (0, pad))
        idx = f(idx, (0, pad), value=-1)
    return vals, emb_k, lex_k, torch.where(vals == NEG_INF, -1, idx).to(torch.int32)


def _dense(q: torch.Tensor, c: torch.Tensor, m: torch.Tensor, k: int):
    """A shard's masked dense scores [Q, rows] and their exact top-k:
    the masked kernel and the segmented selection where the slab takes
    the kernel, else a full-f32 matmul and _select."""
    if uses_score_segmax(c.shape[0]):
        scores, segmax = score_segmax(q, c, m)
        vals, idx = segmented_select_from(scores, segmax, k)
        return scores, vals, idx
    scores = torch.where(m[None, :], torch.matmul(q.float(), c.float().T), NEG_INF)
    vals, idx = _select(scores, k)
    return scores, vals, idx.to(torch.int32)


def _lexical(slots: torch.Tensor, lvals: torch.Tensor, base: int, rows: int):
    """The shard's view of the replicated hit list: the global
    normalisation (per-query max over the whole list, f32::EPSILON floor,
    so every shard divides by the same number), the hits' local slots and
    which of them lie on this shard."""
    slots = slots.to(torch.int32)
    lex_pad = slots < 0
    lv = torch.where(lex_pad, 0.0, lvals.float())
    lexn = lv / torch.clamp(lv.amax(dim=1, keepdim=True), min=F32_EPSILON)
    local = slots - base
    on_shard = ~lex_pad & (local >= 0) & (local < rows)
    return lexn, local, on_shard


def _union(masked_emb, e_vals, e_idx, slots, lvals, w_e, w_l, k_local: int, base: int, rows: int):
    """A shard's blend of its dense top-k with its own lexical hits, and
    the top k_local of the union -> (vals, emb, lexn, global idx) [Q,
    k_local] (JAX sharded_search.py:201-252)."""
    lexn_sparse, local, on_shard = _lexical(slots, lvals, base, rows)
    e_dead = e_vals == NEG_INF
    match_e = e_idx[:, :, None] == torch.where(on_shard, local, -2)[:, None, :]
    e_lexn = torch.where(match_e, lexn_sparse[:, None, :], 0.0).sum(dim=2)
    e_comb = torch.where(e_dead, NEG_INF, w_e * e_vals + w_l * e_lexn)
    l_emb = torch.gather(masked_emb, 1, torch.where(on_shard, local, 0).long())
    dup = (torch.where(on_shard, local, -2)[:, :, None] == torch.where(e_dead, -3, e_idx)[:, None, :]).any(dim=2)
    l_dead = ~on_shard | dup | ~torch.isfinite(l_emb)
    l_comb = torch.where(l_dead, NEG_INF, w_e * l_emb + w_l * lexn_sparse)
    comb = torch.cat([e_comb, l_comb], dim=1)
    embs = torch.cat([e_vals, l_emb], dim=1)
    lexn = torch.cat([e_lexn, lexn_sparse], dim=1)
    gidx = torch.cat([torch.where(e_dead, -1, e_idx + base), torch.where(on_shard, slots.to(torch.int32), -1)], dim=1)
    vals, sel = torch.topk(comb, k_local, dim=1)
    return vals, torch.gather(embs, 1, sel), torch.gather(lexn, 1, sel), torch.gather(gidx, 1, sel)


def _weights(w_e, w_l, dev):
    return torch.as_tensor(w_e).to(dev), torch.as_tensor(w_l).to(dev)


def _gathered_sims(rows: torch.Tensor) -> torch.Tensor:
    """[Q, k, D] candidate rows -> their [Q, k, k] similarities in f32."""
    rows = rows.float()
    return torch.bmm(rows, rows.transpose(1, 2))


def _run(lay: _Layout, local, k: int) -> list:
    """local(r, shard, pos) for every shard of every data block (all
    queued first), then each block's merge -> [per block merged tuple]."""
    cands = [[local(r, s, pos) for s, pos in enumerate(positions)]
             for r, positions in enumerate(lay.rows_by_block)]
    return [lay.merge(c, k) for c in cands]


def _concat(blocks: list, lead: torch.device, n: int) -> list:
    """Data blocks' outputs concatenated on the lead device, plane by plane."""
    return [torch.cat([b[i].to(lead) for b in blocks]) for i in range(n)]


def sharded_hybrid_topk(
    queries: torch.Tensor,      # [Q, D] unit-normalised f32
    corpus,                     # [N, D] f32 / bf16 slab, row-sharded over corpus_axis
    valid_mask,                 # [N] bool, sharded like the slab
    lex_slots: torch.Tensor,    # [Q, L] int32 GLOBAL slots (-1 pad)
    lex_vals: torch.Tensor,     # [Q, L] f32 raw BM25 scores
    w_embedding,
    w_lexical,
    k: int,
    mesh: Mesh,
    corpus_axis="corpus",
    with_sims: bool = False,
    data_axis: Optional[str] = None,
):
    """Corpus-sharded ops/hybrid.hybrid_topk: same contract, the same
    results up to the order of exact ties -> (combined, embedding,
    lexical_norm, idx int32) [Q, k] on the lead device (+ the [Q, k, k]
    f32 similarities of the merged candidates' rows with with_sims,
    gathered from their shards). corpus_axis may be a tuple of axes
    (outer first) for the hierarchical merge."""
    lay = _Layout(mesh, corpus_axis, data_axis, corpus.shape[0], "slab rows {n} must divide across {s} shards")
    k_local = min(k, lay.rows)

    def local(r, s, pos):
        dev = mesh.devices[pos]
        w_e, w_l = _weights(w_embedding, w_lexical, dev)
        masked, e_vals, e_idx = _dense(lay.queries(queries, r, pos), lay.block(corpus, pos, s),
                                       lay.block(valid_mask, pos, s), k_local)
        return _union(masked, e_vals, e_idx, lay.queries(lex_slots, r, pos), lay.queries(lex_vals, r, pos),
                      w_e, w_l, k_local, s * lay.rows, lay.rows)

    blocks = [_pad_k(*m, k) for m in _run(lay, local, k)]
    out = _concat(blocks, mesh.lead, 4)
    if not with_sims:
        return tuple(out)
    rows = _take(corpus, out[3].clamp(min=0), mesh.lead)
    return (*out, _gathered_sims(rows))


def _take(x, idx: torch.Tensor, dev) -> torch.Tensor:
    """Rows idx of a sharded or plain tensor, on dev."""
    if isinstance(x, ShardedTensor):
        return x.take(idx, device=dev)
    return x[idx.to(x.device).long()].to(dev)


def sharded_hybrid_topk_quantized(
    queries: torch.Tensor,      # [Q, D] f32 unit-normalised
    values,                     # [N, D] int8 slab, row-sharded
    scales,                     # [N, 1] f32, sharded like the slab
    l1,                         # [N] f32 scale_i * ||v_i8||_1, sharded
    valid_mask,                 # [N] bool, sharded
    lex_slots: torch.Tensor,
    lex_vals: torch.Tensor,
    w_embedding,
    w_lexical,
    k: int,
    mesh: Mesh,
    corpus_axis="corpus",
    with_sims: bool = False,
    data_axis: Optional[str] = None,
):
    """Sharded int8 capacity mode: each shard runs the certified first
    stage of ops/hybrid.hybrid_topk_quantized on its rows with a pool of
    k_local = min(k, rows) (phase 1 by the upper bound u = p1 + eps, the
    f32 rescore of the pool and of its lexical hits), then the merge. The
    merged top-k is exact iff every shard certified its own: the failures
    are summed over the shards (the JAX psum) and exact [Q] is "none
    failed". -> (combined, embedding, lexical_norm, idx, exact[,
    sims over dequantised rows])."""
    lay = _Layout(mesh, corpus_axis, data_axis, values.shape[0], "slab rows {n} must divide across {s}")
    k_local = min(k, lay.rows)
    exacts: dict = {}

    def local(r, s, pos):
        dev = mesh.devices[pos]
        w_e, w_l = _weights(w_embedding, w_lexical, dev)
        base, rows = s * lay.rows, lay.rows
        v, sc = lay.block(values, pos, s), lay.block(scales, pos, s)
        m = lay.block(valid_mask, pos, s)
        q32 = lay.queries(queries, r, pos).float()
        p1, q_scale = _int8_p1(q32, v, sc)
        u_vals, e_idx = _select(_int8_upper(p1, q_scale, lay.block(l1, pos, s), m), k_local)
        del p1
        e_idx = torch.where(u_vals == NEG_INF, -1, e_idx.to(torch.int32))
        tau = torch.where(m.sum() <= k_local, NEG_INF, u_vals[:, -1])

        lexn_sparse, local_slot, on_shard = _lexical(lay.queries(lex_slots, r, pos),
                                                     lay.queries(lex_vals, r, pos), base, rows)
        all_local = torch.cat([e_idx, torch.where(on_shard, local_slot, -1)], dim=1)
        keep = _first_occurrence(all_local) & (all_local >= 0)
        cand = gather_dequantized(v, sc, all_local.clamp(min=0))
        emb_f32 = torch.bmm(cand, q32[:, :, None])[:, :, 0]
        pool = torch.where(e_idx >= 0, emb_f32[:, :k_local], NEG_INF)
        exacts[r, s] = torch.topk(pool, k_local, dim=1).values[:, -1] >= tau

        match_e = e_idx[:, :, None] == torch.where(on_shard, local_slot, -2)[:, None, :]
        e_lexn = torch.where(match_e, lexn_sparse[:, None, :], 0.0).sum(dim=2)
        lexn = torch.cat([e_lexn, torch.where(on_shard, lexn_sparse, 0.0)], dim=1)
        comb = torch.where(keep, w_e * emb_f32 + w_l * lexn, NEG_INF)
        vals, sel = torch.topk(comb, k_local, dim=1)
        g_all = torch.where(all_local >= 0, all_local + base, -1)
        idx = torch.where(vals == NEG_INF, -1, torch.gather(g_all, 1, sel))
        return vals, torch.gather(emb_f32, 1, sel), torch.gather(lexn, 1, sel), idx

    blocks = [_pad_k(*m, k) for m in _run(lay, local, k)]
    out = _concat(blocks, mesh.lead, 4)
    exact = torch.cat([
        torch.stack([exacts[r, s].to(mesh.lead) for s in range(lay.n_shards)]).all(dim=0)
        for r in range(lay.dp)
    ])
    if not with_sims:
        return (*out, exact)
    safe = out[3].clamp(min=0)
    rows = _take(values, safe, mesh.lead).float() * _take(scales, safe, mesh.lead)
    return (*out, exact, _gathered_sims(rows))


def sharded_hybrid_topk_dequant_full(
    queries: torch.Tensor,      # [Q, D] f32
    values,                     # [N, D] int8 slab, row-sharded
    scales,                     # [N, 1] f32, sharded
    valid_mask,                 # [N] bool, sharded
    lex_slots: torch.Tensor,
    lex_vals: torch.Tensor,
    w_embedding,
    w_lexical,
    k: int,
    mesh: Mesh,
    corpus_axis="corpus",
    data_axis: Optional[str] = None,
):
    """The unconditionally exact sharded int8 lane (the escalation target
    of a failed certificate): each shard scores its rows in f32 against
    the dequantised slab, <q, v_i8> * scale_i (ops/hybrid.dequant_scores:
    no query quantisation, no pool), takes its exact top-k and blends its
    lexical hits; then the merge -> (combined, embedding, lexical_norm,
    idx) [Q, k]."""
    lay = _Layout(mesh, corpus_axis, data_axis, values.shape[0], "slab rows {n} must divide across {s}")
    k_local = min(k, lay.rows)

    def local(r, s, pos):
        dev = mesh.devices[pos]
        w_e, w_l = _weights(w_embedding, w_lexical, dev)
        q32 = lay.queries(queries, r, pos).float()
        emb = dequant_scores(q32, lay.block(values, pos, s), lay.block(scales, pos, s))
        emb.masked_fill_(~lay.block(valid_mask, pos, s)[None, :], NEG_INF)
        e_vals, e_idx = _select(emb, k_local)
        e_idx = torch.where(e_vals == NEG_INF, -1, e_idx.to(torch.int32))
        return _union(emb, e_vals, e_idx, lay.queries(lex_slots, r, pos), lay.queries(lex_vals, r, pos),
                      w_e, w_l, k_local, s * lay.rows, lay.rows)

    return tuple(_concat([_pad_k(*m, k) for m in _run(lay, local, k)], mesh.lead, 4))


def sharded_exact_topk(lay: _Layout, queries, corpus, k: int, valid_count=None):
    """Exact top-k of the corpus laid out by `lay` (no data axis), rows at
    or past valid_count (the padded tail) masked -> (values [Q, k] f32,
    global indices [Q, k] int32) on the lead device: each shard's exact
    top-k of its masked scores, then the merge. Needs k <= rows a shard
    (each shard must return k candidates for the merge to be exact)."""
    if k > lay.rows:
        raise ValueError(f"k={k} exceeds rows per shard {lay.rows}; exact merge needs k <= shard size")
    n_valid = corpus.shape[0] if valid_count is None else int(valid_count)

    def local(r, s, pos):
        base = s * lay.rows
        m = torch.arange(lay.rows, device=lay.mesh.devices[pos]) < min(max(n_valid - base, 0), lay.rows)
        _, vals, idx = _dense(lay.queries(queries, r, pos), lay.block(corpus, pos, s), m, k)
        return vals, idx + base

    vals, idx = _run(lay, local, k)[0]
    return vals, idx.to(torch.int32)


def sharded_topk(queries, corpus, k: int, mesh: Mesh, corpus_axis: str = "corpus", valid_count=None):
    """Exact top-k with the corpus row-sharded over `corpus_axis`
    (sharded_exact_topk); N must divide evenly by the shard count."""
    lay = _Layout(mesh, corpus_axis, None, corpus.shape[0],
                  "corpus rows {n} must divide evenly across {s} shards; pad the slab to a multiple of the "
                  "shard count")
    return sharded_exact_topk(lay, queries, corpus, k, valid_count)


def shard_corpus(corpus: torch.Tensor, mesh: Mesh, corpus_axis="corpus") -> ShardedTensor:
    """A [N, D] tensor row-sharded over the mesh (each block on its
    device; on the device of `corpus`, a view of it)."""
    return ShardedTensor.from_tensor(mesh, as_axes(corpus_axis), corpus)


def replicate(x: torch.Tensor, mesh: Mesh) -> ShardedTensor:
    """x on every device of the mesh."""
    return ShardedTensor.from_tensor(mesh, (), x)


# the JAX package jits sharded_topk under this name; eager here
sharded_topk_jit = sharded_topk
