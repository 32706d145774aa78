"""Exact top-k by segmented two-level selection (port of
rust_local_rag_tpu/ops/fast_topk.py).

  1. view the scores as [Q, NT, T] segments and take each segment's max;
  2. keep the top S segments by max;
  3. run an exact top-k over those S segments' contents.

Exactness: a true top-k element x has at most k-1 elements above it, so at
most k-1 segments have a max above x and x's own segment ranks at worst
k-th among the maxima; it is kept whenever S >= k. Exactly tied values may
report a different winner index than a full sort (the order among exact
ties is not part of the contract). torch.topk and gather stand in for
XLA's top_k and take_along_axis.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def segmented_select_from(
    scores: torch.Tensor,
    seg_max: torch.Tensor,
    k: int,
    num_segments: int = 256,
    segment_size: int = 128,
):
    """Selection over a precomputed [Q, NT] segment-max matrix (e.g. the
    score + segment-max kernel's). `scores` is [Q, NT*T].
    -> (values [Q, k] f32, indices [Q, k] int32), descending."""
    qn = scores.shape[0]
    t = segment_size
    nt = seg_max.shape[1]
    s = min(max(num_segments, k), nt)
    _, seg_idx = torch.topk(seg_max, s, dim=1)  # [Q, S]
    seg = scores.view(qn, nt, t)
    cand = torch.gather(seg, 1, seg_idx[:, :, None].expand(qn, s, t)).reshape(qn, s * t)
    vals, flat = torch.topk(cand, k, dim=1)
    seg_of = torch.gather(seg_idx, 1, torch.div(flat, t, rounding_mode="floor"))
    idx = seg_of * t + flat % t
    return vals, idx.to(torch.int32)


def segmented_exact_topk_scores(
    scores: torch.Tensor,
    k: int,
    segment_size: int = 128,
    num_segments: int = 256,
):
    """Exact top-k over a [Q, N] f32 score matrix.
    -> (values [Q, k] f32, indices [Q, k] int32), descending; when N < k
    the tail is -inf with index N."""
    qn, n = scores.shape
    t = segment_size
    nt = -(-n // t)
    s = min(max(num_segments, k), nt)
    if s * t >= n:
        # degenerate: the selection would cover everything
        kk = min(k, n)
        v, i = torch.topk(scores, kk, dim=1)
        i = i.to(torch.int32)
        if kk < k:
            v = torch.nn.functional.pad(v, (0, k - kk), value=NEG_INF)
            i = torch.nn.functional.pad(i, (0, k - kk), value=n)
        return v, i
    pad = nt * t - n
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
    seg_max = scores.view(qn, nt, t).amax(dim=2)
    return segmented_select_from(scores, seg_max, k, num_segments=s, segment_size=t)
