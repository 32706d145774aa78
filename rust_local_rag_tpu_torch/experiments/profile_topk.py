"""Where the exact top-k pipeline's time goes, stage by stage, on the card
(port of scripts/profile_topk.py). The stages are cumulative:

  matmul    the library GEMM alone (common.gemm_scores)
  kernel    row 2's kernel: ops/score_segmax.fused_score_segmax, scores
            and segment maxima in one pass (bf16 queries on the bf16 slab:
            its tensor-core body)
  segtopk   ... + torch.topk over the segment maxima
  gather    ... + the gather of the selected segments' scores
  final     ... + the final exact top-k (the whole pipeline)

The differences between stages place the selection's cost. The port's
segment maxima are [Q, N/128] (the JAX kernel's [N/128, Q] was a TPU
store layout), so the script's transposes go. Each stage runs STEPS
times back to back between two CUDA events, best of 3 (common.timed).
BENCH_N (a multiple of 128; default 1,245,184) and BENCH_S (segments
kept, default 128) set the shape, as in the script.

    python -m rust_local_rag_tpu_torch.experiments.profile_topk
"""

from __future__ import annotations

import json
import os

import torch

from rust_local_rag_tpu_torch.experiments import common
from rust_local_rag_tpu_torch.experiments.common import D, K, Q
from rust_local_rag_tpu_torch.ops.score_segmax import SEG, fused_score_segmax


def segment_ids(sm: torch.Tensor, s_keep: int) -> torch.Tensor:
    """The s_keep segments with the largest maxima, [Q, s_keep]."""
    return torch.topk(sm, s_keep, dim=1).indices


def gather_segments(scores: torch.Tensor, seg_idx: torch.Tensor) -> torch.Tensor:
    """The selected segments' scores, [Q, s_keep, 128]."""
    q, n = scores.shape
    s = seg_idx.shape[1]
    return torch.gather(scores.view(q, n // SEG, SEG), 1, seg_idx[:, :, None].expand(q, s, SEG))


def pipeline(qs: torch.Tensor, corpus: torch.Tensor, s_keep: int, k: int = K):
    """The whole pipeline (the kernel, then common.select's two stages)
    -> (values [Q, k] f32, indices [Q, k] int32)."""
    scores, sm = fused_score_segmax(qs, corpus)
    return common.select(scores, sm, SEG, s_keep, k)


def stages(s_keep: int, k: int = K) -> dict:
    """name -> stage(qs, corpus), each reduced to a small tensor as the
    script reduces it."""
    def st_matmul(qs, c):
        return common.gemm_scores(qs, c)[:, :8]

    def st_kernel(qs, c):
        scores, sm = fused_score_segmax(qs, c)
        return scores[:, :8] + sm[:, :8]

    def st_segtopk(qs, c):
        scores, sm = fused_score_segmax(qs, c)
        return scores[:, :8] + segment_ids(sm, s_keep)[:, :8]

    def st_gather(qs, c):
        scores, sm = fused_score_segmax(qs, c)
        return gather_segments(scores, segment_ids(sm, s_keep))[:, :8, 0]

    def st_final(qs, c):
        vals, idx = pipeline(qs, c, s_keep, k)
        return vals + (idx[:, :1] // SEG)

    return {"matmul": st_matmul, "kernel": st_kernel, "segtopk": st_segtopk, "gather": st_gather,
            "final": st_final}


def main(argv=None, device=None) -> dict:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    print(common.card(dev), flush=True)
    n = int(os.environ.get("BENCH_N", 1_245_184))
    s_keep = int(os.environ.get("BENCH_S", 128))
    corpus = common.normal_bf16((n, D), 0, dev)
    qs = common.normal_bf16((Q, D), 1, dev)
    out = {}
    for name, fn in stages(s_keep).items():
        out[name + "_ms"] = common.timed(lambda: fn(qs, corpus), dev)
        print(name, out[name + "_ms"], flush=True)
    print(json.dumps(out), flush=True)
    del corpus, qs
    common.release(dev)
    return out


if __name__ == "__main__":
    main()
