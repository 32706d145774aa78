"""Where the split pipeline's time goes, on the card (port of
scripts/exp_split2.py): the segment-max kernel alone over resident scores
(a), the library GEMM + segment max (b), the fused score + segment-max
pass alone (c: stream_fused, the port's score_segmax_unmasked kernel on its
tensor-core body, as the script's stream_fused computes the function of
pallas_topk.py's fused_score_segmax) and with the selection (d).

    python -m rust_local_rag_tpu_torch.experiments.split2
"""

from __future__ import annotations

import torch

from rust_local_rag_tpu_torch.experiments import common
from rust_local_rag_tpu_torch.experiments.common import D, K, N, Q, STEPS  # noqa: F401
from rust_local_rag_tpu_torch.ops.score_segmax import fused_score_segmax
from rust_local_rag_tpu_torch.ops.segmax import segmax

SEG = 128
NT = N // SEG
BLK = 2048
PT = BLK // SEG
NCH = N // BLK
SCORE_TOL = 1e-4  # stream_fused's tensor-core sums against the GEMM's, relative to the largest score


def make_segmax(blkc: int, slots: int = 2):
    """scores [Q, N] f32 -> [Q, N/128] (csrc/segmax.cu)."""
    def run(scores):
        return segmax(scores, SEG, blkc, slots)

    return run


def stream_fused(queries, corpus):
    """(queries [Q, D] bf16, corpus [N, D] bf16) -> (scores [Q, N] f32,
    segmax [N/128, Q] f32) in one pass: the port's unmasked score +
    segment-max kernel, given the bf16 queries as they are, so on the card
    it runs its tensor-core body with one bf16 term (wgmma bf16 x bf16 ->
    f32); its [Q, N/128] maxima come back transposed, as the script's."""
    scores, sm = fused_score_segmax(queries, corpus)
    return scores, sm.T


def select(st, sm, s_keep: int = 128, k: int = K):
    """st [Q, N] f32, sm [Q, N/128] -> (values [Q, k], indices [Q, k] int32)."""
    return common.select(st, sm, SEG, s_keep, k)


def main(argv=None, device=None) -> None:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    print(common.card(dev), flush=True)
    corpus = common.normal_bf16((N, D), 0, dev)
    qs0 = common.normal_bf16((Q, D), 1, dev)
    scores0 = common.gemm_scores(qs0, corpus)

    # correctness of stream_fused + select, against torch.topk over the
    # same (stream_fused's) scores
    st, sm = stream_fused(qs0, corpus)
    err = float((st - scores0).abs().max() / scores0.abs().max())
    wv, wi = torch.topk(st, K, dim=1)
    okv, oki, ties = common.same_topk(*select(st, sm.T), wv, wi)
    print("stream_fused+select exact:", okv, oki, f"boundary_ties={ties}", flush=True)
    print(f"stream_fused scores vs einsum: max_rel_err={err:.3e} (tol {SCORE_TOL})", flush=True)
    if not (okv and oki) or not err <= SCORE_TOL:
        raise AssertionError("stream_fused + select: not the exact top-k of its scores, or scores off")
    del st, sm, wv, wi
    common.release(dev)

    segmax_fn = make_segmax(32768)
    ms = common.timed(lambda: segmax_fn(scores0), dev)
    print(f"a) segmax standalone: {ms:7.3f} ms", flush=True)
    del scores0
    common.release(dev)
    ms = common.timed(lambda: segmax_fn(common.gemm_scores(qs0, corpus)), dev)
    print(f"b) einsum+segmax: {ms:7.3f} ms", flush=True)
    ms = common.timed(lambda: stream_fused(qs0, corpus), dev)
    print(f"c) stream_fused alone: {ms:7.3f} ms", flush=True)

    def pipe_d():
        st, sm = stream_fused(qs0, corpus)
        return select(st, sm.T)

    ms = common.timed(pipe_d, dev)
    print(f"d) stream_fused+select: {ms:7.3f} ms ({Q / ms * 1000:.0f} qps)", flush=True)
    del corpus, qs0
    common.release(dev)


if __name__ == "__main__":
    main()
