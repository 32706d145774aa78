"""The split exact top-k pipeline on the card (port of
scripts/exp_split_pipeline.py): a library GEMM for the [Q, N] f32 scores,
the segment-max kernel over them (make_segmax_qn: csrc/segmax.cu), then
the two-stage selection. main() checks the answer against torch.topk over
the same scores and times the script's five (seg, blkc, S) settings.

    python -m rust_local_rag_tpu_torch.experiments.split_pipeline
"""

from __future__ import annotations

import torch

from rust_local_rag_tpu_torch.experiments import common
from rust_local_rag_tpu_torch.experiments.common import D, K, N, Q, STEPS
from rust_local_rag_tpu_torch.ops.segmax import segmax

SWEEP = ((128, 32768, 128), (128, 16384, 128), (128, 65536, 128), (128, 32768, 256), (128, 32768, 100))


def make_segmax_qn(seg: int, blkc: int, slots: int = 2):
    """scores [Q, N] f32 -> [Q, N/seg], the max of each seg-column segment.
    blkc and slots are the TPU kernel's column block and DMA ring depth,
    carried to the card as csrc/segmax.cu says."""
    def run(scores):
        return segmax(scores, seg, blkc, slots)

    return run


def pipeline_qn(seg: int, blkc: int, s_keep: int, k: int = K):
    """(qs [Q, D] bf16, corpus [N, D] bf16) -> exact top-k (values [Q, k]
    f32, indices [Q, k] int32)."""
    segmax_fn = make_segmax_qn(seg, blkc)

    def run(qs, corpus):
        st = common.gemm_scores(qs, corpus)
        return common.select(st, segmax_fn(st), seg, s_keep, k)

    return run


def main(argv=None, device=None) -> None:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    print(common.card(dev), flush=True)
    # correctness against torch.topk over the same f32 scores
    qs = common.normal_bf16((Q, D), 2, dev)
    c = common.normal_bf16((N, D), 3, dev)
    wv, wi = torch.topk(common.gemm_scores(qs, c), K, dim=1)
    for seg, blkc in ((128, 32768),):
        gv, gi = pipeline_qn(seg, blkc, 128)(qs, c)
        okv, oki, ties = common.same_topk(gv, gi, wv, wi)
        print(f"seg={seg}: values_exact={okv} indices_exact={oki} boundary_ties={ties}", flush=True)
        if not (okv and oki):
            raise AssertionError(f"split pipeline seg={seg}: not the exact top-{K}")
    del qs, c, wv, wi
    common.release(dev)

    corpus = common.normal_bf16((N, D), 0, dev)
    qs = common.normal_bf16((Q, D), 1, dev)
    for seg, blkc, s_keep in SWEEP:
        fn = pipeline_qn(seg, blkc, s_keep)
        ms = common.timed(lambda: fn(qs, corpus), dev)
        print(f"split qn seg={seg} blkc={blkc} S={s_keep}: {ms:7.3f} ms "
              f"({STEPS * Q / (ms / 1000 * STEPS):.0f} qps)", flush=True)
    del corpus, qs
    common.release(dev)


if __name__ == "__main__":
    main()
