"""Scores and segment maxima block by block over the corpus, on the card
(port of scripts/exp_xla_blocked.py, which scanned corpus blocks in XLA
to keep the segment max fused with each block's product). Its
counterpart here is a library formulation, not a kernel: a Python loop
over blocks of bn rows, each one library GEMM to f32 and an amax over its
segments, with the blocks' scores kept ([nb, Q, bn], stacked after the
loop as the scan stacks them) or not. Row 2's kernel, which computes the
same in one pass, is timed beside them.

main() holds block 3's scores to the GEMM of that block alone (atol
1e-3, as the script) and raises on a miss, then times bn 8,192-65,536
with and without the scores.

    python -m rust_local_rag_tpu_torch.experiments.xla_blocked
"""

from __future__ import annotations

import torch

from rust_local_rag_tpu_torch.experiments import common
from rust_local_rag_tpu_torch.experiments.common import D, N, Q

SEG = 128
BLOCKS = (8192, 16384, 32768, 65536)
CHECK_BN, CHECK_BLOCK, CHECK_ATOL = 8192, 3, 1e-3


def make(bn: int, with_scores: bool):
    """-> run(queries, corpus) -> (scores [nb, Q, bn] f32 or None,
    segmax [nb, Q, bn/128] f32)."""
    if N % bn:
        raise ValueError(f"N ({N}) must divide by bn ({bn})")

    def run(queries, corpus):
        q = queries.shape[0]
        scores, segmax = [], []
        for blk in corpus.view(N // bn, bn, -1):
            st = common.gemm_scores(queries, blk)
            segmax.append(st.view(q, bn // SEG, SEG).amax(dim=2))
            if with_scores:
                scores.append(st)
        return (torch.stack(scores) if with_scores else None), torch.stack(segmax)

    return run


def main(argv=None, device=None) -> dict:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    print(common.card(dev), flush=True)
    qs = common.normal_bf16((Q, D), 2, dev)
    c = common.normal_bf16((N, D), 3, dev)
    s, _ = make(CHECK_BN, True)(qs, c)
    i = CHECK_BLOCK
    want = common.gemm_scores(qs, c[i * CHECK_BN:(i + 1) * CHECK_BN])
    err = float((s[i] - want).abs().max())
    if not err <= CHECK_ATOL:
        raise AssertionError(f"blocked scores of block {i} off by {err} (atol {CHECK_ATOL})")
    print("correct", flush=True)
    del qs, c, s, want
    common.release(dev)

    corpus = common.normal_bf16((N, D), 0, dev)
    q0 = common.normal_bf16((Q, D), 1, dev)
    out = {}
    for bn in BLOCKS:
        for ws in (True, False):
            run = make(bn, ws)
            ms = out[(bn, ws)] = common.timed(lambda: run(q0, corpus), dev)
            print(f"xla blocked bn={bn} scores={ws}: {ms:7.3f} ms", flush=True)
            common.release(dev)
    out["kernel"] = common.kernel_ms(q0, corpus, dev)
    print(f"row 2 kernel (fused_score_segmax): {out['kernel']:7.3f} ms", flush=True)
    del corpus, q0
    common.release(dev)
    return out


if __name__ == "__main__":
    main()
