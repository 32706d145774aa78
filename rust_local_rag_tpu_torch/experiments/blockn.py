"""The segmented exact top-k at the points of scripts/exp_blockn.py, on
the card: Q 128, block_n 2,048, 4,096, 8,192 and 1,024 at S 128 kept
segments, and 2,048 at S 100.

block_n has no counterpart here (qscale2's docstring says why): at Q 128
the kernel's tensor-core body takes one unit, printed once, at every
point. The four S 128 points therefore run the same program, and their
spread is the timing's own; the S 100 point keeps 100 segments
(segmented_topk's S = min(max(S, k), N/128), so k 100 still bounds it).

    python -m rust_local_rag_tpu_torch.experiments.blockn
"""

from __future__ import annotations

from rust_local_rag_tpu_torch.experiments import common, qscale
from rust_local_rag_tpu_torch.experiments.common import D, N, Q

POINTS = ((2048, 128), (4096, 128), (8192, 128), (1024, 128), (2048, 100))


def main(argv=None, device=None) -> dict:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    print(common.card(dev), flush=True)
    print(f"block_n has no counterpart: Q={Q} takes {common.unit_text(Q)} at every point", flush=True)
    corpus = common.normal_bf16((N, D), 0, dev)
    out = {}
    for blk, s in POINTS:
        ms = out[(blk, s)] = qscale.timed(Q, corpus, dev, s_keep=s)
        print(f"grid blk={blk} S={s}: {ms:7.3f} ms ({Q / ms * 1000:.0f} qps)", flush=True)
    del corpus
    common.release(dev)
    return out


if __name__ == "__main__":
    main()
