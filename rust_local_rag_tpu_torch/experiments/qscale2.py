"""The query-batch sweep at the points of scripts/exp_qscale2.py, on the
card. The script shrank block_n as Q grew, to fit the TPU kernel's 16 MB
of scoped VMEM: Q 256 at 2,048, Q 512 at 1,024, Q 1,024 at 512 and 1,024.

block_n has no counterpart here. The port's kernel runs a persistent grid
whose tensor-core unit is fixed when it is compiled (csrc/score_segmax.cu
w_rows / w_stages / w_smem): 128 queries x 128 rows at every Q past 64,
six ring stages of 32 KB, 197,728 B of shared memory a block. A larger Q
only adds query tiles to each unit of rows, so the block_n axis collapses
and each point prints the unit the kernel takes instead. On the card the
question becomes: does the tensor-core body hold its qps from Q 512 to
Q 1,024? The last line gives the ratio.

The exactness check is qscale's at Q 512 (the script's "blk=1024" point).

    python -m rust_local_rag_tpu_torch.experiments.qscale2
"""

from __future__ import annotations

from rust_local_rag_tpu_torch.experiments import common, qscale
from rust_local_rag_tpu_torch.experiments.common import D, N

POINTS = ((256, 2048), (512, 1024), (1024, 512), (1024, 1024))


def main(argv=None, device=None) -> dict:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    print(common.card(dev), flush=True)
    out = {"exact": qscale.check(512, dev, "Q=512 blk=1024"), "ms": {}}
    corpus = common.normal_bf16((N, D), 0, dev)
    for q, blk in POINTS:
        ms = out["ms"][(q, blk)] = qscale.timed(q, corpus, dev)
        print(f"Q={q} blk={blk}: {ms:8.3f} ms  ({q / ms * 1000:7.0f} qps) [block_n has no counterpart: "
              f"{common.unit_text(q)}]", flush=True)
    del corpus
    common.release(dev)
    def best_qps(q):
        return max(q / ms * 1000 for (p, _), ms in out["ms"].items() if p == q)

    out["qps_1024_over_512"] = best_qps(1024) / best_qps(512)
    print(f"Q 512 -> 1024: qps ratio {out['qps_1024_over_512']:.3f}", flush=True)
    return out


if __name__ == "__main__":
    main()
