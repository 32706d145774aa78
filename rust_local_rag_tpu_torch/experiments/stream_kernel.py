"""The streaming score + segment-max kernel on the card (port of
scripts/exp_stream_kernel.py, make_stream: csrc/stream_probe.cu
stream_segmax): scores as [Q, N] or, transposed, [N, Q], and the max of
each seg-row segment as [N/seg, Q]. main() checks both layouts on a small
slab against the GEMM (the script's atol 1e-3) and times the script's
three (seg, transposed) settings.

    python -m rust_local_rag_tpu_torch.experiments.stream_kernel
"""

from __future__ import annotations

import torch

from rust_local_rag_tpu_torch.experiments import common
from rust_local_rag_tpu_torch.experiments.common import D, N, Q, STEPS  # noqa: F401
from rust_local_rag_tpu_torch.ops.stream_probe import stream_segmax

BLK = 2048
SWEEP = ((128, False), (128, True), (64, True))


def make_stream(seg: int, transposed: bool):
    """(queries [Q, D] bf16, corpus [N, D] bf16) -> (scores [Q, N], or [N, Q]
    when transposed, f32; segmax [N/seg, Q] f32). The script's transposed
    form contracts the corpus block first ([BLK, D] x [D, Q]); here that
    makes the corpus tile the mma's A operand."""
    layout = "nq" if transposed else "qn"

    def run(queries, corpus):
        return stream_segmax(queries, corpus, seg, layout, natural=transposed)

    return run


def main(argv=None, device=None) -> None:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    print(common.card(dev), flush=True)
    n_small = BLK * 4
    for transposed in (False, True):
        qs = common.normal_bf16((Q, D), 2, dev)
        c = common.normal_bf16((n_small, D), 3, dev)
        s, m = make_stream(128, transposed)(qs, c)
        want = common.gemm_scores(qs, c)
        got = s.T if transposed else s
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
        wantm = want.view(Q, n_small // 128, 128).amax(dim=2).T
        torch.testing.assert_close(m, wantm, rtol=0, atol=1e-3)
        print(f"correct (transposed={transposed})", flush=True)

    corpus = common.normal_bf16((N, D), 0, dev)
    qs = common.normal_bf16((Q, D), 1, dev)
    for seg, transposed in SWEEP:
        run = make_stream(seg, transposed)
        ms = common.timed(lambda: run(qs, corpus), dev)
        print(f"stream seg={seg} transposed={transposed}: {ms:.3f} ms", flush=True)
        common.release(dev)
    del corpus, qs
    common.release(dev)


if __name__ == "__main__":
    main()
