"""The isolation sweep's second round on the card (port of
scripts/exp_isolate2.py, make): the dma, dot and both modes of
isolate_kernel at larger chunks (blk 4,096-16,384), and `natural`, the
[blk, D] x [D, Q] contraction, which on the card makes the corpus tile the
mma's A operand. On the card a kernel block's step is its 128-row tile
whatever blk is: blk sets the chunks the dma probe reports and the
resident block of dot, and is printed for both, where it changes nothing.

    python -m rust_local_rag_tpu_torch.experiments.isolate2
"""

from __future__ import annotations

from rust_local_rag_tpu_torch.experiments import common, isolate_kernel
from rust_local_rag_tpu_torch.experiments.common import D, N, Q, STEPS  # noqa: F401

SEG = 128
SWEEP = (("dma  blk=4096", "dma", 4096, False), ("dma  blk=8192", "dma", 8192, False),
         ("dma  blk=16384", "dma", 16384, False), ("dot  blk=4096", "dot", 4096, False),
         ("dot  blk=4096 nat", "dot", 4096, True), ("both blk=8192", "both", 8192, False),
         ("both blk=8192 nat", "both", 8192, True))


def make(mode: str, blk: int, natural: bool = False, slots: int = 2):
    """As isolate_kernel.make at chunks of blk rows (blk must divide N)."""
    return isolate_kernel.make(mode, slots, blk, natural)


def main(argv=None, device=None) -> None:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    print(common.card(dev), flush=True)
    corpus = common.normal_bf16((N, D), 0, dev)
    qs = common.normal_bf16((Q, D), 1, dev)
    for label, mode, blk, natural in SWEEP:
        fn = make(mode, blk, natural)
        ms = common.timed(lambda: fn(qs, corpus), dev)
        nch = N // blk
        print(f"{label}: {ms:7.3f} ms  ({ms * 1000 / nch:6.2f} us/chunk, "
              f"{N * D * 2 / ms * 1e-6:.0f} GB/s-equiv)", flush=True)
    del corpus, qs
    common.release(dev)


if __name__ == "__main__":
    main()
