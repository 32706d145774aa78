"""The streaming kernel's floors on the card (port of
scripts/exp_isolate_kernel.py, make): the same N/BLK-chunk walk in three
ablated modes.

  dma   stream the slab, no product (csrc/stream_probe.cu read_probe): the
        floor of reading 1.9 GB. The script wrote, for chunk i, the first
        Q values of its first row at segmax row i PT and left the other
        rows unwritten; the port returns just those rows, [N/BLK, Q] f32,
        and the int64 sums of each chunk's bf16 bit patterns, which make
        every byte's read show.
  dot   the product and segment max of corpus block 0 (BLK rows, resident
        in L2; the queries resident in shared memory) for every chunk
        (resident_dot_segmax, csrc/resident_dot.cu: wgmma): the floor of
        the product alone; [N/128, Q], block 0's maxima repeated, each
        chunk's from its own product.
  both  product + streaming, segment maxima only, no score write
        (stream_segmax with no scores): [N/128, Q].

`slots` (the TPU's DMA ring depth) is the kernel's cp.async stages (2 for
slots <= 2, else 4) for both, the depth of the TMA ring (4 slots stages,
as many as fit) for dot, and the loads a thread keeps in flight for dma,
walked as a runtime loop, as the script's fori_loop was.

    python -m rust_local_rag_tpu_torch.experiments.isolate_kernel
"""

from __future__ import annotations

from rust_local_rag_tpu_torch.experiments import common
from rust_local_rag_tpu_torch.experiments.common import D, N, Q, STEPS  # noqa: F401
from rust_local_rag_tpu_torch.ops.stream_probe import read_probe, resident_dot_segmax, stream_segmax

BLK = 2048
SEG = 128
PT = BLK // SEG
NCHUNKS = N // BLK
SWEEP = (("dma  slots=2", "dma", 2), ("dma  slots=4", "dma", 4), ("dot  resident", "dot", 2),
         ("both slots=2", "both", 2), ("both slots=4", "both", 4))


def make(mode: str, slots: int = 2, blk: int = BLK, natural: bool = False):
    """(queries [Q, D] bf16, corpus [N, D] bf16) -> the mode's output (see
    the module's docstring; dma gives (heads, sums))."""
    if mode == "dma":
        return lambda queries, corpus: read_probe(corpus, blk, queries.shape[0], slots, static=False)
    if mode == "dot":
        return lambda queries, corpus: resident_dot_segmax(queries, corpus, blk, natural, slots)
    if mode == "both":
        return lambda queries, corpus: stream_segmax(queries, corpus, SEG, "none", natural, slots)[1]
    raise ValueError(f"unknown mode {mode!r}")


def main(argv=None, device=None) -> None:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    print(common.card(dev), flush=True)
    corpus = common.normal_bf16((N, D), 0, dev)
    qs = common.normal_bf16((Q, D), 1, dev)
    for label, mode, slots in SWEEP:
        fn = make(mode, slots)
        ms = common.timed(lambda: fn(qs, corpus), dev)
        print(f"{label}: {ms:7.3f} ms  ({ms * 1000 / NCHUNKS:6.2f} us/chunk)", flush=True)
    del corpus, qs
    common.release(dev)


if __name__ == "__main__":
    main()
