"""The slab read probe on the card (port of scripts/exp_dma_probe.py,
make): stream the [N, D] bf16 slab in chunks of blk rows and return a tag
plus the first 128 values of the first row of the chunk that last sat in
ring slot 0 of the script's `slots`-buffer ring (chunk
((N/blk - 1) // slots) slots). The read is csrc/stream_probe.cu
read_probe, which also sums every chunk's bit patterns, so the whole slab
is read. `slots` is the loads a thread keeps in flight (at most 16), and
`static` issues them together from an unrolled loop, where a runtime loop
issues one at a time. The script printed FAIL for a setting its compiler
refused; here a failure raises.

    python -m rust_local_rag_tpu_torch.experiments.dma_probe
"""

from __future__ import annotations

import torch

from rust_local_rag_tpu_torch.experiments import common
from rust_local_rag_tpu_torch.experiments.common import D, N, STEPS  # noqa: F401
from rust_local_rag_tpu_torch.ops.stream_probe import read_probe

GB = N * D * 2 / 1e9
SWEEP = ((8192, 2, True), (8192, 4, True), (2048, 8, True), (2048, 16, True),
         (32768, 2, True), (8192, 2, False), (2048, 16, False))


def make(blk: int, slots: int, static: bool):
    """(tag [1, 128] f32, corpus [N, D] bf16) -> [1, 128] f32."""
    def run(tag, corpus):
        heads, _ = read_probe(corpus, blk, 128, slots, static)
        last0 = (heads.shape[0] - 1) // slots * slots
        return tag + heads[last0:last0 + 1]

    return run


def main(argv=None, device=None) -> None:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    print(common.card(dev), flush=True)
    corpus = common.normal_bf16((N, D), 0, dev)
    tag = torch.arange(128, dtype=torch.float32, device=dev).reshape(1, 128)
    for blk, slots, static in SWEEP:
        fn = make(blk, slots, static)
        ms = common.timed(lambda: fn(tag, corpus), dev)
        print(f"blk={blk} slots={slots} static={static}: {ms:7.3f} ms  {GB / ms * 1000:5.0f} GB/s", flush=True)
    del corpus
    common.release(dev)


if __name__ == "__main__":
    main()
