#!/usr/bin/env python3
"""Times the score + segment-max kernels of the rust_local_rag_tpu_torch
package in the working directory at the shapes of their Q > 16 bodies. On
a bf16 slab (the tensor-core body): the serving path at a batch of 64
(Q 64, N 65,536, masked) and bench.py's shard (N 1,245,184, unmasked) at
Q 128 and 512, with f32 queries and with bf16 queries where the package
takes them. On an f32 slab with f32 queries (the f32 FMA body), both
entries: Q 64, 128 and 512 at N 65,536 and Q 128 at N 1,245,184. Prints
the card's name and power limit, then one JSON line a row (ms a call: CUDA
events around back-to-back calls, the host's enqueue kept out of the
window, median of repeats).

Run from the root of a checkout; to compare two commits on one card, run
it from each checkout in turns (parent, change, change, parent):

    python3 score_segmax_timing.py --tag change
    (cd ../parent && python3 ../change/score_segmax_timing.py --tag parent)
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

# (slab dtype, Q, N, entries)
SHAPES = (
    (torch.bfloat16, 64, 65536, ("masked",)),
    (torch.bfloat16, 128, 1245184, ("unmasked",)),
    (torch.bfloat16, 512, 1245184, ("unmasked",)),
    (torch.float32, 64, 65536, ("masked", "unmasked")),
    (torch.float32, 128, 65536, ("masked", "unmasked")),
    (torch.float32, 512, 65536, ("masked", "unmasked")),
    (torch.float32, 128, 1245184, ("masked", "unmasked")),
)
D = 768


def cuda_ms(fn, reps: int = 5, calls: int = 5) -> float:
    """Events around `calls` back-to-back calls, median of reps; the card
    spins ~2 ms before the first event, so the host's enqueue of the first
    call is not in the window."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="", help="a name for this checkout in the output")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("score_segmax_timing: torch.cuda.is_available() is False; this needs a card")
    sys.path.insert(0, os.getcwd())  # the checkout's package, not this script's
    from rust_local_rag_tpu_torch.ops.score_segmax import fused_score_segmax, score_segmax

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    for slab, q, n, entries in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        corpus = torch.randn(n, D, generator=gen, device=dev)
        corpus = (corpus / corpus.norm(dim=1, keepdim=True)).to(slab)
        queries = torch.randn(q, D, generator=gen, device=dev)
        queries = queries / queries.norm(dim=1, keepdim=True)
        mask = torch.rand(n, generator=gen, device=dev) > 0.1
        for dtype in (torch.float32, torch.bfloat16) if slab == torch.bfloat16 else (torch.float32,):
            qs = queries.to(dtype)
            for entry in entries:
                if entry == "masked":
                    fn = lambda: score_segmax(qs, corpus, mask)  # noqa: E731
                else:
                    fn = lambda: fused_score_segmax(qs, corpus)  # noqa: E731
                row = {"tag": args.tag, "entry": "score_segmax_masked" if entry == "masked" else "fused_score_segmax",
                       "Q": q, "N": n, "D": D, "slab": str(slab), "queries": str(dtype)}
                try:
                    row["ms"] = cuda_ms(fn)
                except TypeError as exc:  # a package that takes f32 queries only
                    row["ms"] = None
                    row["refused"] = str(exc)
                print(json.dumps(row), flush=True)
        del corpus, queries, mask
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
