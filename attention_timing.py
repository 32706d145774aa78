#!/usr/bin/env python3
"""Checks and times the attention kernel of the rust_local_rag_tpu_torch
package in the working directory, at the shapes the main path gives it.

For every (B, H, L, causal) of chip_smoke.ATTN_SHAPES and the encoder's
other length buckets (SHAPES): the kernel (the body
the package picks), each body the package can name beside it (L <= 192:
mma.sync and wgmma), and scaled_dot_product_attention on the same inputs
with the kernel's finite bias as its mask, each as ms a call (CUDA events
around back-to-back calls, the host's enqueue kept out of the window,
median of repeats); with the bound (bytes or tensor-core operations,
whichever is larger), the share of it, and the exp floor (B*H*L^2 exps at
16 a clock on each of 132 SMs at 1.83 GHz). With --check, first holds the
kernel to attention_plain at those shapes and at edge shapes (atol = rtol
= 2e-2; the same bits through a transposed v and a k with rows of 66
values). Prints the card's name and power limit, the compiler's -Xptxas -v
lines for the library, then one JSON line a row.

Run from the root of a checkout; to compare two commits on one card, run
it from each checkout in turns (parent, change, change, parent):

    python3 attention_timing.py --tag change
    (cd ../parent && python3 ../change/attention_timing.py --tag parent)
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

# chip_smoke.ATTN_SHAPES, then the encoder's other buckets (queries at L 128,
# ingest batches at L 64 and 128): (B, H, L, causal)
SHAPES = [(16, 6, 192, True), (32, 6, 192, True), (256, 6, 192, True), (512, 6, 192, True),
          (1, 8, 64, False), (16, 8, 64, False), (128, 8, 256, False), (128, 8, 512, False),
          (16, 8, 128, False), (128, 8, 64, False), (128, 8, 128, False)]
EDGE = [(b, 2, l, causal) for l in (1, 17, 100, 193, 257, 500, 512) for b in (1, 3) for causal in (False, True)]
TOL = 2e-2
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_EXPS_PER_S = 132 * 16 * 1.83e9  # the SFU's exp rate at the clock of the tensor peak


def cuda_ms(fn, reps: int = 7, calls: int = 20) -> float:
    """Events around `calls` back-to-back calls, median of reps; the card
    spins ~2 ms before the first event, so the host's enqueue of the first
    call is not in the window."""
    for _ in range(3):
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


def bounds(b: int, h: int, l: int) -> dict:
    """ms the card needs at least: bytes (q, k, v read and out written once
    in bf16, the int32 mask) at the memory rate, 4 B H L^2 64 operations at
    the bf16 tensor rate, B H L^2 exps at the SFU rate."""
    t_bytes = (4 * b * h * l * 64 * 2 + b * l * 4) / H100_BYTES_PER_S * 1e3
    t_ops = 4 * b * h * l * l * 64 / H100_BF16_FLOPS * 1e3
    t_exp = b * h * l * l / H100_EXPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops, "exp_floor_ms": t_exp}


def case(seed: int, b: int, h: int, l: int, dev):
    """q, k, v ~ N(0, 1) bf16; key lengths at random, row 0 with one valid
    key and the last row with none."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, h, l, 64, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    lens = torch.randint(1, l + 1, (b,), generator=gen, device=dev)
    lens[0] = 1
    lens[-1] = 0
    mask = (torch.arange(l, device=dev)[None, :] < lens[:, None]).to(torch.int32)
    return q, k, v, mask


def sdpa_bias(mask, causal: bool):
    l = mask.shape[1]
    bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
    if causal:
        pos = torch.arange(l, device=mask.device)
        bias = bias + torch.where(pos[None, :] > pos[:, None], -1e9, 0.0)
    return bias.to(torch.bfloat16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="", help="a name for this checkout in the output")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true", help="hold the kernel to attention_plain first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_timing: torch.cuda.is_available() is False; this needs a card")
    sys.path.insert(0, os.getcwd())  # the checkout's package, not this script's
    from rust_local_rag_tpu_torch.kernels import build
    from rust_local_rag_tpu_torch.ops import attention as att

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for line in build.build_all(["attention"])["attention"].log.splitlines():
        if line.strip():
            print(f"ptxas| {line}", flush=True)
    dev = torch.device("cuda", 0)
    named = hasattr(att, "launch_body")  # a package with two bodies to name

    def bodies(l: int) -> dict:  # {name: number} of the bodies that take length l
        return {name: n for n, name in att.bodies_for(l).items()} if named else {}

    if args.check:
        worst, failed = 0.0, 0
        for i, (b, h, l, causal) in enumerate(SHAPES + EDGE):
            q, k, v, mask = case(args.seed + i, b, h, l, dev)
            ref = att.attention_plain(q, k, v, mask, causal).float()
            names = {"auto": 0, **bodies(l)}
            errs = {}
            for name, n in names.items():
                def call(k_, v_):
                    if n == 0:
                        return att.fused_attention(q, k_, v_, mask, causal)
                    return att.launch_body(q, k_, v_, mask, causal, n)
                out = call(k, v)
                strided = call(k, v.transpose(1, 2).contiguous().transpose(1, 2))
                padded = torch.zeros(*k.shape[:3], 66, dtype=k.dtype, device=dev)
                padded[..., :64] = k
                unaligned = call(padded[..., :64], v)
                torch.cuda.synchronize()
                same = bool(torch.equal(out, strided) and torch.equal(out, unaligned))
                err = float((out.float() - ref).abs().max())
                ok = same and bool(torch.isfinite(out.float()).all()) and bool(
                    torch.allclose(out.float(), ref, atol=TOL, rtol=TOL))
                errs[name] = err
                worst = max(worst, err)
                if not ok:
                    failed += 1
                    print(json.dumps({"tag": args.tag, "check": "FAILED", "B": b, "H": h, "L": l, "causal": causal,
                                      "body": name, "max_abs_err": err, "same_bits": same}), flush=True)
            print(json.dumps({"tag": args.tag, "check": "fused_attention", "B": b, "H": h, "L": l,
                              "causal": causal, "max_abs_err": errs, "tol": TOL}), flush=True)
        print(json.dumps({"tag": args.tag, "check_worst": worst, "failed": failed}), flush=True)
        if failed:
            return 1

    for i, (b, h, l, causal) in enumerate(SHAPES):
        q, k, v, mask = case(args.seed + i, b, h, l, dev)
        bias = sdpa_bias(mask, causal)
        row = {"tag": args.tag, "B": b, "H": h, "L": l, "causal": causal,
               "body": att.body_for(l) if named else "mma.sync",
               "ms": cuda_ms(lambda: att.fused_attention(q, k, v, mask, causal))}
        for name, n in bodies(l).items():
            row[f"{name}_ms"] = cuda_ms(lambda: att.launch_body(q, k, v, mask, causal, n))
        row["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias))
        row.update(bounds(b, h, l))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["card"] = card
        print(json.dumps(row), flush=True)
        del q, k, v, mask, bias
    return 0


if __name__ == "__main__":
    sys.exit(main())
