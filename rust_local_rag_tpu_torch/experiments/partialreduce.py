"""The TPU's PartialReduce as a segment-max producer, on the card (port of
scripts/exp_partialreduce.py). The script asked three things of
jax.lax.approx_max_k(..., aggregate_to_topk=False): how many bins l it
returns for a recall target (and reduction_input_size_override), whether
bin b holds the indices that are b mod l, and what the GEMM plus the
unaggregated reduce costs.

The card has no PartialReduce. This module keeps its own copy of XLA's
rule for l (bins), and computes the interleaved bins' maxima with one
library call: the [Q, N] scores padded with -inf to l * 2^j columns,
viewed as [Q, 2^j, l], max over the middle axis (interleaved_max). On the
CPU approx_max_k gives the exact top l rather than bins, so only its l
can be held to this module's (the tests do). The
library GEMM plus that reduce is timed beside row 2's kernel.

  probe_l      l for recall 0.95-0.995, k 100 and 256, and two overrides
  probe_layout the bins of a [4, N] normal plane against numpy's maxima
               of x[:, b::l] (exact), and the two layouts' tests
  timing(r)    GEMM + interleaved_max at recall r

    python -m rust_local_rag_tpu_torch.experiments.partialreduce
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from rust_local_rag_tpu_torch.experiments import common
from rust_local_rag_tpu_torch.experiments.common import D, N, Q

K = 100
LANES = 128  # the TPU's lane width: l is a multiple of it


def reduction_shape(n: int, k: int, recall: float, override=None) -> tuple:
    """(l, 2^j) of XLA's approx_max_k(..., aggregate_to_topk=False) at a
    rank-2 input of width n: the bins a row keeps and the columns a bin
    reduces. With n_logical the override (else n): m, the smallest bin
    count the recall allows, is min(max(int((1 - k) / ln r), 128),
    n_logical); j = floor(log2(n_logical // m)), l = n where j is 0, else
    j = min(j, ceil(log2(n // 128))) and l = ceil(ceil(n / 128) / 2^j) * 128.
    n <= 128 and recall 1 keep all n, k 1 keeps 128. (Fitted to the shapes
    approx_max_k gives on the CPU over a grid of n, k, recall and override:
    tests/test_torch_xla_studies.py.)"""
    logical = override if override is not None else n
    if n <= LANES or recall >= 1.0:
        return n, 1
    if k == 1:
        return LANES, 1 << (-(-n // LANES) - 1).bit_length()
    m = min(max(int((1.0 - k) / math.log(recall)), LANES), logical)
    j = (logical // m).bit_length() - 1
    if j <= 0:
        return n, 1
    j = min(j, (n // LANES - 1).bit_length())
    return -(-(-(-n // LANES)) // (1 << j)) * LANES, 1 << j


def bins(n: int, k: int, recall: float, override=None) -> int:
    """l, the bins approx_max_k keeps (reduction_shape)."""
    return reduction_shape(n, k, recall, override)[0]


def interleaved_max(x: torch.Tensor, k: int, recall: float):
    """x [R, n] -> (values [R, l], indices [R, l] int64): bin b's max over
    the columns b, b + l, b + 2l, ... and the column that holds it."""
    r, n = x.shape
    l, groups = reduction_shape(n, k, recall)
    if l * groups > n:
        x = F.pad(x, (0, l * groups - n), value=float("-inf"))
    vals, arg = x.view(r, groups, l).max(dim=1)
    return vals, arg * l + torch.arange(l, device=x.device)


def probe_l(log=print) -> dict:
    out = {}
    for rt in (0.95, 0.98, 0.99, 0.995):
        for k in (100, 256):
            out[(rt, k)] = bins(N, k, rt)
            log(f"recall={rt} k={k}: l={out[(rt, k)]}")
    for ov in (5_000_000, 20_000_000):
        out[("override", ov)] = bins(N, 100, 0.95, ov)
        log(f"override={ov}: l={out[('override', ov)]}")
    return out


def probe_layout(dev: torch.device, rt: float = 0.99, log=print) -> dict:
    """The bins of a seeded [4, N] normal plane on dev against numpy."""
    x = np.random.default_rng(0).standard_normal((4, N)).astype(np.float32)
    v, i = interleaved_max(torch.from_numpy(x).to(dev), K, rt)
    l = v.shape[1]
    v_np, i_np = v.cpu().numpy(), i.cpu().numpy()
    interleaved = bool(np.array_equal(i_np % l, np.tile(np.arange(l), (4, 1))))
    w = -(-N // l)
    contig = bool(np.array_equal(i_np // w, np.tile(np.arange(l), (4, 1))))
    log(f"l={l} interleaved={interleaved} contiguous={contig}")
    live = min(l, N)  # bins past N (where l > N) hold padding only
    want = np.stack([x[:, b::l].max(axis=1) for b in range(live)], axis=1)
    exact = bool(np.array_equal(v_np[:, :live], want)
                 and np.array_equal(np.take_along_axis(x, i_np[:, :live], 1), want)
                 and np.isneginf(v_np[:, live:]).all())
    log(f"bin-max exact: {exact}")
    return {"l": l, "interleaved": interleaved, "contiguous": contig, "exact": exact}


def timing(corpus: torch.Tensor, qs: torch.Tensor, dev: torch.device, rt: float = 0.99, log=print) -> float:
    def pipe():
        st = common.gemm_scores(qs, corpus)
        v, i = interleaved_max(st, K, rt)
        return st, v, i

    ms = common.timed(pipe, dev)
    log(f"einsum+partialreduce(rt={rt}): {ms:.3f} ms")
    return ms


def main(argv=None, device=None) -> dict:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    log = lambda m: print(m, flush=True)  # noqa: E731
    log(common.card(dev))
    out = {"l": probe_l(log), "layout": probe_layout(dev, log=log)}
    if not (out["layout"]["interleaved"] and out["layout"]["exact"]):
        raise AssertionError(f"interleaved_max: {out['layout']}")
    common.release(dev)
    corpus = common.normal_bf16((N, D), 0, dev)
    qs = common.normal_bf16((Q, D), 1, dev)
    out["ms"] = {rt: timing(corpus, qs, dev, rt, log) for rt in (0.99, 0.95)}
    out["kernel_ms"] = common.kernel_ms(qs, corpus, dev)
    log(f"row 2 kernel (fused_score_segmax): {out['kernel_ms']:.3f} ms")
    del corpus, qs
    common.release(dev)
    return out


if __name__ == "__main__":
    main()
