"""Shapes, seeded data, timing and selection shared by the experiment
modules.

The scripts' shape is bench.py's exact top-k shard: N 1,245,184 slab rows
(1,250,000 cut to a multiple of 16,384), D 768, Q 128 queries, top-100,
bf16 slab and queries, f32 scores. They timed STEPS chained steps inside
one jitted scan, best of 3; here STEPS back-to-back calls run between two
CUDA events, best of 3. Data is standard-normal bf16 from a seeded
torch.Generator on the device (jax.random's bits cannot be reproduced
without JAX).
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from rust_local_rag_tpu_torch.device import resolve_device
from rust_local_rag_tpu_torch.ops.score_segmax import SEG, fused_score_segmax, fused_score_segmax_plain
from rust_local_rag_tpu_torch.ops.stream_probe import scores_f32

N, D, Q, K, STEPS = 1_245_184, 768, 128, 100, 8
# the unit of the score + segment-max kernel's tensor-core body, fixed when
# it is compiled (csrc/score_segmax.cu: W_QROWS, W_ROW, SMEM_MAX and the six
# stages at most of w_stages)
W_QROWS, W_ROW, W_STAGES_MAX, SMEM_MAX = 64, 128, 6, 232448


def parse_device(argv=None, doc: str = "") -> torch.device:
    """--device (default cuda; raises without a card)."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default="cuda")
    return resolve_device(ap.parse_args(argv).device)


def card(dev: torch.device) -> str:
    """The card as nvidia-smi names it, with its power limit."""
    if dev.type != "cuda":
        return "cpu (no card: nothing is timed)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[dev.index or 0]


def normal_bf16(shape, seed: int, dev: torch.device) -> torch.Tensor:
    """Standard-normal bf16 from torch.Generator(seed) on dev."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)


def gemm_scores(qs: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """The scripts' einsum("qd,nd->qn", preferred_element_type=f32): a
    library GEMM of bf16 operands with f32 output (on the card
    torch.mm(..., out_dtype=float32); on the CPU, which lacks that kernel,
    f32 products of the exactly widened operands in row blocks)."""
    if corpus.device.type == "cuda":
        return torch.mm(qs, corpus.T, out_dtype=torch.float32)
    return scores_f32(qs, corpus)


def select(st: torch.Tensor, sm: torch.Tensor, seg: int, s_keep: int, k: int):
    """The scripts' two-stage exact selection (exp_split_pipeline.py:83-89,
    exp_split2.py:119-127): the S = min(max(s_keep, k), N/seg) segments
    with the largest maxima, then the top k of their seg S scores.
    st [Q, N] f32, sm [Q, N/seg] -> (values [Q, k] f32, indices [Q, k] int32)."""
    q, n = st.shape
    nt = n // seg
    s = min(max(s_keep, k), nt)
    _, seg_idx = torch.topk(sm, s, dim=1)
    cand = torch.gather(st.view(q, nt, seg), 1, seg_idx[:, :, None].expand(q, s, seg))
    vals, flat = torch.topk(cand.reshape(q, s * seg), k, dim=1)
    seg_of = torch.gather(seg_idx, 1, flat // seg)
    return vals, (seg_of * seg + flat % seg).to(torch.int32)


def same_topk(gv, gi, wv, wi) -> tuple:
    """(values_exact, indices_exact, boundary_ties) of a top-k against the
    reference's. Rows are put in one order first, value descending and
    index ascending, so equal values in another order count as the same
    answer. Indices may differ only where both picks hold the row's k-th
    value (an exact top-k may take any of those); such slots are counted."""
    def canon(v, i):
        i = i.long()
        o = torch.argsort(i, dim=1, stable=True)
        v, i = torch.gather(v, 1, o), torch.gather(i, 1, o)
        o = torch.argsort(v, dim=1, descending=True, stable=True)
        return torch.gather(v, 1, o), torch.gather(i, 1, o)

    gv, gi = canon(gv, gi)
    wv, wi = canon(wv, wi)
    values = torch.equal(gv, wv)
    differ = gi != wi
    boundary = differ & (gv == gv[:, -1:])
    return values, values and bool((differ == boundary).all()), int(boundary.sum())


def timed(fn, dev: torch.device, steps: int = STEPS) -> float:
    """Milliseconds a call: `steps` back-to-back calls of fn() between two
    CUDA events after one warm-up call, best of 3. On the CPU the calls run
    and nan comes back: no CPU time is reported as the card's."""
    fn()
    if dev.type != "cuda":
        for _ in range(steps):
            fn()
        return float("nan")
    torch.cuda.synchronize(dev)
    best = float("inf")
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(steps):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / steps)
    return best


def release(dev: torch.device) -> None:
    """Return freed blocks to the card between experiments."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()



def tensor_core_unit(q: int, terms: int = 1) -> dict:
    """What the tensor-core body of the score + segment-max kernel takes at
    Q queries of `terms` bf16 terms (1 for bf16 queries, 3 for f32 ones),
    as csrc/score_segmax.cu's w_rows / w_stage / w_stages / w_smem compute
    it: a unit of 64 queries x 256 rows at Q <= 64, else 128 x 128; the
    ring's stages and a block's dynamic shared memory; the query tiles each
    unit of rows is scored for. Q alone sets it: the JAX kernel's block_n,
    a VMEM tile of the slab, has no counterpart on the card."""
    qw = 1 if q <= W_QROWS else 2
    rows = 2 * SEG // qw
    stage = (rows + terms * W_QROWS * qw) * W_ROW
    stages = min((SMEM_MAX - 1024 - W_STAGES_MAX * 16) // stage, W_STAGES_MAX)
    return {"unit_queries": W_QROWS * qw, "unit_rows": rows, "stages": stages,
            "smem_bytes": stages * (stage + 16) + 1024, "query_tiles": -(-q // (W_QROWS * qw))}


def unit_text(q: int) -> str:
    u = tensor_core_unit(q)
    return (f"unit {u['unit_queries']} queries x {u['unit_rows']} rows, {u['query_tiles']} query tile(s), "
            f"{u['stages']} stages, {u['smem_bytes']:,} B shared")


def kernel_ms(qs: torch.Tensor, corpus: torch.Tensor, dev: torch.device) -> float:
    """Row 2's kernel (ops/score_segmax.fused_score_segmax, the port of
    pallas_topk.py's fused_score_segmax: the scores and their segment
    maxima in one pass) on the same inputs, timed as the library
    formulations beside it are."""
    return timed(lambda: fused_score_segmax(qs, corpus), dev)


def check_topk(gv, gi, qs, corpus, rel_tol: float) -> dict:
    """An exact top-k (values [Q, k], indices [Q, k]) held to the plain
    plane of the same inputs (fused_score_segmax_plain: f32 products of
    the widened bf16 operands): each picked row's plain score within tol of
    its value, and none below the plain k-th value by more than tol (two
    rows whose scores tie within rounding may trade places), tol being
    rel_tol times the plane's largest |score|.
    -> {"max_abs_err", "max_rel_err", "outside_top_k"}."""
    plain = fused_score_segmax_plain(qs, corpus)[0]
    scale = float(plain.abs().max())
    mine = torch.gather(plain, 1, gi.long())
    kth = torch.topk(plain, gi.shape[1], dim=1).values[:, -1:]
    del plain
    err = float((mine - gv).abs().max())
    return {"max_abs_err": err, "max_rel_err": err / scale,
            "outside_top_k": int((mine < kth - rel_tol * scale).sum())}
