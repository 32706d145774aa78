"""Scale the query batch on the card (port of scripts/exp_qscale.py). The
slab is read once a batch whatever Q is, so exact qps should rise with Q
until the [Q, N] score plane's writes dominate. Times
ops/score_segmax.segmented_topk (the port of pallas_segmented_topk: row
2's kernel, then the segmented selection) at Q 128, 256, 512 and 1,024,
bf16 queries on the bf16 slab: the kernel's tensor-core body, whose unit
each line names (common.tensor_core_unit).

First the script's exactness check at Q 512, and at Q 1,024 too (a width
the tensor-core body meets only here): segmented_topk on a 65,536-row
slab must equal torch.topk over the kernel's own scores in values and
indices (where two rows tie at the k-th value either may be picked; such
slots are counted), and hold to the plain plane (common.check_topk,
REL_TOL). A failed check raises.

    python -m rust_local_rag_tpu_torch.experiments.qscale
"""

from __future__ import annotations

import torch

from rust_local_rag_tpu_torch.experiments import common
from rust_local_rag_tpu_torch.experiments.common import D, K, N
from rust_local_rag_tpu_torch.ops.score_segmax import fused_score_segmax, segmented_topk

SWEEP_Q = (128, 256, 512, 1024)
EXACT_Q = (512, 1024)
EXACT_N = 16384 * 4
S_KEEP = 128
# the kernel's scores against the plain plane of the same bf16 products,
# over the plane's largest |score|: 768 exact products summed in f32 in two
# orders (standard-normal rows: scores up to ~130, differences ~2e-4; as
# split2.SCORE_TOL and chip_smoke.EXP_REL_TOL)
REL_TOL = 1e-4


def exactness(q: int, dev: torch.device, s_keep: int = S_KEEP) -> dict:
    """segmented_topk at Q q on EXACT_N rows against torch.topk of the
    kernel's scores (values, indices, boundary ties) and the plain plane."""
    qs = common.normal_bf16((q, D), 2, dev)
    c = common.normal_bf16((EXACT_N, D), 3, dev)
    v, i = segmented_topk(qs, c, K, num_segments=s_keep)
    wv, wi = torch.topk(fused_score_segmax(qs, c)[0], K, dim=1)
    okv, oki, ties = common.same_topk(v, i, wv, wi)
    out = {"values": okv, "indices": oki, "boundary_ties": ties, **common.check_topk(v, i, qs, c, REL_TOL)}
    del qs, c, v, i, wv, wi
    common.release(dev)
    return out


def check(q: int, dev: torch.device, label: str) -> dict:
    """exactness(q), printed as the script prints it; raises on a miss."""
    r = exactness(q, dev)
    print(f"{label} exact:", r["values"], r["indices"], f"boundary_ties={r['boundary_ties']};",
          f"plain plane: max_abs_err={r['max_abs_err']:.3e} max_rel_err={r['max_rel_err']:.3e} "
          f"outside_top_k={r['outside_top_k']} (rel tol {REL_TOL})", flush=True)
    if not (r["values"] and r["indices"]) or r["max_rel_err"] > REL_TOL or r["outside_top_k"]:
        raise AssertionError(f"{label}: segmented_topk is not the exact top-{K}: {r}")
    return r


def timed(q: int, corpus: torch.Tensor, dev: torch.device, s_keep: int = S_KEEP) -> float:
    """ms a call of segmented_topk at Q q over corpus."""
    qs = common.normal_bf16((q, D), 1, dev)
    ms = common.timed(lambda: segmented_topk(qs, corpus, K, num_segments=s_keep), dev)
    del qs
    common.release(dev)
    return ms


def main(argv=None, device=None) -> dict:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    print(common.card(dev), flush=True)
    out = {"exact": {q: check(q, dev, f"Q={q}") for q in EXACT_Q}, "ms": {}}
    corpus = common.normal_bf16((N, D), 0, dev)
    for q in SWEEP_Q:
        ms = out["ms"][q] = timed(q, corpus, dev)
        print(f"Q={q}: {ms:8.3f} ms  ({q / ms * 1000:7.0f} qps) [{common.unit_text(q)}]", flush=True)
    del corpus
    common.release(dev)
    return out


if __name__ == "__main__":
    main()
