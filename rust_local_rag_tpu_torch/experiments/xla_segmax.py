"""The monolithic GEMM with the segment max in several layouts, on the
card (port of scripts/exp_xla_segmax.py, which looked for the XLA layout
whose segment max did not re-read the scores slowly). Its counterpart
here is a library formulation, not a kernel: torch's GEMM to f32 on the
queries and the (reshaped) corpus, then an amax:

  scores only  [Q, N] alone
  a            [Q, N], reshaped to [Q, NS, 128], amax over the last axis
  b            the corpus as [NS, 128, D] against the queries: [NS, 128, Q],
               amax over the middle axis; b seg-only returns the maxima alone
  nq           [N, Q], reshaped to [NS, 128, Q], amax over the middle axis

b and nq are one GEMM in torch ([N, D] x [D, Q]: the reshaped corpus is a
view), where XLA gave them other layouts; both are kept, as in the script.
Row 2's kernel, which computes a's function in one pass, is timed beside
them. main() holds a's maxima to b's (atol 1e-3, as the script) and
raises on a miss.

    python -m rust_local_rag_tpu_torch.experiments.xla_segmax
"""

from __future__ import annotations

from rust_local_rag_tpu_torch.experiments import common
from rust_local_rag_tpu_torch.experiments.common import D, N, Q

SEG = 128
CHECK_ATOL = 1e-3


def v_scores_only(qs, corpus):
    return common.gemm_scores(qs, corpus), None


def v_a(qs, corpus):
    st = common.gemm_scores(qs, corpus)
    return st, st.view(qs.shape[0], -1, SEG).amax(dim=2)


def v_b(qs, corpus):
    st = common.gemm_scores(corpus, qs).view(-1, SEG, qs.shape[0])
    return st, st.amax(dim=1)  # [NS, Q]


def v_b_segonly(qs, corpus):
    return None, v_b(qs, corpus)[1]


def v_nq(qs, corpus):
    st = common.gemm_scores(corpus, qs)
    return st, st.view(-1, SEG, qs.shape[0]).amax(dim=1)


VARIANTS = (("scores only [Q,N]", v_scores_only), ("a: [Q,N]+reshape max", v_a), ("b: [NS,SEG,Q]+max(1)", v_b),
            ("b seg-only", v_b_segonly), ("nq: [N,Q]+max(1)", v_nq))


def main(argv=None, device=None) -> dict:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    print(common.card(dev), flush=True)
    qs = common.normal_bf16((Q, D), 2, dev)
    c = common.normal_bf16((N, D), 3, dev)
    _, sma = v_a(qs, c)
    _, smb = v_b(qs, c)
    err = float((sma - smb.T).abs().max())
    if not err <= CHECK_ATOL:
        raise AssertionError(f"layouts a and b give maxima {err} apart (atol {CHECK_ATOL})")
    print("correct", flush=True)
    del qs, c, sma, smb
    common.release(dev)

    corpus = common.normal_bf16((N, D), 0, dev)
    q0 = common.normal_bf16((Q, D), 1, dev)
    out = {}
    for label, fn in VARIANTS:
        ms = out[label] = common.timed(lambda: fn(q0, corpus), dev)
        print(f"{label}: {ms:7.3f} ms", flush=True)
        common.release(dev)
    out["kernel"] = common.kernel_ms(q0, corpus, dev)
    print(f"row 2 kernel (fused_score_segmax): {out['kernel']:7.3f} ms", flush=True)
    del corpus, q0
    common.release(dev)
    return out


if __name__ == "__main__":
    main()
