"""The segment max as a windowed reduction after the monolithic GEMM, on
the card (port of scripts/exp_rw_segmax.py, which asked whether XLA's
reduce_window emitter beats the reshape-max form). Its counterpart here
is a library formulation, not a kernel: the library GEMM to f32 scores,
then F.max_pool1d with window and stride 128 (pipe_rw), and the same with
the two-stage exact selection (pipe_rw_select). Row 2's kernel, which
computes pipe_rw's function in one pass, is timed beside them.

main() holds the windowed maxima to the reshape max (equal) and the
selection to torch.topk over the same scores (values and indices; ties at
the k-th value counted), and raises on a miss.

    python -m rust_local_rag_tpu_torch.experiments.rw_segmax
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rust_local_rag_tpu_torch.experiments import common
from rust_local_rag_tpu_torch.experiments.common import D, K, N, Q

SEG = 128
S_KEEP = 128


def pipe_rw(qs, corpus):
    """-> (scores [Q, N] f32, segmax [Q, N/128] f32)."""
    st = common.gemm_scores(qs, corpus)
    return st, F.max_pool1d(st[:, None, :], SEG, SEG)[:, 0, :]


def pipe_rw_select(qs, corpus, s_keep: int = S_KEEP, k: int = K):
    """-> (values [Q, k] f32, indices [Q, k] int32)."""
    st, sm = pipe_rw(qs, corpus)
    return common.select(st, sm, SEG, s_keep, k)


def main(argv=None, device=None) -> dict:
    dev = device or common.parse_device(argv, __doc__.split("\n")[0])
    print(common.card(dev), flush=True)
    qs = common.normal_bf16((Q, D), 2, dev)
    c = common.normal_bf16((N, D), 3, dev)
    st, sm = pipe_rw(qs, c)
    if not torch.equal(sm, st.view(Q, N // SEG, SEG).amax(dim=2)):
        raise AssertionError("pipe_rw: the windowed maxima differ from the reshape max")
    wv, wi = torch.topk(st, K, dim=1)
    okv, oki, ties = common.same_topk(*pipe_rw_select(qs, c, S_KEEP, K), wv, wi)
    print("exact:", okv, oki, f"boundary_ties={ties}", flush=True)
    if not (okv and oki):
        raise AssertionError("pipe_rw_select is not the exact top-k of its scores")
    del st, sm, wv, wi, qs, c
    common.release(dev)

    corpus = common.normal_bf16((N, D), 0, dev)
    q0 = common.normal_bf16((Q, D), 1, dev)
    out = {"rw_ms": common.timed(lambda: pipe_rw(q0, corpus), dev)}
    print(f"einsum+reduce_window segmax: {out['rw_ms']:7.3f} ms", flush=True)
    ms = out["rw_select_ms"] = common.timed(lambda: pipe_rw_select(q0, corpus, S_KEEP, K), dev)
    print(f"einsum+rw+select: {ms:7.3f} ms ({Q / ms * 1000:.0f} qps)", flush=True)
    out["kernel_ms"] = common.kernel_ms(q0, corpus, dev)
    print(f"row 2 kernel (fused_score_segmax): {out['kernel_ms']:7.3f} ms", flush=True)
    del corpus, q0
    common.release(dev)
    return out


if __name__ == "__main__":
    main()
