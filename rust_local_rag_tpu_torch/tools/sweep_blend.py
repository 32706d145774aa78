"""Blend sweep (port of scripts/sweep_blend.py): boots one port server with
the current environment (point RERANKER_WEIGHTS at a staged checkpoint to
validate a new judge) and evaluates the listed rerank-blend points on the
dev eval.

    python -m rust_local_rag_tpu_torch.tools.sweep_blend [--device cpu]
    # custom points: comma-separated reranker weights; "off" = reranker
    # disabled control; 0.0 = judge runs as the rejection gate only
    python -m rust_local_rag_tpu_torch.tools.sweep_blend "off,0.0,0.05,0.1"

SWEEP_KEEP=1 preserves per-query reports.
"""

from __future__ import annotations

import json
import sys

from rust_local_rag_tpu_torch.tools.sweep_common import eval_server, parse, run_points

DEFAULT_POINTS = [
    ("rr_off", {"use_reranker": False}),
    ("rr_0.5", {"weights": {"reranker": 0.5, "initial": 0.5}}),
    ("rr_0.35", {"weights": {"reranker": 0.35, "initial": 0.65}}),
    ("rr_0.25", {"weights": {"reranker": 0.25, "initial": 0.75}}),
    ("rr_0.7", {"weights": {"reranker": 0.7, "initial": 0.3}}),
]


def points(weights=None):
    """The points of a comma-separated weight list (None: the defaults)."""
    if weights is None:
        return list(DEFAULT_POINTS)
    out = []
    for tok_w in weights.split(","):
        if tok_w == "off":
            out.append(("rr_off", {"use_reranker": False}))
        else:
            w = float(tok_w)
            out.append((f"rr_{tok_w}", {"weights": {"reranker": w, "initial": 1.0 - w}}))
    return out


def main(argv=None) -> int:
    (weights,), device = parse(argv, __doc__.split("\n\n")[0], "weights")
    with eval_server("sweep_blend_", device) as (base, gt, work):
        results = run_points(base, gt, work, points(weights))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
