"""Rejection-threshold sweep (port of scripts/sweep_rejection.py): boots
one port server with the current environment (point ENCODER_WEIGHTS /
RERANKER_WEIGHTS at staged checkpoints to calibrate a new asset) and
evaluates the DEV-split baseline at several rejection_threshold values.

The threshold is the engine-level confidence floor (the judge's absolute
yes-probability with reranking on); results below it are dropped, which
is both how rejection queries return nothing AND how the gate-judge
prunes noise from the retrieval pool, but a floor set too high drops true
results. DEV SPLIT ONLY: the held-out split must never drive this choice.

    python -m rust_local_rag_tpu_torch.tools.sweep_rejection [--device cpu]
    python -m rust_local_rag_tpu_torch.tools.sweep_rejection "0.02,0.04,0.06"

SWEEP_KEEP=1 preserves per-query reports.
"""

from __future__ import annotations

import json
import sys

from rust_local_rag_tpu_torch.tools.sweep_common import eval_server, floats, parse, run_points

THRESHOLDS = [0.0, 0.03, 0.045, 0.06, 0.08, 0.10, 0.12]


def points(thresholds=None):
    return [(f"rej_{t:g}".replace(".", "p"), {"rejection_threshold": t}) for t in floats(thresholds, THRESHOLDS)]


def sweep(thresholds=None, device: str = "cuda") -> dict:
    """{threshold as text: {"hit", "mrr", "rej"}} from one server."""
    pts = points(thresholds)
    with eval_server("sweep_rej_", device) as (base, gt, work):
        results = run_points(base, gt, work, pts)
    return {str(sp["rejection_threshold"]): results[name] for name, sp in pts}


def main(argv=None) -> int:
    (thresholds,), device = parse(argv, __doc__.split("\n\n")[0], "thresholds")
    print(json.dumps(sweep(thresholds, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
