"""Sweep the reranker blend weight over a live port server to calibrate
RAG_RERANKER_WEIGHT for the trained yes/no judge (port of
scripts/sweep_rerank_weight.py, on sweep_common: the same server boot,
indexing and evaluation the script wrote out for itself).

Boots one server (current environment), indexes the eval corpus, then runs
the baseline evaluation at several (reranker, initial) blends plus a
reranker-off control. Prints one summary line a point.

    python -m rust_local_rag_tpu_torch.tools.sweep_rerank_weight [--device cpu]
"""

from __future__ import annotations

import json
import sys

from rust_local_rag_tpu_torch.tools.sweep_common import eval_server, parse, run_points


def points():
    return [
        ("rr_off", {"use_reranker": False}),
        ("rr_0.7", {"weights": {"reranker": 0.7, "initial": 0.3}}),
        ("rr_0.5", {"weights": {"reranker": 0.5, "initial": 0.5}}),
        ("rr_0.35", {"weights": {"reranker": 0.35, "initial": 0.65}}),
        ("rr_0.2", {"weights": {"reranker": 0.2, "initial": 0.8}}),
    ]


def main(argv=None) -> int:
    _, device = parse(argv, __doc__.split("\n\n")[0])
    with eval_server("sweep_rr_", device) as (base, gt, work):
        results = run_points(base, gt, work, points())
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
