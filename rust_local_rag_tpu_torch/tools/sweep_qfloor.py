"""Query-level rejection floor sweep on the DEV split (port of
scripts/sweep_qfloor.py).

Sweeps (rejection_threshold x rejection_query_floor): the per-candidate
judge floor against the QUERY-level floor (engine/rag_engine.py: a query
whose BEST judged yes-probability over the whole judged head falls below
the floor returns nothing; queries that pass keep their full result
list). The query floor decouples junk rejection from the per-candidate
gate's gold-kill.

DEV SPLIT ONLY (held-out / third-party must never drive this choice).

    python -m rust_local_rag_tpu_torch.tools.sweep_qfloor [--device cpu]
    python -m rust_local_rag_tpu_torch.tools.sweep_qfloor "0,0.06" "0,0.05,0.1,0.2,0.3"
"""

from __future__ import annotations

import json
import sys

from rust_local_rag_tpu_torch.tools.sweep_common import eval_server, floats, parse, run_points

THRESHOLDS = [0.0, 0.06]
Q_FLOORS = [0.0, 0.05, 0.10, 0.20, 0.30]


def points(thresholds=None, floors=None):
    return [
        (f"thr{t:g}_qf{q:g}".replace(".", "p"), {"rejection_threshold": t, "rejection_query_floor": q})
        for t in floats(thresholds, THRESHOLDS)
        for q in floats(floors, Q_FLOORS)
    ]


def main(argv=None) -> int:
    lists, device = parse(argv, __doc__.split("\n\n")[0], "thresholds", "floors")
    with eval_server("sweep_qfloor_", device) as (base, gt, work):
        results = run_points(base, gt, work, points(*lists))
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
