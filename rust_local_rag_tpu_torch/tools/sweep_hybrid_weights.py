"""Sweep the hybrid embedding / lexical weights over a live port server
(port of scripts/sweep_hybrid_weights.py, on sweep_common: the same server
boot, indexing and evaluation the script wrote out for itself), to check
whether the 0.7 / 0.3 reference-parity default is right for the trained
encoder on the dev eval.

The points are the script's phase 2: the 0.9 / 0.1 hybrid weights (which
won hit at the 0.35 / 0.65 blend) with the rejection threshold swept,
since the threshold calibrated at 0.7 / 0.3 breaks there.

    python -m rust_local_rag_tpu_torch.tools.sweep_hybrid_weights [--device cpu]
"""

from __future__ import annotations

import json
import sys

from rust_local_rag_tpu_torch.tools.sweep_common import eval_server, parse, run_points

BLEND = {"reranker": 0.35, "initial": 0.65}
W91 = {"weights": {**BLEND, "embedding": 0.9, "lexical": 0.1}}


def points():
    return [(f"rt_{t}", {**W91, "rejection_threshold": t}) for t in (0.055, 0.07, 0.09, 0.12)]


def main(argv=None) -> int:
    _, device = parse(argv, __doc__.split("\n\n")[0])
    with eval_server("sweep_hw_", device) as (base, gt, work):
        results = run_points(base, gt, work, points())
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
