"""Unseen-term-gate sweep on the DEV split (port of scripts/sweep_unseen.py):
a (mass threshold x cosine ceiling) grid, with the baseline judge gate
kept at its committed operating point (rejection_threshold from
baseline.yaml).

The joint unseen gate is the third rejection signal: junk whose
informative terms the corpus never indexed returns nothing when its best
pool cosine is also unimpressive (tools/joint_ood gives the offline
frontier). Sweep dev-only; held-out stays report-only.

    python -m rust_local_rag_tpu_torch.tools.sweep_unseen [--device cpu]
    python -m rust_local_rag_tpu_torch.tools.sweep_unseen "0.5,0.6,0.7" "0.5,0.6"
    RERANKER_WEIGHTS=/path python -m rust_local_rag_tpu_torch.tools.sweep_unseen   # staged judge
"""

from __future__ import annotations

import json
import sys

from rust_local_rag_tpu_torch.tools.sweep_common import eval_server, floats, parse, run_points

MASSES = [0.0, 0.45, 0.55, 0.65, 0.75]
COS_CEILS = [0.5, 0.6]


def points(masses=None, ceils=None):
    out = []
    for m in floats(masses, MASSES):
        for c in floats(ceils, COS_CEILS) if m > 0 else [1.0]:
            out.append((f"um{m:g}_c{c:g}".replace(".", "p"), {"rejection_unseen_mass": m, "rejection_unseen_cos": c}))
    return out


def main(argv=None) -> int:
    lists, device = parse(argv, __doc__.split("\n\n")[0], "masses", "ceils")
    with eval_server("sweep_um_", device) as (base, gt, work):
        results = run_points(base, gt, work, points(*lists))
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
