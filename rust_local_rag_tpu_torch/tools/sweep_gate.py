"""Joint rejection-gate sweep (port of scripts/sweep_gate.py): a (judge
yes-p floor x dense-cosine floor) grid on the DEV split (held-out and
third-party splits must never drive this choice).

The judge's absolute calibration only generalises to junk resembling its
training templates; genuinely novel junk usually ALSO has a low best dense
cosine. Requiring both signals covers each one's blind spot without
retraining. Both knobs ride the request body (rejection_threshold /
rejection_cosine_floor), so one server sweeps the whole grid.

    python -m rust_local_rag_tpu_torch.tools.sweep_gate [--device cpu]
    python -m rust_local_rag_tpu_torch.tools.sweep_gate "0.0,0.06" "0.0,0.25,0.3,0.35"
"""

from __future__ import annotations

import json
import sys

from rust_local_rag_tpu_torch.tools.sweep_common import eval_server, floats, parse, run_points

THRESHOLDS = [0.0, 0.06]
COS_FLOORS = [0.0, 0.20, 0.25, 0.30, 0.35]


def points(thresholds=None, floors=None):
    return [
        (f"thr{t:g}_cos{c:g}".replace(".", "p"), {"rejection_threshold": t, "rejection_cosine_floor": c})
        for t in floats(thresholds, THRESHOLDS)
        for c in floats(floors, COS_FLOORS)
    ]


def main(argv=None) -> int:
    lists, device = parse(argv, __doc__.split("\n\n")[0], "thresholds", "floors")
    with eval_server("sweep_gate_", device) as (base, gt, work):
        results = run_points(base, gt, work, points(*lists))
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
