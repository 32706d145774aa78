"""Can ANY dense-cosine floor separate junk queries from gold queries?
(port of scripts/exp_query_cosine_floor.py)

Measures each dev query's best dense cosine over its retrieval head on
the port's engine (the card unless --device cpu), with the encoder at
ENCODER_WEIGHTS (else the committed one), and prints both distributions
and, for each floor, the share of gold that passes and of junk that is
rejected. The JAX script's docstring records the committed encoder's
answer: the distributions overlap, so the committed gate cannot ride
cosine, and junk separation comes from the judge.

    python -m rust_local_rag_tpu_torch.tools.query_cosine_floor [--device cpu]
"""

from __future__ import annotations

from typing import List

import numpy as np

from rust_local_rag_tpu_torch.experiments.common import parse_device
from rust_local_rag_tpu_torch.tools import common

FLOORS = (0.40, 0.42, 0.44, 0.46, 0.48, 0.50)


def table(eng, queries) -> dict:
    """{"gold": best cosines of the retrieval queries, "junk": of the
    rejection queries, "floors": [(floor, gold-pass, junk-reject)]}."""
    g = common.best_cos(eng, [q["query"] for q in queries if not q.get("is_rejection")])
    j = common.best_cos(eng, [q["query"] for q in queries if q.get("is_rejection")])
    return {"gold": g, "junk": j, "floors": [(f, float((g >= f).mean()), float((j < f).mean())) for f in FLOORS]}


def lines(t: dict) -> List[str]:
    """The JAX script's printed table."""
    g, j = t["gold"], t["junk"]
    return (["GOLD best-cos: min %.3f p5 %.3f p10 %.3f p25 %.3f med %.3f"
             % (g.min(), *np.percentile(g, [5, 10, 25, 50])),
             "JUNK best-cos: med %.3f p75 %.3f p90 %.3f max %.3f"
             % (np.percentile(j, 50), np.percentile(j, 75), np.percentile(j, 90), j.max())]
            + [f"floor {f}: gold-pass {gp:.3f} junk-reject {jr:.3f}" for f, gp, jr in t["floors"]])


def main(argv=None) -> None:
    dev = parse_device(argv, __doc__.split("\n\n")[0])
    with common.eval_engine("qcos_", dev) as (eng, queries):
        t = table(eng, queries)
    for line in lines(t):
        print(line)


if __name__ == "__main__":
    main()
