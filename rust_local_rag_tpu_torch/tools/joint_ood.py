"""JOINT out-of-domain rule (port of scripts/exp_joint_ood.py):
IDF-weighted unseen-term mass x best dense cosine over the dev split.

Neither marginal separates the dev split's junk from gold
(query_cosine_floor: the cosines overlap; unseen mass alone kills
paraphrase gold). The two signals fail on DIFFERENT queries: paraphrase
gold carries novel wording (high unseen mass) but the trained encoder
still places it near its passage (good cosine), while junk has novel
wording AND no passage to be near. Scans the joint rule

    reject if unseen_mass >= a AND best_cos <= b

over the dev split on the port's engine (the card unless --device cpu)
and prints the (a, b) frontier.

    python -m rust_local_rag_tpu_torch.tools.joint_ood [--device cpu]
"""

from __future__ import annotations

import collections
import math
from typing import List

import numpy as np

from rust_local_rag_tpu_torch.ops.bm25 import tokenize
from rust_local_rag_tpu_torch.experiments.common import parse_device
from rust_local_rag_tpu_torch.tools import common

JUNK_REJECT = 0.8
DANGER = (0.25, 0.5)  # gold with mass >= 0.25 and cos <= 0.5 is printed


def unseen_mass_fn(texts: List[str]):
    """query -> IDF-weighted share of its terms that no text holds, with
    document frequencies over `texts` (the indexed chunks: what serving
    sees)."""
    df: collections.Counter = collections.Counter()
    for t in texts:
        for tok in set(tokenize(t)):
            df[tok] += 1
    n = len(texts)
    idf_max = math.log((n + 0.5) / 0.5)

    def unseen_mass(q: str) -> float:
        num = den = 0.0
        for t in set(tokenize(q)):
            d = df.get(t, 0)
            idf = max(math.log((n - d + 0.5) / (d + 0.5)), 0.0) if d else idf_max
            den += idf
            if d == 0:
                num += idf
        return num / den if den else 0.0

    return unseen_mass


def table(eng, queries) -> dict:
    """The frontier, the junk queries' (mass, cos) and gold in the danger
    zone, over the engine's index."""
    unseen_mass = unseen_mass_fn([m.text for _, m in eng.store.iter_meta()])
    gold = [q for q in queries if not q.get("is_rejection")]
    junk = [q for q in queries if q.get("is_rejection")]

    def feats(qs):
        return (np.array([unseen_mass(q["query"]) for q in qs]),
                common.best_cos(eng, [q["query"] for q in qs]))

    gm, gc = feats(gold)
    jm, jc = feats(junk)
    best = []
    for a in np.arange(0.10, 0.55, 0.025):
        for b in np.arange(0.30, 0.55, 0.01):
            jr = float(np.mean((jm >= a) & (jc <= b)))
            gk = float(np.mean((gm >= a) & (gc <= b)))
            if jr >= JUNK_REJECT:
                best.append((gk, -jr, round(float(a), 3), round(float(b), 2)))
    return {"frontier": sorted(best)[:15],
            "junk": [(float(m), float(c), q["query"]) for q, m, c in zip(junk, jm, jc)],
            "danger": [(float(m), float(c), q["query"]) for q, m, c in zip(gold, gm, gc)
                       if m >= DANGER[0] and c <= DANGER[1]]}


def lines(t: dict) -> List[str]:
    """The JAX script's printed table."""
    out = ["", "joint frontier (reject if mass>=a AND cos<=b):"]
    out += [f"  a={a} b={b}: junk-reject {-njr:.3f} gold-killed {gk:.3f}" for gk, njr, a, b in t["frontier"]]
    if not t["frontier"]:
        out.append("  (no cell reaches junk-reject >= 0.8)")
    out += ["", "per-junk-query (mass, cos):"] + [f"  {m:.3f} {c:.3f} {q[:60]}" for m, c, q in t["junk"]]
    out += ["gold in danger zone (mass>=0.25 and cos<=0.5):"] + [f"  {m:.3f} {c:.3f} {q[:60]}" for m, c, q in t["danger"]]
    return out


def main(argv=None) -> None:
    dev = parse_device(argv, __doc__.split("\n\n")[0])
    with common.eval_engine("joint_ood_", dev) as (eng, queries):
        t = table(eng, queries)
    for line in lines(t):
        print(line)


if __name__ == "__main__":
    main()
