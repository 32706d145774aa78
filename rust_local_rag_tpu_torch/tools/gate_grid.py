"""Offline grid search of the FULL serving rejection gate on the dev split
(port of scripts/exp_gate_grid.py): per-candidate judge threshold x
query-level judge floor x joint unseen-term gate (mass, cosine ceiling,
judge ceiling), engine semantics and the eval contract, no server.

Uses the cached dev retrieval heads (judge_dev._heads: top-15 a query with
initial / embedding scores and the engine's unseen-term mass) and one judge
pass over all (query, candidate) prompts. Then every gate config is a few
numpy masks:

  engine: query empty if (mass >= a AND best_emb <= b [AND max yes-p <= c])
                      or (q_floor > 0 and max yes-p < q_floor);
          else drop candidates with yes-p < thr; return top-5 survivors.
  eval  : junk success  = no returned result with emb >= 0.3
          gold hit      = any returned result's doc matches a gold doc

Prints the configs passing hit >= 0.80 and rejection >= 0.80, and the
Pareto set over (hit, rejection). DEV ONLY: held-out stays report-only.

    RERANKER_WEIGHTS=/path/reranker.safetensors \\
        python -m rust_local_rag_tpu_torch.tools.gate_grid [--device cpu]
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from rust_local_rag_tpu_torch.experiments.common import parse_device
from rust_local_rag_tpu_torch.tools import common, judge_dev

THRESHOLDS = (0.0, 0.02, 0.03, 0.045, 0.06)
QUERY_FLOORS = (0.0, 0.03, 0.045, 0.06, 0.08, 0.1, 0.15)
MASSES = (0.0, 0.30, 0.33, 0.36, 0.38, 0.40, 0.42, 0.45, 0.50, 0.55, 0.60, 0.70)
COS_CEILS = (0.50, 0.55, 0.60, 0.65)
JUDGE_CEILS = (0.0, 0.06, 0.10, 0.15, 0.20, 0.30)
PASS = 0.80


def planes(heads, yes_p) -> dict:
    """[nq, K] yes-p, embedding score, validity and gold-document planes,
    and each query's unseen mass and junk flag."""
    nq = len(heads)
    K = max(len(h[3]) for h in heads)
    p = {"yes": np.zeros((nq, K)), "emb": np.zeros((nq, K)), "valid": np.zeros((nq, K), dtype=bool),
         "gold": np.zeros((nq, K), dtype=bool), "mass": np.zeros(nq), "junk": np.zeros(nq, dtype=bool)}
    k = 0
    for qi, (_query, is_rej, gold, head, um) in enumerate(heads):
        p["mass"][qi] = um
        p["junk"][qi] = is_rej
        for r, (_text, doc, _page, _section, _initial, e) in enumerate(head):
            p["yes"][qi, r] = yes_p[k]
            p["emb"][qi, r] = e
            p["valid"][qi, r] = True
            p["gold"][qi, r] = common.is_gold_doc(gold, doc)
            k += 1
    return p


def grid(heads, yes_p) -> List[tuple]:
    """[(hit, rejection, thr, q_floor, a, b, c)] over the whole grid."""
    p = planes(heads, yes_p)
    yes, emb, valid, is_gold_doc, mass, is_junk = (p[k] for k in ("yes", "emb", "valid", "gold", "mass", "junk"))
    best_emb = np.max(np.where(valid, emb, -np.inf), axis=1)
    qmax_yes = np.max(np.where(valid, yes, -np.inf), axis=1)

    def run(thr, qf, a, b, c=0.0):
        killed = np.zeros(len(heads), dtype=bool)
        if a > 0:
            um_kill = (mass >= a) & (best_emb <= b)
            if c > 0:
                # 3-way rule: the unseen gate fires only when the judge ALSO
                # found no confident yes anywhere in the head
                um_kill &= qmax_yes <= c
            killed |= um_kill
        if qf > 0:
            killed |= qmax_yes < qf
        keep = valid & (yes >= thr) & ~killed[:, None]
        # survivors keep device order; the first 5 kept of a row
        top5 = keep & (np.cumsum(keep, axis=1) <= 5)
        hit = float(np.mean(np.any(top5 & is_gold_doc, axis=1)[~is_junk]))
        confident = top5 & (emb >= 0.3)
        rej = float(np.mean(~np.any(confident, axis=1)[is_junk]))
        return hit, rej

    out = []
    for thr in THRESHOLDS:
        for qf in QUERY_FLOORS:
            for a in MASSES:
                for b in COS_CEILS if a > 0 else (1.0,):
                    for c in JUDGE_CEILS if a > 0 else (0.0,):
                        out.append((*run(thr, qf, a, b, c), thr, qf, a, b, c))
    return out


def table(heads, yes_p) -> dict:
    """{"grid": every config, "passing": the top 20 passing both bars,
    "n_passing", "pareto": the frontier by hit}."""
    rows = grid(heads, yes_p)
    passing = [g for g in rows if g[0] >= PASS and g[1] >= PASS]
    pareto, seen_best = [], -1.0
    for g in sorted(rows, key=lambda g: -g[0]):
        if g[1] > seen_best:
            seen_best = g[1]
            pareto.append(g)
    return {"grid": rows, "n_passing": len(passing),
            "passing": sorted(passing, key=lambda g: (-(g[0] + g[1]), -g[0]))[:20], "pareto": pareto}


def _row(g) -> str:
    hit, rej, thr, qf, a, b, c = g
    return f"  hit {hit:.3f} rej {rej:.3f}  thr={thr:g} qf={qf:g} unseen=({a:g},{b:g},judge<={c:g})"


def lines(t: dict) -> List[str]:
    """The JAX script's printed table."""
    return (["", f"{t['n_passing']} configs pass hit>=0.80 AND rejection>=0.80"] + [_row(g) for g in t["passing"]]
            + ["", "pareto frontier (all configs):"] + [_row(g) for g in t["pareto"]])


def main(argv=None) -> None:
    dev = parse_device(argv, __doc__.split("\n\n")[0])
    heads = judge_dev._heads(dev)
    print(f"{len(heads)} dev queries (cache: {os.path.basename(judge_dev.CACHE)})")
    rr = common.default_judge(dev)
    yes_p = common.score_heads(heads, rr)
    for line in lines(table(heads, yes_p)):
        print(line)


if __name__ == "__main__":
    main()
