"""Offline judge evaluation on the dev split (port of
scripts/exp_judge_dev.py): predicts what the live rejection / blend sweep
will see, without a server.

Builds the port's engine over the authored eval corpus on the card, takes
each dev query's top-15 retrieval head ONCE (disk-cached at CACHE), then
scores every (query, candidate) prompt with the judge at RERANKER_WEIGHTS
(else the committed one) in one score_prompts and reports:

  * gold queries: distribution of the TOP-RANKED gold hit's yes-p and of
    the per-query MAX yes-p (what the gate must NOT fall under);
  * junk queries: per-query MAX yes-p (what the gate must stay above);
  * for candidate thresholds: predicted rejection rate and the fraction
    of gold queries whose whole head dies (hit upper-bound loss).

    RERANKER_WEIGHTS=/path/reranker.safetensors \\
        python -m rust_local_rag_tpu_torch.tools.judge_dev [--device cpu]
"""

from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np

from rust_local_rag_tpu_torch.experiments.common import parse_device
from rust_local_rag_tpu_torch.tools import common

# the port's own heads cache (the JAX script's is dev_heads2.pkl); read at
# call time, so a caller may point it elsewhere
CACHE = os.path.join(os.path.expanduser("~"), ".cache", "rag_tpu_premine", "torch_dev_heads.pkl")
THRESHOLDS = (0.02, 0.03, 0.045, 0.06, 0.08, 0.12, 0.2, 0.3)


def _heads(device="cuda"):
    """[(query, is_rejection, gold_references, [(chunk_text, doc, page,
    section, initial, emb)], unseen_mass)] for the dev split, cached at
    CACHE."""
    if os.path.exists(CACHE):
        with open(CACHE, "rb") as f:
            return pickle.load(f)
    with common.eval_engine("judge_dev_", device) as (eng, queries):
        results = common.heads_of(eng, [q["query"] for q in queries])
        out = [
            (
                q["query"],
                bool(q.get("is_rejection")),
                q.get("gold_references") or [],
                [(x.text, x.document, x.page_number, x.section, x.initial_score, x.embedding_score) for x in r],
                # the engine lexical index's unseen-term mass: the joint
                # gate's OOD signal at serving accuracy
                eng.lexical_index.unseen_mass(q["query"]),
            )
            for q, r in zip(queries, results)
        ]
    os.makedirs(os.path.dirname(CACHE), exist_ok=True)
    with open(CACHE, "wb") as f:
        pickle.dump(out, f)
    return out


def table(heads, yes_p) -> dict:
    """The study's numbers from the heads and each candidate's yes-p."""
    yes_p = np.asarray(yes_p, dtype=np.float64)
    qid = np.asarray([qi for qi, h in enumerate(heads) for _ in h[3]])
    nq = len(heads)
    qmax = np.zeros(nq)
    np.maximum.at(qmax, qid, yes_p)
    # yes-p of each query's best GOLD candidate (page-tolerant doc match)
    gold_best = np.full(nq, -1.0)
    k = 0
    for qi, (_query, _rej, gold, head, _um) in enumerate(heads):
        for _text, doc, *_ in head:
            if common.is_gold_doc(gold, doc):
                gold_best[qi] = max(gold_best[qi], yes_p[k])
            k += 1
    is_junk = np.asarray([h[1] for h in heads])
    g, j = qmax[~is_junk], qmax[is_junk]
    gb = gold_best[~is_junk]
    return {
        "gold_max": tuple(np.percentile(g, [5, 25, 50])),
        "gold_best_gold": tuple(np.percentile(gb[gb >= 0], [5, 25, 50])),
        "junk_max": (np.median(j), *np.percentile(j, [75, 90]), j.max()),
        "thresholds": [(thr, float(np.mean(j < thr)), float(np.mean(g < thr)),
                        float(np.mean((gb >= 0) & (gb < thr)))) for thr in THRESHOLDS],
    }


def lines(t: dict) -> List[str]:
    """The JAX script's printed table."""
    out = ["", "GOLD per-query MAX yes-p: p5 %.4f p25 %.4f med %.4f" % t["gold_max"],
           "GOLD best-gold-candidate yes-p: p5 %.4f p25 %.4f med %.4f" % t["gold_best_gold"],
           "JUNK per-query MAX yes-p: med %.4f p75 %.4f p90 %.4f max %.4f" % t["junk_max"],
           "", "thr: junk-rejected | gold-heads-dead | gold-best-gold-below"]
    out += [f"  {thr:5.3f}: {jr:.3f} | {gd:.3f} | {gb:.3f}" for thr, jr, gd, gb in t["thresholds"]]
    return out


def main(argv=None) -> None:
    dev = parse_device(argv, __doc__.split("\n\n")[0])
    heads = _heads(dev)
    print(f"{len(heads)} dev queries with cached heads")
    rr = common.default_judge(dev)
    yes_p = common.score_heads(heads, rr)
    for line in lines(table(heads, yes_p)):
        print(line)


if __name__ == "__main__":
    main()
