"""Offline blend sweep on the cached dev heads (port of
scripts/exp_blend_offline.py): does ANY reranker blend weight > 0 beat
weight 0 on hit / MRR with the judge at RERANKER_WEIGHTS?

Replays _blend_and_fill (per-query max normalisation, blended = w *
rerank_norm + (1 - w) * initial_norm, descending stable sort, top-5) and
scores doc-level hit@5 / MRR@5 over the dev retrieval queries: the live
blend sweep's question at the cost of one judge pass.

    RERANKER_WEIGHTS=/path/reranker.safetensors \\
        python -m rust_local_rag_tpu_torch.tools.blend_offline [--device cpu]
"""

from __future__ import annotations

from typing import List

import numpy as np

from rust_local_rag_tpu_torch.experiments.common import parse_device
from rust_local_rag_tpu_torch.tools import common, judge_dev

WEIGHTS = (0.0, 0.05, 0.1, 0.15, 0.2, 0.25, 0.35, 0.5, 0.7, 1.0)
F32_EPS = 1.1920929e-07


def table(heads, yes_p) -> List[tuple]:
    """[(w, hit@5, mrr@5)] over the retrieval queries of `heads` (yes_p:
    one value a candidate of those queries, in order)."""
    nq = len(heads)
    K = max(len(h[3]) for h in heads)
    yes = np.full((nq, K), -np.inf)
    init = np.full((nq, K), -np.inf)
    gold_doc = np.zeros((nq, K), dtype=bool)
    k = 0
    for qi, (_query, _rej, gold, head, _um) in enumerate(heads):
        for r, (_text, doc, _page, _section, initial, _e) in enumerate(head):
            yes[qi, r] = yes_p[k]
            init[qi, r] = initial
            gold_doc[qi, r] = common.is_gold_doc(gold, doc)
            k += 1
    valid = np.isfinite(init)
    max_rr = np.maximum(np.max(np.where(valid, yes, 0.0), axis=1), F32_EPS)
    max_in = np.maximum(np.max(np.where(valid, init, 0.0), axis=1), F32_EPS)

    def metrics(w):
        blended = np.where(valid, w * (yes / max_rr[:, None]) + (1.0 - w) * (init / max_in[:, None]), -np.inf)
        order = np.argsort(-blended, axis=1, kind="stable")
        g5 = np.take_along_axis(gold_doc, order[:, :5], axis=1)
        hit = float(np.mean(np.any(g5, axis=1)))
        first = np.argmax(g5, axis=1)
        mrr = float(np.mean(np.where(np.any(g5, axis=1), 1.0 / (first + 1), 0.0)))
        return hit, mrr

    return [(w, *metrics(w)) for w in WEIGHTS]


def lines(rows) -> List[str]:
    """The JAX script's printed table."""
    return ["", "  w    hit@5   mrr@5"] + [f"  {w:4.2f}  {hit:.3f}  {mrr:.3f}" for w, hit, mrr in rows]


def main(argv=None) -> None:
    dev = parse_device(argv, __doc__.split("\n\n")[0])
    heads = [h for h in judge_dev._heads(dev) if not h[1]]  # retrieval queries only
    print(f"{len(heads)} dev retrieval queries")
    rr = common.default_judge(dev)
    yes_p = common.score_heads(heads, rr)
    for line in lines(table(heads, yes_p)):
        print(line)


if __name__ == "__main__":
    main()
