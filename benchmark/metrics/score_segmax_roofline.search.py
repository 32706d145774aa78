"""The masked score + segment-max kernel's share of its roofline in the
profiled sub-window: the mean least time of the launches recorded there
(harness.work.score_segmax_bound at the store's live rows) times the
kernels the trace holds, over their device time."""

from harness import trace, work

KERNELS = ("score_segmax_", "split_terms")


def _launch(a, kw, roots):
    q, corpus = a[0], a[1]
    return {"bound": work.score_segmax_bound(q.shape[0], len(roots["engine"].store), corpus.shape[1],
                                             corpus.element_size(), q.element_size())}


PROBES = [{"kind": "record", "name": "score_segmax", "target": "module:rust_local_rag_tpu_torch.ops.hybrid.score_segmax",
           "fn": _launch}]


def read(rec):
    launches = rec.probes.records.get("score_segmax", [])
    if rec.trace is None or not launches:
        return None
    events = trace.kernels(rec.trace, KERNELS)
    count = sum(1 for e in events if "score_segmax_" in e["name"])
    us = sum(float(e.get("dur", 0.0)) for e in events)
    if not count or us <= 0:
        return None
    mean = sum(x["bound"] for x in launches) / len(launches)
    return 100.0 * mean * count / (us / 1e6)
