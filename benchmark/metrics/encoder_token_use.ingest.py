"""The encoder's useful share of the tokens it computes: the valid tokens
of the real rows over the padded batch times its length bucket (the
program's counters encoder.tokens_valid / encoder.tokens_computed),
outside the profiled sub-window."""

from harness import spans

PROBES = [spans.hook("service.embed_in_batches")]


def read(rec):
    counters = (spans.totals(rec) or {}).get("counters") or {}
    computed = counters.get("encoder.tokens_computed")
    return 100.0 * counters.get("encoder.tokens_valid", 0) / computed if computed else None
