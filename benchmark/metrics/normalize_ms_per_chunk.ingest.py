"""Host milliseconds a chunk in RagEngine.add_chunks' per-row normalise
(the program's span store.normalize), outside the profiled sub-window."""

from harness import spans

PROBES = [spans.hook("service.embed_in_batches")]


def read(rec):
    return spans.ms_per_item(rec, "store.normalize")
