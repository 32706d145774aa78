"""Milliseconds a query in the greedy MMR over its candidate pool (the
program's span engine.mmr in RagEngine.search_with_diversity_batch: the
host's greedy for batches under 8, the device's for larger ones), outside
the profiled sub-window."""

from harness import spans

PROBES = [spans.hook("service.get_query_embeddings_device")]


def read(rec):
    return spans.ms_per_item(rec, "engine.mmr")
