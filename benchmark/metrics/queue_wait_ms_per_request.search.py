"""Milliseconds a request waits in the search batcher, from submit to the
start of its batch (the program's interval batch.queue_wait), outside the
profiled sub-window."""

from harness import spans

PROBES = [spans.hook("service.get_query_embeddings_device")]


def read(rec):
    return spans.ms_per_item(rec, "batch.queue_wait")
