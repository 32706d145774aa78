"""Host milliseconds a chunk in the BM25 adds of RagEngine.add_chunks
(the program's span store.bm25: a Python tokenise and a ctypes call a
chunk under the index's lock), outside the profiled sub-window."""

from harness import spans

PROBES = [spans.hook("service.embed_in_batches")]


def read(rec):
    return spans.ms_per_item(rec, "store.bm25")
