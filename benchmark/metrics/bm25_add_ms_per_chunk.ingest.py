"""Host milliseconds a chunk in the BM25 adds of RagEngine.add_chunks
(the program's span store.bm25: one add_chunks call a document, that is
one hold of the index's lock and one native call, which tokenises ASCII
text in C++), outside the profiled sub-window."""

from harness import spans

PROBES = [spans.hook("service.embed_in_batches")]


def read(rec):
    return spans.ms_per_item(rec, "store.bm25")
