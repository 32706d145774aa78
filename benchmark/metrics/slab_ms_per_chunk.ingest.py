"""Host milliseconds a chunk in ChunkStore.add_chunks, the slab's write
and growth (the program's span store.slab), outside the profiled
sub-window."""

from harness import spans

PROBES = [spans.hook("service.embed_in_batches")]


def read(rec):
    return spans.ms_per_item(rec, "store.slab")
