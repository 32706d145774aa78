"""Wall milliseconds in RagEngine.add_chunks (the slab through the chunk
store, the texts into the native BM25 index) a chunk, outside the profiled
sub-window."""

PROBES = [{"kind": "span", "name": "store", "target": "engine.add_chunks", "fn": lambda a, kw: len(a[0])},
          {"kind": "range", "name": "benchmark.store", "target": "engine.add_chunks"}]


def read(rec):
    _, seconds, chunks = rec.probes.spans.get("store", (0, 0.0, 0))
    return seconds / chunks * 1e3 if chunks else None
