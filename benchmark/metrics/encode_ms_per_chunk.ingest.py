"""Wall milliseconds in EmbeddingService.embed_in_batches a chunk, outside
the profiled sub-window."""

PROBES = [{"kind": "span", "name": "encode", "target": "service.embed_in_batches", "fn": lambda a, kw: len(a[0])},
          {"kind": "range", "name": "benchmark.encode", "target": "service.embed_in_batches"}]


def read(rec):
    _, seconds, chunks = rec.probes.spans.get("encode", (0, 0.0, 0))
    return seconds / chunks * 1e3 if chunks else None
