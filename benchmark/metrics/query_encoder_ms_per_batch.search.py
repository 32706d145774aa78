"""Host milliseconds a call of the query encoder (get_query_embeddings_device
or get_query_embeddings), outside the profiled sub-window; the device work
the call queues may finish after it returns."""

PROBES = [{"kind": "span", "name": "query_encoder",
           "targets": ["service.get_query_embeddings_device", "service.get_query_embeddings"]},
          {"kind": "range", "name": "benchmark.query_encoder",
           "targets": ["service.get_query_embeddings_device", "service.get_query_embeddings"]}]


def read(rec):
    calls, seconds, _ = rec.probes.spans.get("query_encoder", (0, 0.0, 0))
    return seconds / calls * 1e3 if calls else None
