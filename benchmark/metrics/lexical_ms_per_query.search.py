"""Host milliseconds a query in the native BM25 index's score_slots_into,
outside the profiled sub-window."""

PROBES = [{"kind": "span", "name": "lexical", "target": "engine.lexical_index.score_slots_into"},
          # names the device's idle gaps under BM25 in the breakdown
          {"kind": "range", "name": "benchmark.lexical", "target": "engine.lexical_index.score_slots_into"}]


def read(rec):
    calls, seconds, _ = rec.probes.spans.get("lexical", (0, 0.0, 0))
    return seconds / calls * 1e3 if calls else None
