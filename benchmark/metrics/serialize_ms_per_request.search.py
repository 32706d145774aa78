"""Host milliseconds a request in writing its answer's body: the native
serializer a batch (the program's span batch.serialize, items the batch's
requests) in the lanes that answer bytes, json.dumps a request on the
event loop (http.serialize) in those that answer objects; outside the
profiled sub-window."""

from harness import spans

PROBES = [spans.hook("service.get_query_embeddings_device")]


def read(rec):
    rows = [((spans.totals(rec) or {}).get("spans") or {}).get(n) for n in ("batch.serialize", "http.serialize")]
    rows = [r for r in rows if r]
    items = sum(r["items"] for r in rows)
    return sum(r["ns"] for r in rows) / items / 1e6 if items else None
