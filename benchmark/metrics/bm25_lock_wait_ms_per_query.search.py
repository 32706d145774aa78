"""Milliseconds a query waits for the native BM25 index's lock (the
program's interval bm25.lock_wait, over the queries of its span
engine.prep_lexical), outside the profiled sub-window."""

from harness import spans

PROBES = [spans.hook("service.get_query_embeddings_device")]


def read(rec):
    found = (spans.totals(rec) or {}).get("spans") or {}
    wait, queries = found.get("bm25.lock_wait"), found.get("engine.prep_lexical")
    return wait["ns"] / queries["items"] / 1e6 if wait and queries and queries["items"] else None
