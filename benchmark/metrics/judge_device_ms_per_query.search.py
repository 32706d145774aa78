"""Device milliseconds of the kernels launched under the judge's calls
(RerankerService.score_prompts / dispatch_prompts), a judged query, in the
profiled sub-window; the queries are the distinct "Query:" lines of the
prompts those calls took."""

PROBES = [
    {"kind": "range", "name": "benchmark.judge", "targets": ["judge.score_prompts", "judge.dispatch_prompts"]},
    {"kind": "record", "name": "judged_queries", "targets": ["judge.score_prompts", "judge.dispatch_prompts"],
     "fn": lambda a, kw, roots: {"queries": len({p.split("\n", 1)[0] for p in a[0]})}},
]


def read(rec):
    from harness import trace

    queries = sum(r["queries"] for r in rec.probes.records.get("judged_queries", []))
    if rec.trace is None or not queries:
        return None
    us = trace.range_device_us(rec.trace, "benchmark.judge")
    return us / 1e3 / queries if us > 0 else None
