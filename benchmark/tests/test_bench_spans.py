"""The readers of the program's own spans (harness/spans.py and the metrics
that read it) in whole runs on the CPU: a traced marco-ingest run reports
the eight ingest metrics, an untraced run leaves the program's tracer off,
and traced search runs of the judged cells covid-default and
marco-default-c32, which BENCHMARK.json does not hold, report the five
search readers of the program's spans, the MMR's among them."""

import json
import math
import time

import pytest
import torch

from harness import runner
from rust_local_rag_tpu_torch.utils import profiling
from test_bench_runs import INGEST, SEED, SIZES, report, search_manifest

CPU = torch.device("cpu")
INGEST_METRICS = ("tokenize_ms_per_chunk.ingest", "encoder_enqueue_ms_per_chunk.ingest",
                  "encoder_wait_ms_per_chunk.ingest", "embed_handoff_ms_per_batch.ingest",
                  "normalize_ms_per_chunk.ingest", "slab_ms_per_chunk.ingest", "bm25_add_ms_per_chunk.ingest",
                  "encoder_token_use.ingest")
SEARCH_METRICS = ("queue_wait_ms_per_request.search", "serialize_ms_per_request.search",
                  "bm25_lock_wait_ms_per_query.search", "judge_prompts_ms_per_query.search",
                  "mmr_ms_per_query.search")


def _run(workload, overrides, seconds, trace, manifest=None):
    out, lines = runner.run(workload, SEED, seconds, trace, time.monotonic(), device=CPU, overrides=overrides,
                            manifest=manifest)
    json.dumps(out)
    return out


def test_traced_ingest_reports_the_program_spans():
    manifest = runner.read_manifest()
    listed = {m["name"] for m in manifest["per_layer"] if "marco-ingest" in m.get("workloads", [])}
    assert set(INGEST_METRICS) <= listed
    out = _run("marco-ingest", INGEST, 4.0, trace=True)
    assert out["correct"], out["compared"]
    for name in INGEST_METRICS:
        value = out["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    assert out["metrics"]["encoder_token_use.ingest"]["value"] <= 100.0
    assert not profiling.TRACER.on  # the reader turned it off again


def test_untraced_run_leaves_the_tracer_off():
    profiling.reset()
    out = _run("marco-ingest", INGEST, 3.0, trace=False)
    assert out["correct"]
    assert not profiling.TRACER.on
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    assert not set(INGEST_METRICS) & set(out["metrics"])


@pytest.mark.parametrize("cell", ["covid-default", "marco-default-c32"])
def test_traced_search_reports_the_search_readers(cell):
    manifest = search_manifest()
    for name in SEARCH_METRICS:
        report(manifest, "per_layer", {"name": name, "unit": "ms", "better": "lower", "source": "program_span",
                                       "layer": "search", "moves": "search_qps"}, cell)
    out = _run(cell, SIZES[cell], 12.0, trace=True, manifest=manifest)
    assert out["correct"], out["compared"]
    for name in SEARCH_METRICS:
        value = out["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    # the body {} judges and diversifies every request: both run on the host at these batch sizes
    assert out["metrics"]["judge_prompts_ms_per_query.search"]["value"] > 0
    assert out["metrics"]["mmr_ms_per_query.search"]["value"] > 0
    assert not profiling.TRACER.on
