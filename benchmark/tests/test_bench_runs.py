"""Whole runs on the CPU at a size a test can hold, without the look for a
card: a sound run is correct, a run with its timed path broken underneath
is not (an answer altered where the engine produces it; rows written out
of step with their chunks; half of each batch of chunks left out), and the control, the
reference in float8 in the program's place, fails the cell's limits.

The search driver runs as the cells marco-hot-b512 (the hot lane),
covid-default and marco-default-c32 (the judged object lane, at f32 with
no ties and at bf16 with the configuration's ties), which BENCHMARK.json
does not hold today: search_manifest adds them to a copy of the
manifest."""

import json
import time

import pytest
import torch

from harness import runner

CPU = torch.device("cpu")
SEED = 2**31 + 77
SEARCH = {
    "config.corpus": {"documents": 2500, "mean_words": 160.77, "length_sigma": 0.35, "min_words": 24,
                      "max_words": 400, "zipf_s": 1.0, "heaps_k": 44, "heaps_beta": 0.49},
    "config.settings": {"RAG_TPU_CORPUS_DTYPE": "f32", "RAG_TPU_BATCH_MAX": "4", "RAG_TPU_BATCH_WINDOW_MS": "3",
                        "RAG_TPU_PIPELINE_DEPTH": "2", "RAG_TPU_FUSED_ATTN": "0"},
    "traffic.clients": 2, "traffic.sample": 2, "traffic.max_rate": 200,
}
# marco-hot-b512 at a size a test can hold: its own traffic (hot-c512's body), a small bf16 slab
HOT = {
    "config.corpus": {"documents": 2500, "mean_words": 55.98, "length_sigma": 0.3, "min_words": 8,
                      "max_words": 120, "zipf_s": 1.0, "heaps_k": 44, "heaps_beta": 0.49},
    "config.settings": {"RAG_TPU_CORPUS_DTYPE": "bf16", "RAG_TPU_BATCH_MAX": "8", "RAG_TPU_BATCH_WINDOW_MS": "3",
                        "RAG_TPU_PIPELINE_DEPTH": "2", "RAG_TPU_FUSED_ATTN": "0"},
    "traffic.clients": 8, "traffic.sample": 8, "traffic.max_rate": 300,
}
# marco-default-c32 at a size a test can hold: its own traffic (default-c32's body), a small bf16 slab
DEFAULT = {
    "config.corpus": {"documents": 2500, "mean_words": 55.98, "length_sigma": 0.3, "min_words": 8,
                      "max_words": 120, "zipf_s": 1.0, "heaps_k": 44, "heaps_beta": 0.49},
    "config.settings": {"RAG_TPU_CORPUS_DTYPE": "bf16", "RAG_TPU_BATCH_MAX": "4", "RAG_TPU_BATCH_WINDOW_MS": "3",
                        "RAG_TPU_PIPELINE_DEPTH": "2", "RAG_TPU_FUSED_ATTN": "0"},
    "traffic.clients": 2, "traffic.sample": 3, "traffic.max_rate": 200,
}
INGEST = {"traffic.max_rate": 300, "traffic.passages_per_document": {"mean": 6.0, "cycle": 64},
          "traffic.sample_rows": 12, "traffic.sample_queries": 4}
SIZES = {"covid-default": SEARCH, "marco-hot-b512": HOT, "marco-default-c32": DEFAULT}
SEARCH_CELLS = list(SIZES)


def report(m: dict, kind: str, entry: dict, cell: str) -> None:
    """Let `cell` report the metric `entry` names: add the cell to the
    manifest's entry of that name, or add the entry."""
    for e in m[kind]:
        if e["name"] == entry["name"]:
            e.setdefault("workloads", []).append(cell)
            return
    m[kind].append(dict(entry, workloads=[cell]))


def search_manifest() -> dict:
    """BENCHMARK.json with the search cells covid-default,
    marco-hot-b512 and marco-default-c32 and their metrics."""
    m = runner.read_manifest()
    m["configs"].append({"name": "trec-covid-f32", "source": "https://arxiv.org/abs/2104.08663",
                         "file": "benchmark/configs/trec-covid-f32.json", "reduced": [], "why": "search"})
    m["workloads"].append({"name": "covid-default", "config": "trec-covid-f32", "traffic": "default-c32",
                           "chips": 1, "why": "search"})
    m["workloads"].append({"name": "marco-hot-b512", "config": "msmarco-passage-bf16", "traffic": "hot-c512",
                           "chips": 1, "why": "search"})
    m["workloads"].append({"name": "marco-default-c32", "config": "msmarco-passage-bf16", "traffic": "default-c32",
                           "chips": 1, "why": "search"})
    for cell in SEARCH_CELLS:
        report(m, "end_to_end", {"name": "search_qps", "unit": "requests/s", "better": "higher", "bound": 0.25,
                                 "source": "host_clock"}, cell)
        for name in ("latency_p95_ms", "lexical_ms_per_query", "query_encoder_ms_per_batch", "queries_per_launch",
                     "judge_device_ms_per_query", "score_segmax_roofline", "device_idle_share", "step_mfu"):
            report(m, "per_layer", {"name": name + ".search", "unit": "1", "better": "lower",
                                    "source": "host_clock", "layer": "search", "moves": "search_qps"}, cell)
    return m


def _run(workload, overrides, seconds, fault=None, trace=False):
    manifest = None if workload == "marco-ingest" else search_manifest()
    out, lines = runner.run(workload, SEED, seconds, trace, time.monotonic(), device=CPU, overrides=overrides,
                            fault=fault, manifest=manifest)
    json.dumps(out)
    json.dumps(lines)
    return out


@pytest.mark.parametrize("cell", SEARCH_CELLS)
@pytest.mark.parametrize("fault", [None, "answer"])
def test_search_runs(fault, cell):
    out = _run(cell, SIZES[cell], 12.0, fault)
    compared = out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert compared["short_answers"]["value"] == 0, compared  # the sampled answers came
    assert out["correct"] is (fault is None), compared
    if fault:
        assert compared["choice_gap"]["value"] > compared["choice_gap"]["limit"]
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("fault", [None, "row", "half"])
def test_ingest_runs(fault):
    out = _run("marco-ingest", INGEST, 4.0, fault)
    assert out["correct"] is (fault is None), out["compared"]
    assert out["metrics"]["ingest_chunks_per_s"]["value"] > 0


def test_traced_run_reports_its_layers():
    out = _run("covid-default", SEARCH, 12.0, trace=True)
    assert "lexical_ms_per_query.search" in out["metrics"]
    assert "search_qps" not in out["metrics"]


def test_control_fails_the_limits():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location("benchmark_control", os.path.join(runner.BENCH_DIR, "control.py"))
    control = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(control)
    cell = runner.load_cell("covid-default", search_manifest())
    for key, value in SEARCH.items():
        section, _, field = key.partition(".")
        getattr(cell, section)[field] = value
    cell.traffic["sample"], cell.traffic["max_rate"] = 4, 5
    numbers = control.search_control(cell, SEED, 4.0, CPU)
    assert any(v > cell.limits[k] for k, v in numbers.items()), numbers
    hot = runner.load_cell("marco-hot-b512", search_manifest())
    for key, value in HOT.items():
        section, _, field = key.partition(".")
        getattr(hot, section)[field] = value
    hot.traffic["sample"], hot.traffic["max_rate"] = 4, 5
    numbers = control.search_control(hot, SEED, 4.0, CPU)
    assert numbers["score_gap"] > hot.limits["score_gap"], numbers
    judged = runner.load_cell("marco-default-c32", search_manifest())
    for key, value in DEFAULT.items():
        section, _, field = key.partition(".")
        getattr(judged, section)[field] = value
    judged.traffic["sample"], judged.traffic["max_rate"] = 4, 5
    numbers = control.search_control(judged, SEED, 4.0, CPU)
    assert set(numbers) == set(judged.limits)
    assert numbers["judge_gap"] > judged.limits["judge_gap"], numbers
    assert numbers["score_gap"] > judged.limits["score_gap"], numbers
    ing = runner.load_cell("marco-ingest")
    ing.traffic["sample_rows"], ing.traffic["max_rate"] = 12, 100
    rows = control.ingest_control(ing, SEED, 4.0, CPU)
    assert rows["row_gap"] > ing.limits["row_gap"], rows
    assert rows["bm25_score_gap"] > ing.limits["bm25_score_gap"], rows
