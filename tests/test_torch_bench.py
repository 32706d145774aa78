"""The ports of bench.py and scripts/bench_server.py
(rust_local_rag_tpu_torch/bench.py, bench_server.py) at a small N on the
CPU (device="cpu": the kernels' plain versions): each timed loop's last
top-k equals torch.topk of the plain score plane of the same queries, the
steps are chained (each step's queries depend on the previous result), and
each program prints one JSON line with the fields it documents."""

import json

import pytest
import torch

from rust_local_rag_tpu_torch import bench, bench_server
from rust_local_rag_tpu_torch.ops.score_segmax import fused_score_segmax_plain, segmented_topk
from rust_local_rag_tpu_torch.utils.profiling import StepTimer

N, D, K = 65536, 64, 10


@pytest.fixture(scope="module")
def corpus():
    gen = torch.Generator().manual_seed(0)
    return bench.unit_rows(gen, (N, D), torch.device("cpu"), torch.bfloat16)


def test_chain_carries_each_result_into_the_next_step(corpus):
    gen = torch.Generator().manual_seed(1)
    qall = bench.unit_rows(gen, (3, 8, D), torch.device("cpu"), torch.bfloat16)
    seen = []

    def step(qs):
        seen.append(qs.clone())
        return segmented_topk(qs, corpus, K)

    qs, vals, idx = bench.chain(step, qall)
    assert len(seen) == 3 and torch.equal(seen[0], qall[0])
    # step 2's queries are step 1's result's sum scaled into the queries
    carry = segmented_topk(seen[1], corpus, K)[0].sum()
    assert torch.equal(seen[2], (qall[2].float() + carry * 1e-6).to(torch.bfloat16))
    want_v, want_i = torch.topk(fused_score_segmax_plain(qs, corpus)[0], K, dim=1)
    assert torch.equal(vals, want_v) and torch.equal(idx.long(), want_i)


@pytest.mark.parametrize("dtype,q", [(torch.bfloat16, 8), (torch.bfloat16, 32), (torch.float32, 8)])
def test_topk_lines_equal_torch_topk(corpus, dtype, q):
    gen = torch.Generator().manual_seed(q)
    qall = bench.unit_rows(gen, (2, q, D), torch.device("cpu"), dtype)
    lines = bench.topk_lines(corpus.to(dtype), qall, K, torch.device("cpu"))
    assert set(lines) == {"segmented_topk", "hybrid_topk_packed", "library_mm_topk"}
    for row in lines.values():
        assert row["max_abs_err"] == 0.0 and row["same_index_share"] == 1.0
        assert row["ms_per_step"] > 0 and row["qps"] > 0


def test_bench_prints_one_json_line(capsys):
    assert bench.main(["--n", "65536", "--d", "32", "--q", "4", "--q-big", "8", "--k", "5", "--steps", "2",
                       "--device", "cpu", "--ingest-batch", "4", "--ingest-len", "16", "--ingest-docs", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    res = json.loads(out[0])
    assert res["n"] == 65536 and res["query_batch"] == 8 and res["steps"] == 2 and res["device"] == "cpu"
    for shape in ("bf16_q128", "bf16_q512", "f32_q128"):
        for row in res["lines"][shape].values():
            assert row["max_abs_err"] == 0.0 and row["same_index_share"] == 1.0
    assert res["approx99_per_chip_qps"] is None and res["approx99_reason"]
    assert res["projected_v5e8_qps"] is None and res["projected_reason"]
    full = res["ingest_full_pipeline"]
    assert res["ingest_chunks_per_s_per_chip"] > 0 and full["n_chunks"] > 0 and full["n_documents"] == 2
    assert full["roofline_chunks_per_s_at_peak_bf16"] is None  # no card roofline for a CPU run
    assert full["tokenizer"] == "NativeWordPieceTokenizer"


def test_bench_refuses_a_ragged_n():
    with pytest.raises(ValueError, match="16,384"):
        bench.run(n=65537, device="cpu", ingest=False)


@pytest.mark.parametrize("n", [1, 2, 7, 100])
def test_percentiles_are_the_step_timers(n):
    xs = [float((i * 37) % 101) for i in range(n)]
    t = StepTimer()
    for x in xs:
        t.record_ms(x)
    s = t.stats()
    assert bench_server.pct(xs, 0.99) == s.p99_ms and bench_server.pct(xs, 0.95) == s.p95_ms


def test_zipf_texts_and_queries_are_seeded():
    assert bench_server.zipf_texts(3) == bench_server.zipf_texts(3)
    assert bench_server.zipf_queries(3)[0].startswith("find passage term")
    assert len(set(bench_server.zipf_queries(50))) == 50


def test_bench_server_prints_one_json_line(capsys, monkeypatch):
    monkeypatch.setattr(bench_server, "MMR_PIPELINED", (8,))  # 512 queries of MMR would add minutes on the CPU
    assert bench_server.main(["--n", "16384", "--k", "5", "--clients", "2", "4", "--seconds", "1", "--batch-max",
                              "4", "--pipelined", "8", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    res = json.loads(out[0])
    assert res["n_chunks"] == 16384 and res["device"] == "cpu" and res["client_cores"] >= 1
    assert set(res["client_sweep"]) == {"clients2", "clients4"}
    for lane in [*res["client_sweep"].values(), res["judged_http"]]:
        assert lane["requests"] > 0 and lane["non_200"] == 0
        split = lane["server_split"]
        assert split["requests_submitted"] >= lane["requests"]
        assert split["search_p50_ms"] > 0 and split["wait_p50_ms"] is not None and split["write_p50_ms"] is not None
    assert res["engine_pipelined8_top5_qps"] > 0 and res["engine_pipelined16_top5_qps"] > 0
    assert res["engine_judged_pipelined8_top5_qps"] > 0
    # scripts/bench_server.py's object-lane, MMR and rerank-on engine lines,
    # each with its launches (none on the CPU: the wrappers take the plain path)
    lines = ["engine_batch8_top5_qps", "engine_batch16_top5_qps", "engine_pipelined8_top5_qps",
             "engine_pipelined16_top5_qps", "engine_mmr_pipelined8_top5_qps", "engine_rerank_on_top5_qps",
             "engine_judged_pipelined8_top5_qps"]
    assert all(res[k] > 0 for k in lines)
    assert res["engine_launches"] == {k: {"score_segmax_masked": 0, "fused_attention": 0} for k in lines}


def test_launch_counts_attribute_launches_to_each_line():
    """bench_server.LaunchCounts reads the wrappers' counters before and
    after each engine line and never resets them."""
    from rust_local_rag_tpu_torch.ops.attention import fused_attention
    from rust_local_rag_tpu_torch.ops.score_segmax import score_segmax

    saved = score_segmax.launches, fused_attention.launches
    try:
        counts = bench_server.LaunchCounts()
        with counts.line("object"):
            score_segmax.launches += 2
        with counts.line("rerank_on"):
            score_segmax.launches += 1
            fused_attention.launches += 12
        with pytest.raises(RuntimeError), counts.line("failed"):
            score_segmax.launches += 1
            raise RuntimeError("a line that raises still records its launches")
        assert counts.lines == {"object": {"score_segmax_masked": 2, "fused_attention": 0},
                                "rerank_on": {"score_segmax_masked": 1, "fused_attention": 12},
                                "failed": {"score_segmax_masked": 1, "fused_attention": 0}}
        assert (score_segmax.launches, fused_attention.launches) == (saved[0] + 4, saved[1] + 12)
    finally:
        score_segmax.launches, fused_attention.launches = saved
