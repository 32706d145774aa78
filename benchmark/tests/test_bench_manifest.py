"""BENCHMARK.json against the contract's shape, and the harness finding a
cell's parts by name, so that a later configuration, traffic mix, metric
or cell is new files plus new entries."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from harness import runner

ROOT = runner.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def test_top_level_keys(manifest):
    assert set(manifest) == TOP
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    cells = len(manifest["workloads"])
    # a full check at 24 cells: (2 + 14 x 24) runs of run_seconds + 60, 2 x 90 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_entry_keys(manifest):
    names = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for kind, keys in (("end_to_end", {"name", "unit", "better", "bound", "source"}),
                       ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for m in manifest[kind]:
            assert set(m) - {"workloads"} == keys
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["name"] not in names
            names.add(m["name"])
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert len({w["name"] for w in manifest["workloads"]}) == len(manifest["workloads"])
    assert len({(w["config"], w["traffic"]) for w in manifest["workloads"]}) == len(manifest["workloads"])


def test_every_cell_reports_what_it_needs(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for w in manifest["workloads"]:
        cell = w["name"]
        mine = [m["name"] for m in manifest["end_to_end"] if runner._applies(m, cell)]
        assert "setup_s" in mine and len(mine) >= 2
        layers = [m for m in manifest["per_layer"] if runner._applies(m, cell)]
        assert layers
        for m in layers:
            assert m["moves"] in e2e and runner._applies(e2e[m["moves"]], cell)


def test_every_part_is_found_by_name(manifest):
    for w in manifest["workloads"]:
        cell = runner.load_cell(w["name"], manifest)
        assert cell.config["name"] == w["config"]
        assert os.path.exists(os.path.join(runner.BENCH_DIR, "drivers", cell.traffic["driver"] + ".py"))
        for m in cell.end_to_end + cell.per_layer:
            assert callable(m.module.read)
        assert cell.limits


def test_configuration_files_state_their_cuts(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["assumed"]
        for key in cfg["reduced"]:
            assert key in cfg["corpus"] and key in cfg["published"]


FIXTURE_JUDGE = '''"""A later judge: the weights beside this file, through the committed
judge's arithmetic."""
import os

from reference.judge_tpu_reranker import Judge


def load(device):
    return Judge(os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixture_judge.safetensors"), device)
'''

RUN_IN_COPY = """
import json, sys, time
sys.path[:0] = [sys.argv[1] + "/benchmark", sys.argv[1]]
import torch
from harness import runner
out, _ = runner.run(sys.argv[2], int(sys.argv[3]), 12.0, False, time.monotonic(), device=torch.device("cpu"),
                    overrides=json.loads(sys.argv[4]))
print(json.dumps(out))
"""


def _fixture_judge(path) -> None:
    """A small judge of random weights, in the file format the program and
    the reference read: unlike the committed judge in every answer."""
    import torch

    from rust_local_rag_tpu_torch.models.checkpoint import save_params
    from rust_local_rag_tpu_torch.models.reranker import Reranker, RerankerConfig

    cfg = RerankerConfig(vocab_size=8193, dim=64, depth=1, heads=2, ffn_dim=128)
    save_params(Reranker(cfg, torch.Generator().manual_seed(7)), str(path),
                {"reranker_config": cfg.to_json(), "train_seq_len": "96"})


def test_a_later_cell_is_files_and_entries(manifest, tmp_path):
    """A copy of the benchmark with one new configuration, which names a new
    judge (its reference module and its weights), traffic mix, metrics
    and cells, made by adding files and entries only; the judged cell then
    runs in the copy, correct, with both sides serving the new judge."""
    from test_bench_runs import SEARCH, SEED

    root = tmp_path / "checkout"
    shutil.copytree(runner.BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "trec-covid-f32.json").read_text())
    cfg["name"] = "nq-f32"
    cfg["judge"] = {"model": "fixture-judge", "weights": "benchmark/reference/fixture_judge.safetensors",
                    "reference": "judge_fixture"}
    (bench / "configs" / "nq-f32.json").write_text(json.dumps(cfg))
    (bench / "reference" / "judge_fixture.py").write_text(FIXTURE_JUDGE)
    _fixture_judge(bench / "reference" / "fixture_judge.safetensors")
    (bench / "limits" / "nq-default.json").write_text(json.dumps(
        {"limits": {"score_gap": 0.002, "judge_gap": 0.007, "blend_gap": 0.002, "choice_gap": 0.008,
                    "short_answers": 0, "failed_requests": 0}}))
    (bench / "traffic" / "hot-c16.json").write_text(json.dumps(
        {"driver": "http_closed_loop", "clients": 16, "body": {"top_k": 10, "diversity_factor": 0.0,
                                                             "use_reranker": False},
         "max_rate": 100, "sample": 4}))
    (bench / "metrics" / "served_requests.search.py").write_text("def read(rec):\n    return rec.completed\n")
    (bench / "limits" / "nq-hot.json").write_text(json.dumps({"limits": {"score_gap": 1, "choice_gap": 1}}))
    m = json.loads(json.dumps(manifest))
    m["configs"].append({"name": "nq-f32", "source": "https://arxiv.org/abs/2104.08663",
                         "file": "benchmark/configs/nq-f32.json", "reduced": [], "why": "fixture"})
    for name in ("nq-hot", "nq-default"):
        m["workloads"].append({"name": name, "config": "nq-f32", "traffic": "hot-c16" if name == "nq-hot"
                               else "default-c32", "chips": 1, "why": "fixture"})
    m["per_layer"].append({"name": "served_requests.search", "unit": "requests", "better": "higher",
                           "source": "host_clock", "layer": "server/batcher", "moves": "search_qps",
                           "workloads": ["nq-hot", "nq-default"]})
    m["end_to_end"].append({"name": "search_qps", "unit": "requests/s", "better": "higher", "bound": 0.25,
                            "source": "host_clock", "workloads": ["nq-hot", "nq-default"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = runner.load_cell("nq-hot", bench_dir=str(bench))
    assert cell.config["name"] == "nq-f32" and cell.traffic["clients"] == 16
    assert [x.name for x in cell.per_layer] == ["served_requests.search"]
    assert {x.name for x in cell.end_to_end} == {"search_qps", "setup_s"}
    old = runner.load_cell("marco-ingest", bench_dir=str(bench))
    assert "served_requests.search" not in [x.name for x in old.per_layer]
    for name in ("rust_local_rag_tpu_torch", "rust_local_rag_tpu", "prompts"):  # the rest of a checkout
        (root / name).symlink_to(os.path.join(ROOT, name))
    done = subprocess.run([sys.executable, "-c", RUN_IN_COPY, str(root), "nq-default", str(SEED), json.dumps(SEARCH)],
                          cwd=root, capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["checks"]["judge_forwards"], out["compared"]
    assert out["compared"]["judge_gap"]["value"] <= out["compared"]["judge_gap"]["limit"]
    after = {p: p.read_bytes() for p in before}
    assert after == before
