"""The port's evaluation CLI (rust_local_rag_tpu_torch/evaluation/run.py)
against eval_harness/run.py (requests, yaml, rich) on the CPU.

* list-configs prints what the harness prints;
* generate writes the same PDFs and ground truth, byte for byte, for the
  dev and test splits;
* check and evaluate against one in-process port server (hermetic models,
  three documents and a ground truth of their own): the same exit codes,
  check's same lines, and evaluate's same report (latencies aside);
* a server that is not there: check exits 1 and evaluate 2 in both.
"""

import glob
import json
import os

import pytest

from eval_harness import run as jrun
from rust_local_rag_tpu_torch.evaluation import run as trun
from test_torch_tui import _dead_port, _wait_job, server  # noqa: F401  (server is a fixture)
from rust_local_rag_tpu_torch.tui.api import ApiClient

GROUND_TRUTH = [
    {"query_id": "Q001", "query": "telescopes observe distant galaxies", "category": "science", "difficulty": "easy",
     "is_rejection": False, "gold_references": [{"document": "astronomy.pdf", "page": 1, "relevance": 3}]},
    {"query_id": "Q002", "query": "mulch keeps the soil moist", "category": "garden", "difficulty": "medium",
     "is_rejection": False, "gold_references": [{"document": "garden.pdf", "page": 2, "relevance": 3}]},
    {"query_id": "Q003", "query": "braising tough cuts of meat", "category": "food", "difficulty": "hard",
     "is_rejection": False, "gold_references": [{"document": "kitchen.pdf", "page": 1, "relevance": 3}]},
    {"query_id": "Q004", "query": "quantum chromodynamics on a lattice", "category": "rejection",
     "difficulty": "hard", "is_rejection": True, "gold_references": []},
]


def _run(main, argv, capsys):
    code = main(argv)
    return code, capsys.readouterr().out


def test_list_configs_equal_jax(capsys):
    got = _run(trun.main, ["list-configs"], capsys)
    want = _run(jrun.main, ["list-configs"], capsys)
    assert got == want and got[0] == 0
    assert got[1].splitlines()[0].startswith("baseline.yaml: baseline — ")
    assert len(got[1].splitlines()) == len(glob.glob(os.path.join(trun.CONFIG_DIR, "*.yaml")))


@pytest.mark.parametrize("split", ["dev", "test"])
def test_generate_writes_the_harness_files(split, tmp_path, capsys):
    out = {}
    for name, main in (("port", trun.main), ("jax", jrun.main)):
        d = tmp_path / name
        code, text = _run(main, ["generate", "--documents", str(d / "docs"), "--ground-truth",
                                 str(d / "gt" / "q.jsonl"), "--split", split], capsys)
        assert code == 0
        out[name] = text.replace(str(d), "<dir>")
    assert out["port"] == out["jax"]
    files = sorted(os.path.relpath(p, tmp_path / "jax") for p in glob.glob(str(tmp_path / "jax" / "**" / "*"),
                                                                          recursive=True) if os.path.isfile(p))
    assert len(files) == 77  # 76 PDFs and the ground truth
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def _config(tmp_path, url, name="cli"):
    gt = tmp_path / "gt.jsonl"
    gt.write_text("".join(json.dumps(r) + "\n" for r in GROUND_TRUTH))
    cfg = tmp_path / f"{name}.yaml"
    cfg.write_text(f'name: "{name}"\ndescription: "CLI parity"\nrag_endpoint: "{url}"\ntop_k: 3\n'
                   f'page_tolerance: 0\nrejection_score_threshold: 0.9\nground_truth_path: "{gt}"\n'
                   "search_params:\n  use_reranker: false\n  diversity_factor: 0.0\n")
    return str(cfg)


def test_check_and_evaluate_against_the_port_server(server, tmp_path, capsys):  # noqa: F811
    c = ApiClient(server.url)
    _wait_job(c, c.start_reindex().job_id)
    cfg = _config(tmp_path, server.url)
    got = _run(trun.main, ["check", "--config", cfg], capsys)
    want = _run(jrun.main, ["check", "--config", cfg], capsys)
    assert got == want and got[0] == 0
    assert got[1].splitlines()[0] == "server ready: True"
    assert got[1].splitlines()[-1] == "ground truth: 4 queries (3 retrieval, 1 rejection)"

    reports = {}
    for name, main in (("port", trun.main), ("jax", jrun.main)):
        code, text = _run(main, ["evaluate", "--config", cfg, "--out", str(tmp_path / name)], capsys)
        (path,) = glob.glob(str(tmp_path / name / "eval_cli_*.json"))
        with open(path) as f:
            report = json.load(f)
        assert code == (0 if report["summary"]["passed"] else 1)
        assert glob.glob(str(tmp_path / name / "eval_cli_*.md"))
        reports[name] = (code, report, text)
    (pcode, port, ptext), (jcode, jax, _) = reports["port"], reports["jax"]
    assert ptext == str(port["summary"]) + "\n"  # plain text, the harness's form without rich
    assert pcode == jcode

    def strip(report):
        out = json.loads(json.dumps(report))
        for k in list(out["summary"]):
            if k.startswith("latency"):
                del out["summary"][k]
        for row in out["per_query"]:
            row.pop("latency_ms", None)
        for group in ("by_category", "by_difficulty"):
            for agg in out.get(group, {}).values():
                for k in [k for k in agg if k.startswith("latency")]:
                    del agg[k]
        for k in ("started_at", "duration_s"):
            del out[k]
        return out

    assert strip(port) == strip(jax)
    assert port["summary"]["n_queries"] == 3


def test_no_server_exit_codes_equal_jax(tmp_path, capsys):
    cfg = _config(tmp_path, f"http://127.0.0.1:{_dead_port()}")
    got = _run(trun.main, ["check", "--config", cfg], capsys)
    want = _run(jrun.main, ["check", "--config", cfg], capsys)
    assert got == want and got[0] == 1 and got[1].startswith("server ready: False")
    assert trun.main(["evaluate", "--config", cfg, "--out", str(tmp_path / "p")]) == 2
    assert jrun.main(["evaluate", "--config", cfg, "--out", str(tmp_path / "j")]) == 2
    assert "is not ready" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "p")
