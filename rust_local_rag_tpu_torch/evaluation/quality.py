"""One-shot quality evaluation of the port (port of scripts/quality_eval.py):
corpus -> `python -m rust_local_rag_tpu_torch` -> the eval configs.

    python -m rust_local_rag_tpu_torch.evaluation.quality [--heldout] [--thirdparty] --out DIR [--device cpu]

In order: the eval corpus is generated (eval_harness.corpus); the port's
server starts on the card (--device cpu: RAG_TPU_PLATFORM=cpu) with the
committed encoder and judge (RAG_TPU_RERANK_MODEL=tpu-reranker); POST
/reindex; the configs baseline, embedding_only and bm25_only are
evaluated (with --heldout also baseline_heldout, with --thirdparty also
baseline_thirdparty after the third-party documents are indexed); the
reports go to --out, never into eval_harness/reports/. Each config's
summary is printed as one JSON line with the lane its body takes and,
query by query, every row whose hit_rate or mrr differs from the JAX
package's committed round-5 report of that config.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

from rust_local_rag_tpu_torch.evaluation.client import RAGClient
from rust_local_rag_tpu_torch.evaluation.runner import EvalConfig, EvalRunner, load_ground_truth, write_reports

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG_DIR = os.path.join(ROOT, "eval_harness", "configs")
# the JAX package's round-5 reports (eval_harness/reports/)
REFERENCE_REPORTS = {
    "baseline": "eval_baseline_20260821_025115.json",
    "baseline_heldout": "eval_baseline_heldout_20260821_025215.json",
    "embedding_only": "eval_embedding_only_20260821_025133.json",
    "bm25_only": "eval_bm25_only_20260821_025140.json",
    "baseline_thirdparty": "eval_baseline_thirdparty_20260821_025351.json",
}
# the server's environment for quality: the committed models, never the
# hermetic ones a caller's environment may name
HERMETIC_ENV = ("RAG_TPU_FAKE_ENCODER", "RAG_TPU_FAKE_RERANKER", "RAG_TPU_NO_DEFAULT_ASSETS")
READY_TIMEOUT_S = 900  # a first start on the card builds every kernel
SUMMARY_KEYS = ("n_queries", "hit_rate_mean", "mrr_mean", "ndcg_mean", "rejection_success_rate", "passed",
                "latency_p50_ms", "latency_p95_ms")


def lane_of(params: dict) -> str:
    """The batcher lane a /search body with these parameters takes on a
    server with a reranker (server/batcher.py: the body's defaults are
    diversity_factor 0.3 and use_reranker true)."""
    diversity = float(params.get("diversity_factor", 0.3))
    if not params.get("use_reranker", True):
        return "hot" if diversity == 0 else "mmr_hot"
    weights = params.get("weights") or {}
    if diversity == 0 and weights.get("reranker") == 0:
        return "judged"
    return "object" + (" (MMR)" if diversity > 0 else "")


def compare(report: dict, reference: dict) -> List[dict]:
    """Every query whose hit_rate or mrr differs from the reference's row
    (or that only one of the two holds)."""
    ref = {r["query_id"]: r for r in reference["per_query"]}
    got = {r["query_id"]: r for r in report["per_query"]}
    out = []
    for qid in sorted(set(ref) | set(got)):
        a, b = got.get(qid), ref.get(qid)
        key = lambda r: None if r is None else (r["hit_rate"], r["mrr"])  # noqa: E731
        if key(a) != key(b):
            out.append({"query_id": qid, "is_rejection": (a or b)["is_rejection"],
                        "port": None if a is None else {"hit_rate": a["hit_rate"], "mrr": a["mrr"]},
                        "jax": None if b is None else {"hit_rate": b["hit_rate"], "mrr": b["mrr"]}})
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 40) -> str:
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return ""


def reindex(client: RAGClient, timeout: float = 1800) -> dict:
    """POST /reindex, then /jobs/active until null; the /stats after."""
    client.request_json("POST", "/reindex", timeout=30)
    deadline = time.monotonic() + timeout
    while client.request_json("GET", "/jobs/active", timeout=30) is not None:
        if time.monotonic() > deadline:
            raise RuntimeError(f"the reindex did not finish in {timeout} s")
        time.sleep(0.5)
    return client.get_stats()


def evaluate(name: str, endpoint: str, ground_truth: str, out_dir: str) -> dict:
    """eval_harness.run's evaluate: one config's report, written to out_dir."""
    return evaluate_config(EvalConfig.from_yaml(os.path.join(CONFIG_DIR, f"{name}.yaml")), endpoint, ground_truth,
                           out_dir)


def evaluate_config(cfg: EvalConfig, endpoint: str, ground_truth: str, out_dir: str) -> dict:
    """One config's report against the server at `endpoint`, written to
    out_dir."""
    cfg.rag_endpoint, cfg.ground_truth_path = endpoint, ground_truth
    client = RAGClient(endpoint=cfg.rag_endpoint, mode=cfg.connection_mode)
    try:
        if not client.health_check():
            raise RuntimeError(f"server at {endpoint} is not ready")
        report = EvalRunner(cfg, client).run_evaluation(load_ground_truth(cfg.ground_truth_path))
    finally:
        client.close()
    write_reports(report, out_dir)
    return report


@contextlib.contextmanager
def corpus_server(docs: str, data: str, logs: str, device: str = "cuda", clear_env=(), log=print,
                  env: Optional[dict] = None):
    """`python -m rust_local_rag_tpu_torch` over `docs` with the current
    environment (and `env`, less the keys of `clear_env`), the judge named
    tpu-reranker, on the card (device "cpu": RAG_TPU_PLATFORM=cpu): yields
    (base_url, client, {"ready_s", "reindex_s", "stats"}) once it is ready
    and POST /reindex has finished; the server is stopped afterwards."""
    port = _free_port()
    senv = dict(os.environ)
    senv.update(DATA_DIR=data, DOCUMENTS_DIR=docs, LOG_DIR=logs, MCP_HTTP_BIND=f"127.0.0.1:{port}",
                RAG_TPU_RERANK_MODEL="tpu-reranker",
                PYTHONPATH=os.pathsep.join(p for p in (ROOT, senv.get("PYTHONPATH")) if p), **(env or {}))
    for k in clear_env:
        senv.pop(k, None)
    if device == "cpu":
        senv["RAG_TPU_PLATFORM"] = "cpu"
    else:
        senv.pop("RAG_TPU_PLATFORM", None)
    base = f"http://127.0.0.1:{port}"
    os.makedirs(logs, exist_ok=True)
    out_path = os.path.join(logs, "server.out")
    with open(out_path, "w") as out_f:
        srv = subprocess.Popen([sys.executable, "-m", "rust_local_rag_tpu_torch"], env=senv, cwd=ROOT,
                               stdout=out_f, stderr=subprocess.STDOUT)
    client = RAGClient(base)
    try:
        t0 = time.monotonic()
        while not client.health_check():
            if srv.poll() is not None:
                raise RuntimeError(f"server died (exit {srv.returncode}):\n{_tail(out_path)}")
            if time.monotonic() - t0 > READY_TIMEOUT_S:
                raise RuntimeError(f"server never became ready:\n{_tail(out_path)}")
            time.sleep(0.5)
        ready_s = time.monotonic() - t0
        t0 = time.monotonic()
        stats = reindex(client)
        started = {"ready_s": ready_s, "reindex_s": time.monotonic() - t0, "stats": stats}
        log(json.dumps({"quality_server": started}))
        yield base, client, started
    finally:
        client.close()
        srv.terminate()
        try:
            srv.wait(timeout=30)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()


def run_quality(out_dir: str, heldout: bool = False, thirdparty: bool = False, device: str = "cuda",
                log=print, after=None) -> dict:
    """The whole evaluation; returns {config: {"lane", "summary",
    "reference", "jax_summary", "diffs"}} and the server's /stats.
    `after(base_url, ground_truth, results)`, when given, runs once every
    config is evaluated, while the server still serves."""
    from eval_harness.corpus import generate_corpus, generate_ground_truth

    out_dir = os.path.abspath(out_dir)
    work = tempfile.mkdtemp(prefix="quality_eval_")
    docs, data, logs = (os.path.join(work, d) for d in ("documents", "data", "logs"))
    try:
        names = generate_corpus(docs)
        gt = {"dev": os.path.join(work, "queries.jsonl")}
        nq = generate_ground_truth(gt["dev"])
        log(f"{len(names)} PDFs, {nq} queries -> {work}")
        runs = [("baseline", "dev"), ("embedding_only", "dev"), ("bm25_only", "dev")]
        if heldout:
            gt["test"] = os.path.join(work, "queries_heldout.jsonl")
            log(f"+ {generate_ground_truth(gt['test'], split='test')} held-out test-split queries")
            runs.append(("baseline_heldout", "test"))
        with corpus_server(docs, data, logs, device, clear_env=HERMETIC_ENV, log=log) as (base, client, started):
            stats = started["stats"]
            results = {}
            for name, split in runs:
                results[name] = _one(name, base, gt[split], out_dir, log)
            if thirdparty:
                # the third-party documents join the live corpus (the authored
                # ones hash-skip on the incremental reindex)
                from eval_harness.thirdparty import generate_thirdparty_corpus, generate_thirdparty_ground_truth

                tp_names = generate_thirdparty_corpus(docs)
                gt["thirdparty"] = os.path.join(work, "queries_thirdparty.jsonl")
                ntp = generate_thirdparty_ground_truth(gt["thirdparty"])
                log(f"+ {len(tp_names)} third-party PDFs, {ntp} queries; reindexing...")
                stats = reindex(client)
                results["baseline_thirdparty"] = _one("baseline_thirdparty", base, gt["thirdparty"], out_dir, log)
            if after is not None:
                after(base, gt["dev"], results)
            return {"configs": results, "stats": stats, "ready_s": started["ready_s"],
                    "reindex_s": started["reindex_s"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _one(name: str, base: str, ground_truth: str, out_dir: str, log) -> dict:
    report = evaluate(name, base, ground_truth, out_dir)
    ref_path = os.path.join(ROOT, "eval_harness", "reports", REFERENCE_REPORTS[name])
    with open(ref_path, encoding="utf-8") as f:
        reference = json.load(f)
    row = {"lane": lane_of(report["search_params"] or {}),
           "summary": {k: report["summary"].get(k) for k in SUMMARY_KEYS},
           "reference": os.path.relpath(ref_path, ROOT),
           "jax_summary": {k: reference["summary"].get(k) for k in SUMMARY_KEYS},
           "diffs": compare(report, reference)}
    log(json.dumps({"quality": name, **row, "differing_queries": len(row["diffs"])}))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heldout", action="store_true",
                    help="also run the held-out test split (baseline_heldout; report-only, never tuned on)")
    ap.add_argument("--thirdparty", action="store_true",
                    help="also index the third-party documents and run baseline_thirdparty (report-only)")
    ap.add_argument("--out", required=True, help="directory for the JSON and markdown reports")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    res = run_quality(args.out, args.heldout, args.thirdparty, args.device)
    print(json.dumps({cfg: ("PASS" if r["summary"]["passed"] else "FAIL") for cfg, r in res["configs"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
