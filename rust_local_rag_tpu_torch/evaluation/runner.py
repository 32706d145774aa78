"""Evaluation runner (port of eval_harness/runner.py on the standard
library): YAML config + JSONL ground truth -> per-query metrics, category
aggregation, JSON + markdown reports (cf. eval/eval_runner.py). The same
report schema (summary, by_category, by_difficulty, per_query) and pass
rule; the config is read by evaluation/config.py, the server reached by
evaluation/client.py.

Rejection queries (is_rejection=true) succeed when the system returns
nothing relevant — the reference counts zero results as success
(eval_runner.py:229-247); since dense search always returns *something*,
a score threshold marks results irrelevant.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from eval_harness import metrics as M
from rust_local_rag_tpu_torch.evaluation import config as yaml_subset
from rust_local_rag_tpu_torch.evaluation.client import RAGClient, matches_gold_reference

HIT_RATE_SUCCESS_THRESHOLD = 0.80  # eval/run.py:196-200
REJECTION_SUCCESS_THRESHOLD = 0.80


@dataclass
class EvalConfig:
    name: str = "default"
    description: str = ""
    rag_endpoint: str = "http://localhost:3046"
    connection_mode: str = "http"
    top_k: int = 5
    retrieval_top_k: int = 15
    page_tolerance: int = 1
    rejection_score_threshold: float = 0.3
    ground_truth_path: str = "eval_harness/ground_truth/queries.jsonl"
    # per-request search settings shipped to the server verbatim: weight
    # overrides, use_reranker, engine-level rejection_threshold
    search_params: dict = field(default_factory=dict)

    @classmethod
    def from_yaml(cls, path: str) -> "EvalConfig":
        raw = yaml_subset.load(path) or {}
        cfg = cls()
        for key in vars(cfg):
            if key in raw:
                setattr(cfg, key, raw[key])
        return cfg


@dataclass
class GroundTruthQuery:
    query_id: str
    query: str
    category: str = "general"
    difficulty: str = "medium"
    is_rejection: bool = False
    gold_references: List[dict] = field(default_factory=list)
    expected_answer_gist: str = ""
    notes: str = ""

    @classmethod
    def from_json(cls, raw: dict) -> "GroundTruthQuery":
        return cls(
            query_id=raw["query_id"],
            query=raw["query"],
            category=raw.get("category", "general"),
            difficulty=raw.get("difficulty", "medium"),
            is_rejection=bool(raw.get("is_rejection", False)),
            gold_references=list(raw.get("gold_references", [])),
            expected_answer_gist=raw.get("expected_answer_gist", ""),
            notes=raw.get("notes", ""),
        )


def load_ground_truth(path: str) -> List[GroundTruthQuery]:
    queries = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                queries.append(GroundTruthQuery.from_json(json.loads(line)))
    return queries


class EvalRunner:
    def __init__(self, config: EvalConfig, client: Optional[RAGClient] = None):
        self.config = config
        self.client = client or RAGClient(
            endpoint=config.rag_endpoint, mode=config.connection_mode
        )

    def evaluate_query(self, gt: GroundTruthQuery) -> dict:
        resp = self.client.search(
            gt.query,
            top_k=self.config.top_k,
            params=self.config.search_params or None,
        )
        results = resp.results

        if gt.is_rejection:
            # success = nothing confidently relevant returned. Blended
            # scores are per-query max-normalized (the top hit is ~1.0 by
            # construction, same as the reference), so the rejection signal
            # uses the ABSOLUTE cosine (embedding_score) when available.
            def confidence(r):
                return (
                    r.embedding_score
                    if r.embedding_score is not None
                    else r.score
                )

            relevant = [
                r for r in results
                if confidence(r) >= self.config.rejection_score_threshold
            ]
            success = len(relevant) == 0
            return {
                "query_id": gt.query_id,
                "category": gt.category,
                "difficulty": gt.difficulty,
                "is_rejection": True,
                "rejection_success": success,
                "n_returned": len(results),
                "hit_rate": 1.0 if success else 0.0,
                "mrr": 1.0 if success else 0.0,
                "ndcg": 1.0 if success else 0.0,
                "latency_ms": resp.latency_ms,
            }

        # match retrieved against gold references with page tolerance
        gold_keys = set()
        relevance_by_key: Dict[str, int] = {}
        for ref in gt.gold_references:
            key = f"{ref['document']}::{ref['page']}"
            gold_keys.add(key)
            relevance_by_key[key] = int(ref.get("relevance", 1))

        retrieved_keys: List[str] = []
        relevances: List[int] = []
        for r in results:
            matched_key = None
            for ref in gt.gold_references:
                if matches_gold_reference(
                    r, ref["document"], ref["page"], self.config.page_tolerance
                ):
                    matched_key = f"{ref['document']}::{ref['page']}"
                    break
            if matched_key is not None:
                retrieved_keys.append(matched_key)
                relevances.append(relevance_by_key[matched_key])
            else:
                retrieved_keys.append(f"__miss__::{len(retrieved_keys)}")
                relevances.append(0)

        k = self.config.top_k
        return {
            "query_id": gt.query_id,
            "category": gt.category,
            "difficulty": gt.difficulty,
            "is_rejection": False,
            "hit_rate": M.hit_rate_at_k(gold_keys, retrieved_keys, k),
            "mrr": M.mrr_at_k(gold_keys, retrieved_keys, k),
            "ndcg": M.ndcg_at_k(relevances, k),
            "precision": M.precision_at_k(gold_keys, retrieved_keys, k),
            "context_precision": M.context_precision(relevances),
            "latency_ms": resp.latency_ms,
        }

    def run_evaluation(self, queries: List[GroundTruthQuery]) -> dict:
        started = time.time()
        per_query = [self.evaluate_query(q) for q in queries]

        retrieval = [r for r in per_query if not r["is_rejection"]]
        rejection = [r for r in per_query if r["is_rejection"]]

        by_category: Dict[str, List[dict]] = {}
        by_difficulty: Dict[str, List[dict]] = {}
        for r in retrieval:
            by_category.setdefault(r["category"], []).append(r)
            by_difficulty.setdefault(r.get("difficulty", "medium"), []).append(r)

        summary = M.aggregate_metrics(retrieval)
        summary["rejection_success_rate"] = (
            sum(1 for r in rejection if r.get("rejection_success"))
            / len(rejection)
            if rejection
            else None
        )
        # the gate covers BOTH halves of retrieval quality: finding what IS
        # there (hit rate) and refusing what is NOT (rejection) — the
        # reference's banner checks hit rate only (eval/run.py:196-200)
        hit_ok = summary.get("hit_rate_mean", 0.0) >= HIT_RATE_SUCCESS_THRESHOLD
        rej = summary["rejection_success_rate"]
        rej_ok = rej is None or rej >= REJECTION_SUCCESS_THRESHOLD
        summary["passed"] = hit_ok and rej_ok
        return {
            "config": self.config.name,
            "search_params": self.config.search_params,
            "started_at": started,
            "duration_s": time.time() - started,
            "summary": summary,
            "by_category": {
                cat: M.aggregate_metrics(rows)
                for cat, rows in sorted(by_category.items())
            },
            "by_difficulty": {
                d: M.aggregate_metrics(rows)
                for d, rows in sorted(by_difficulty.items())
            },
            "per_query": per_query,
        }


def write_reports(report: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    json_path = os.path.join(out_dir, f"eval_{report['config']}_{stamp}.json")
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)

    s = report["summary"]
    md = [
        f"# Evaluation report — {report['config']}",
        "",
        f"- queries: {s.get('n_queries', 0)} retrieval"
        + (
            f", rejection success {s['rejection_success_rate']:.0%}"
            if s.get("rejection_success_rate") is not None
            else ""
        ),
        f"- **Hit Rate@k: {s.get('hit_rate_mean', 0):.3f}**"
        f" ({'PASS' if s.get('passed') else 'FAIL'} at the "
        f"{HIT_RATE_SUCCESS_THRESHOLD} threshold)",
        f"- MRR: {s.get('mrr_mean', 0):.3f}   NDCG: {s.get('ndcg_mean', 0):.3f}",
        f"- latency p50/p95/p99 ms: {s.get('latency_p50_ms', 0):.1f} / "
        f"{s.get('latency_p95_ms', 0):.1f} / {s.get('latency_p99_ms', 0):.1f}",
        "",
        "## By difficulty",
    ]
    for d, agg in report.get("by_difficulty", {}).items():
        md.append(
            f"- {d}: hit {agg['hit_rate_mean']:.2f} mrr {agg['mrr_mean']:.2f} "
            f"(n={agg['n_queries']})"
        )
    md.append("")
    md.append("## By category")
    for cat, agg in report["by_category"].items():
        md.append(
            f"- {cat}: hit {agg['hit_rate_mean']:.2f} mrr {agg['mrr_mean']:.2f} "
            f"(n={agg['n_queries']})"
        )
    md_path = os.path.join(out_dir, f"eval_{report['config']}_{stamp}.md")
    with open(md_path, "w", encoding="utf-8") as f:
        f.write("\n".join(md) + "\n")
