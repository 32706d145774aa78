"""Shared harness of the live sweeps (port of scripts/sweep_common.py): boot
one port server with the current environment over the authored eval
corpus, evaluate parameterised baseline points against it, tear it down.
The sweep modules supply only their point lists.

The server is evaluation/quality.corpus_server (`python -m
rust_local_rag_tpu_torch`, the judge named tpu-reranker, DEV=1); each
point is baseline.yaml read by evaluation/config.py with its
search_params updated, run by evaluation/runner.py. ENCODER_WEIGHTS /
RERANKER_WEIGHTS in the environment reach the server, so a staged
checkpoint is calibrated as it will serve. SWEEP_KEEP=1 keeps the work
directory (per-query reports) after the run.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import tempfile
from typing import Dict, List, Tuple

from rust_local_rag_tpu_torch.device import resolve_device
from rust_local_rag_tpu_torch.evaluation.quality import CONFIG_DIR, corpus_server, evaluate_config
from rust_local_rag_tpu_torch.evaluation.runner import EvalConfig

BASELINE = os.path.join(CONFIG_DIR, "baseline.yaml")


@contextlib.contextmanager
def eval_server(prefix: str = "sweep_", device: str = "cuda"):
    """The port's server (current environment) over the eval corpus on
    `device`; yields (base_url, ground_truth_path, work_dir) once indexed."""
    from eval_harness import corpus

    work = tempfile.mkdtemp(prefix=prefix)
    docs, data, logs = (os.path.join(work, d) for d in ("documents", "data", "logs"))
    for d in (docs, data, logs):
        os.makedirs(d)
    try:
        corpus.generate_corpus(docs)
        gt = os.path.join(work, "queries.jsonl")
        corpus.generate_ground_truth(gt)
        with corpus_server(docs, data, logs, device, env={"DEV": "1"}, log=lambda _: None) as (base, _, started):
            print("indexed:", started["stats"], flush=True)
            yield base, gt, work
    finally:
        if os.environ.get("SWEEP_KEEP"):
            print(f"reports kept in {work}")
        else:
            shutil.rmtree(work, ignore_errors=True)


def point_config(name: str, search_params: dict) -> EvalConfig:
    """baseline.yaml named `name`, its search_params updated with these."""
    cfg = EvalConfig.from_yaml(BASELINE)
    cfg.name = name
    cfg.search_params = {**(cfg.search_params or {}), **search_params}
    return cfg


def summary_of(report: dict) -> Dict[str, float]:
    s = report["summary"]
    return {"hit": round(s["hit_rate_mean"], 3), "mrr": round(s["mrr_mean"], 3),
            "rej": round(s["rejection_success_rate"], 3)}


def run_points(base: str, gt: str, work: str, points: List[Tuple[str, dict]]) -> dict:
    """Evaluate each (name, search_params update) point against the live
    server; returns {name: {"hit", "mrr", "rej"}} and prints one line a
    point."""
    out_dir = os.path.join(work, "reports")
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for name, sp in points:
        results[name] = summary_of(evaluate_config(point_config(name, sp), base, gt, out_dir))
        print(f"{name}: {results[name]}", flush=True)
    return results


def parse(argv, doc: str, *lists: str):
    """(the positional comma-separated lists, each None when absent, the
    --device name) of a sweep's command line; a card that is asked for and
    missing raises here, before any work."""
    ap = argparse.ArgumentParser(description=doc)
    for name in lists:
        ap.add_argument(name, nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    resolve_device(args.device)
    return [getattr(args, name) for name in lists], args.device


def floats(arg, default) -> List[float]:
    """A comma-separated list of floats, or `default` when absent."""
    return [float(t) for t in arg.split(",")] if arg is not None else list(default)
