"""Evaluation CLI (port of eval_harness/run.py; cf. eval/run.py in the
reference — same subcommands, arguments and exit codes):

    python -m rust_local_rag_tpu_torch.evaluation.run evaluate [--config PATH] [--out DIR]
    python -m rust_local_rag_tpu_torch.evaluation.run check    [--config PATH]
    python -m rust_local_rag_tpu_torch.evaluation.run list-configs
    python -m rust_local_rag_tpu_torch.evaluation.run generate [--documents DIR] [--ground-truth PATH]

`evaluate` prints the summary (as plain text: the harness's form when
``rich`` is missing), writes JSON + markdown reports, and exits 1 when
Hit Rate@k < 0.80 (the reference's success threshold, eval/run.py:196-200)
or the rejection rate fails, 2 when the server is not ready. `generate`
materializes the synthetic corpus through the harness's own standard-
library writers (eval_harness.corpus, eval_harness.thirdparty). The
configs are read by evaluation/config.py and the server is reached by
evaluation/client.py: nothing here needs requests, yaml or rich.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from rust_local_rag_tpu_torch.evaluation.client import RAGClient
from rust_local_rag_tpu_torch.evaluation.runner import EvalConfig, EvalRunner, load_ground_truth, write_reports

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG_DIR = os.path.join(ROOT, "eval_harness", "configs")


def _config(path) -> EvalConfig:
    return EvalConfig.from_yaml(path) if path else EvalConfig()


def cmd_evaluate(args) -> int:
    config = _config(args.config)
    if args.endpoint:
        config.rag_endpoint = args.endpoint
    if args.ground_truth:
        config.ground_truth_path = args.ground_truth
    client = RAGClient(endpoint=config.rag_endpoint, mode=config.connection_mode)
    try:
        if not client.health_check():
            print(f"Server at {config.rag_endpoint} is not ready", file=sys.stderr)
            return 2
        queries = load_ground_truth(config.ground_truth_path)
        report = EvalRunner(config, client).run_evaluation(queries)
    finally:
        client.close()
    print(report["summary"])
    write_reports(report, args.out)
    return 0 if report["summary"].get("passed") else 1


def cmd_check(args) -> int:
    config = _config(args.config)
    client = RAGClient(endpoint=config.rag_endpoint, mode=config.connection_mode)
    try:
        ok = client.health_check()
        print(f"server ready: {ok}")
        if ok:
            print(f"stats: {client.get_stats()}")
    finally:
        client.close()
    try:
        queries = load_ground_truth(config.ground_truth_path)
        rejections = sum(1 for q in queries if q.is_rejection)
        print(
            f"ground truth: {len(queries)} queries "
            f"({len(queries) - rejections} retrieval, {rejections} rejection)"
        )
    except OSError as e:
        print(f"ground truth unreadable: {e}")
        return 1
    return 0 if ok else 1


def cmd_list_configs(args) -> int:
    for path in sorted(glob.glob(os.path.join(CONFIG_DIR, "*.yaml"))):
        cfg = EvalConfig.from_yaml(path)
        print(f"{os.path.basename(path)}: {cfg.name} — {cfg.description}")
    return 0


def cmd_generate(args) -> int:
    if args.split == "thirdparty":
        from eval_harness.thirdparty import generate_thirdparty_corpus, generate_thirdparty_ground_truth

        names = generate_thirdparty_corpus(args.documents)
        count = generate_thirdparty_ground_truth(args.ground_truth)
    else:
        from eval_harness.corpus import generate_corpus, generate_ground_truth

        names = generate_corpus(args.documents)
        count = generate_ground_truth(args.ground_truth, split=args.split)
    print(f"wrote {len(names)} PDFs to {args.documents}")
    print(f"wrote {count} ground-truth queries ({args.split} split) to {args.ground_truth}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rust_local_rag_tpu_torch.evaluation.run")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_eval = sub.add_parser("evaluate")
    p_eval.add_argument("--config", default=None)
    p_eval.add_argument("--out", default="eval_harness/reports")
    p_eval.add_argument("--endpoint", default=None, help="override the config's rag_endpoint")
    p_eval.add_argument("--ground-truth", default=None, help="override the config's ground_truth_path")
    p_eval.set_defaults(fn=cmd_evaluate)

    p_check = sub.add_parser("check")
    p_check.add_argument("--config", default=None)
    p_check.set_defaults(fn=cmd_check)

    p_list = sub.add_parser("list-configs")
    p_list.set_defaults(fn=cmd_list_configs)

    p_gen = sub.add_parser("generate")
    p_gen.add_argument("--documents", default="./documents")
    p_gen.add_argument("--ground-truth", default="eval_harness/ground_truth/queries.jsonl")
    p_gen.add_argument(
        "--split", choices=("dev", "test", "thirdparty"), default="dev",
        help="dev = tuning split (corpus_data.py); test = held-out "
        "report-only split (heldout_data.py); thirdparty = real "
        "third-party documents (thirdparty.py: CPython reference + "
        "pygame docs) through the full pdf->chunk->embed pipeline",
    )
    p_gen.set_defaults(fn=cmd_generate)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
