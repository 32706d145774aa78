"""The control of `correct`: the plain reference put in the program's place
and computed in the step below the precision the configuration states
(float8 e4m3 operands in every linear layer of the encoder and the judge,
for their stated bfloat16; BM25 scores rounded to bfloat16, for the
index's float32 sums), judged by the same comparison as a run, at the
cell's own size.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 [--device cuda]

Each seed makes the inputs a run of BENCHMARK.json's run_seconds makes.
For a search cell, the float8 reference answers queries of the window's
stream drawn from the seed over the cell's whole corpus; for an ingest
cell, it writes the rows of a sample of the whole passage stream (the
traffic's max_rate x run_seconds, at least what a window indexes),
drawn as a run draws its sample, and ranks the BM25 hits of the queries a
run samples over that stream. Prints one JSON line a seed with each
number beside the cell's limit, and whether the limits hold (they must
not: a control that passes cannot tell a run that lost precision from a
sound one). The benchmark's runs never run it.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import gen, runner  # noqa: E402
from harness.record import Record  # noqa: E402
from reference import models  # noqa: E402
from reference.bm25 import Bm25  # noqa: E402
from reference.ingest import bm25_numbers, embed_documents, row_gap  # noqa: E402
from reference.search import lane_for  # noqa: E402


def search_control(cell, seed: int, seconds: float, device) -> dict:
    d = runner.driver(cell.traffic["driver"])
    cfg, traffic = cell.config, cell.traffic
    x = d.make_inputs(cell, seed, seconds, device)
    lane = lane_for(traffic["body"], cfg["weights"], bool(cfg.get("judge")))
    ref = d.make_reference(x, cfg, device, lane.use_reranker)
    ctl = d.make_reference(x, cfg, device, lane.use_reranker, fp8=True, corpus=ref.c)
    keep = d.sample_indices(x.queries, range(min(len(x.queries), int(traffic["max_rate"] * seconds))), traffic,
                            seed)
    q = ctl.embed_queries([x.queries.texts[i] for i in keep])
    bodies = {str(i): json.dumps({"results": ctl.answer(x.queries.texts[i], x.queries.words(i), q[j], lane)})
              for j, i in enumerate(keep)}
    rec = Record(window_s=seconds, attempted=len(keep), failed=0, completed=len(keep), setup_s=0.0, probes=None,
                 counters={})
    d.judge_numbers(rec, ref, lane, x.queries, keep, bodies)
    return rec.numbers


def ingest_control(cell, seed: int, seconds: float, device) -> dict:
    cfg, traffic = cell.config, cell.traffic
    x = runner.driver(traffic["driver"]).Stream(cell, seed, seconds)
    sample = x.sample(x.n, int(traffic["sample_rows"]), seed)
    encoder = models.load(runner.asset("encoder.safetensors"), "encoder_config", device)
    stored = gen.slab_dtype(cfg)
    texts = [x.passages.texts[i] for i in sample]
    ref = embed_documents(encoder, x.tok, texts, device, stored)
    ctl = embed_documents(encoder, x.tok, texts, device, stored, fp8=True)
    out = {"row_gap": row_gap(ctl, ref), "bm25_score_gap": 0.0, "bm25_choice_gap": 0.0}
    index = Bm25(x.passages.ids, x.passages.offsets, len(x.vocab))
    queries = gen.queries(x.vocab, cfg["queries"], int(traffic["sample_queries"]), seed)
    limit = int(traffic["lexical_limit"])
    for j in range(len(queries)):
        # BM25 in bfloat16, the step below the index's f32 sums
        low = torch.from_numpy(index.scores(queries.words(j))).to(torch.bfloat16).double().numpy()
        top = np.argsort(-low, kind="stable")[:limit]
        hits = [(int(d), float(low[d])) for d in top if low[d] > 0]
        nums = bm25_numbers(index, queries.words(j), hits, limit)
        out["bm25_score_gap"] = max(out["bm25_score_gap"], nums["score_gap"])
        out["bm25_choice_gap"] = max(out["bm25_choice_gap"], nums["choice_gap"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if runner.ROOT not in sys.path:
        sys.path.insert(0, runner.ROOT)
    device = torch.device(args.device)
    models.full_precision()
    cell = runner.load_cell(args.workload)
    seconds = runner.read_manifest()["run_seconds"]
    for seed in args.seeds:
        if cell.traffic["driver"] == "ingest":
            numbers = ingest_control(cell, seed, seconds, device)
        else:
            numbers = search_control(cell, seed, seconds, device)
        held = all(v <= cell.limits[k] for k, v in numbers.items())
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "fp8",
                          "numbers": {k: {"value": runner.finite(v), "limit": cell.limits[k]}
                                      for k, v in numbers.items()},
                          "limits_hold": held}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
