"""What the calibration tools share: the engine over the generated eval
corpus, the judge the environment names, and one judge pass over every
(query, candidate) prompt of a set of retrieval heads."""

from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import tempfile
from typing import List

import numpy as np

from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine
from rust_local_rag_tpu_torch.models.embedding_service import build_default_service
from rust_local_rag_tpu_torch.models.reranker_service import (
    RerankerCandidate,
    RerankerService,
    build_default_reranker,
)

# top-k of each dev query's retrieval head, and the batch its searches go in
HEAD_K = 15
SEARCH_BATCH = 32


@contextlib.contextmanager
def eval_engine(prefix: str, device):
    """(engine, dev queries): a RagEngine on `device` over the generated
    eval corpus (eval_harness.corpus), with the encoder the environment
    names (build_default_service: ENCODER_WEIGHTS, else the committed one)
    and no reranker; its directory is removed afterwards."""
    from eval_harness import corpus

    work = tempfile.mkdtemp(prefix=prefix)
    try:
        docs = os.path.join(work, "docs")
        os.makedirs(docs)
        corpus.generate_corpus(docs)
        gt_path = os.path.join(work, "q.jsonl")
        corpus.generate_ground_truth(gt_path)
        svc = build_default_service(device)
        svc.verify()
        eng = RagEngine(os.path.join(work, "data"), svc, reranker=None, device=device)
        for f in sorted(glob.glob(os.path.join(docs, "*.pdf"))):
            with open(f, "rb") as fh:
                eng.add_document(os.path.basename(f), fh.read())
        print("chunks:", len(eng.store), flush=True)
        with open(gt_path, encoding="utf-8") as fh:
            queries = [json.loads(line) for line in fh]
        yield eng, queries
    finally:
        shutil.rmtree(work, ignore_errors=True)


def heads_of(eng: RagEngine, queries: List[str]):
    """Each query's top-HEAD_K rerank-off results, SEARCH_BATCH at a time."""
    out = []
    for i in range(0, len(queries), SEARCH_BATCH):
        out += eng.search_batch(queries[i:i + SEARCH_BATCH], HEAD_K, use_reranker=False)
    return out


def best_cos(eng: RagEngine, queries: List[str]) -> np.ndarray:
    """Each query's best dense cosine over its retrieval head (0 for none)."""
    return np.array([max((x.embedding_score or 0.0) for x in r) if r else 0.0 for r in heads_of(eng, queries)])


def default_judge(device) -> RerankerService:
    """The judge the environment names (RAG_TPU_RERANK_MODEL, default
    tpu-reranker; RERANKER_WEIGHTS, else the committed one)."""
    os.environ.setdefault("RAG_TPU_RERANK_MODEL", "tpu-reranker")
    rr = build_default_reranker(device)
    if rr is None:
        raise RuntimeError("no reranker (set RERANKER_WEIGHTS)")
    return rr


def score_heads(heads, rr: RerankerService) -> List[float]:
    """The judge's yes-probability of every (query, candidate) of `heads`
    (judge_dev._heads' rows), in order, from one score_prompts."""
    prompts = [
        rr.build_prompt(query, RerankerCandidate(chunk_id="", document=doc, text=text, page_number=page,
                                                 section=section, initial_score=initial))
        for query, _rej, _gold, head, _um in heads
        for text, doc, page, section, initial, _emb in head
    ]
    print(f"scoring {len(prompts)} prompts...", flush=True)
    return [s for s, _, _ in rr.score_prompts(prompts)]


def is_gold_doc(gold, doc: str) -> bool:
    """A candidate of a gold document (page-tolerant: doc-level)."""
    return any(g["document"] == doc for g in gold)
