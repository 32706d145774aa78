"""The committed judge, as the reference computes it: the 4-layer causal
transformer in `rust_local_rag_tpu/assets/reranker.safetensors`, which
the program serves when RAG_TPU_RERANK_MODEL names a judge and
RERANKER_WEIGHTS names no file. Prompts are WordPiece-tokenised by the
committed tokenizer and packed head + tail to the judge's
`train_seq_len`; the forward is `reference.models.judge`.

A configuration names its judge with
    "judge": {"model": <RAG_TPU_RERANK_MODEL>, "weights": <RERANKER_WEIGHTS, optional>,
              "reference": <a module under benchmark/reference/>}
and that module gives `load(device)`, a judge with
    seq_len                        the prompt length it packs to,
    score(prompts, fp8=False)      -> (yes logprobs, no logprobs, valid tokens), one a prompt,
    prompt_flops(tokens, work)     the matmul operations of one prompt of `tokens` valid
                                   tokens, by the yardstick `work` (harness/work.py, passed
                                   in: no module here imports the harness).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import torch

from reference import models
from reference.tokenizer import WordPieceTokenizer

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                      "rust_local_rag_tpu", "assets")


class Judge:
    """The judge whose weights are the safetensors file at `path`
    ("reranker_config" and "train_seq_len" in its metadata)."""

    def __init__(self, path: str, device):
        self.model = models.load(path, "reranker_config", device)
        self.seq_len = int(self.model.meta.get("train_seq_len", "192"))
        self.tok = WordPieceTokenizer(os.path.join(ASSETS, "tokenizer.json"))
        yes, no = self.tok.tokenize("yes"), self.tok.tokenize("no")
        self.yes_id, self.no_id = next((a, b) for a, b in zip(yes, no) if a != b)
        self.device = device

    def score(self, prompts: Sequence[str], fp8: bool = False) -> Tuple[List[float], List[float], List[int]]:
        ids, mask = self.tok.encode_batch_headtail(list(prompts), self.seq_len)
        yes, no = models.judge(self.model, torch.from_numpy(ids).to(self.device),
                               torch.from_numpy(mask).to(self.device), self.yes_id, self.no_id, fp8=fp8)
        return yes.double().cpu().tolist(), no.double().cpu().tolist(), mask.sum(axis=1).tolist()

    def prompt_flops(self, tokens: int, work) -> float:
        cfg = self.model.cfg
        return work.transformer_flops(cfg, tokens, causal=True, head=int(cfg["vocab_size"]))


def load(device) -> Judge:
    return Judge(os.path.join(ASSETS, "reranker.safetensors"), device)
