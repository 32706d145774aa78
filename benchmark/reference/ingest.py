"""The plain reference of ingest, and the comparison that judges what an
ingest window wrote.

  * A chunk's row is the encoder's embedding of "document prefix + text",
    normalised and stored in the slab's dtype. row_gap is the largest
    Euclidean distance between a written row and the reference's (both
    unit vectors).
  * The lexical index must give every query the top BM25 hits of the
    chunks ingested. bm25 numbers, in shares of the query's best reference
    score: score_gap is the largest |served - reference| of a hit's score,
    choice_gap the largest amount by which the best chunk a hit list
    passed over outscores the hit taken in its place.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from reference import models
from reference.bm25 import Bm25
from reference.tokenizer import WordPieceTokenizer, bucket_batch

BATCH = 256


def embed_documents(encoder: models.Model, tok: WordPieceTokenizer, texts: Sequence[str], device,
                    stored: torch.dtype, fp8: bool = False) -> torch.Tensor:
    """[n, D] f64 rows as the slab stores them."""
    prefix = encoder.meta.get("document_prefix", "")
    out = []
    for lo in range(0, len(texts), BATCH):
        part = [prefix + t for t in texts[lo:lo + BATCH]]
        ids, mask = tok.encode_batch(part)
        nb = bucket_batch(len(part))
        if nb > len(part):
            ids = np.concatenate([ids, np.zeros((nb - len(part), ids.shape[1]), ids.dtype)])
            mask = np.concatenate([mask, np.zeros((nb - len(part), mask.shape[1]), mask.dtype)])
            mask[len(part):, 0] = 1
        emb = models.encode(encoder, torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device),
                            fp8=fp8)[:len(part)].double()
        out.append(emb / emb.norm(dim=1, keepdim=True))
    return torch.cat(out).to(stored).double()


def row_gap(written: torch.Tensor, reference: torch.Tensor) -> float:
    """Largest Euclidean distance between matching rows (inf where a row
    is missing: NaN)."""
    d = (written.double() - reference.double()).norm(dim=1)
    return float("inf") if bool(torch.isnan(d).any()) else float(d.max())


def bm25_numbers(index: Bm25, terms, hits: List[Tuple[int, float]], limit: int) -> dict:
    """score_gap and choice_gap of one query's hit list [(document, score)]
    (see the module docstring); short = 1 when it holds fewer hits than the
    reference has positive scores, up to `limit`."""
    ref = index.scores(terms)
    best = float(ref.max()) if ref.size else 0.0
    scale = max(best, 1e-12)
    out = {"score_gap": 0.0, "choice_gap": 0.0,
           "short": 1.0 if len(hits) < min(limit, int(np.count_nonzero(ref > 0))) else 0.0}
    order = np.argsort(-ref, kind="stable")[:limit + len(hits) + 1]
    taken = set()
    for d, s in hits:
        out["score_gap"] = max(out["score_gap"], abs(s - ref[d]) / scale)
        best_left = next(float(ref[j]) for j in order if int(j) not in taken)
        out["choice_gap"] = max(out["choice_gap"], (best_left - ref[d]) / scale)
        taken.add(int(d))
    return out
