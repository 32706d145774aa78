"""Engine-level scale check (port of scripts/scale_check.py; BASELINE.json
config 2): a 100k-chunk corpus through the port's whole RagEngine search
path (hybrid blend, segmented selection, MMR) on the card, with oracle
validation of the ranking.

SCALE_N (default 100,000) seeded unit rows of width 768 behind the hash
encoder; the store grows to capacity 131,072 (a multiple of 16,384 past
65,536), so every first stage launches the masked score + segment-max
kernel (csrc/score_segmax.cu), whose launches are counted and must be
above 0 on the card. Times: search_with_diversity (top_k 100, MMR 0.3)
one query at a time, then search_with_diversity_batch at 16 and 64.

    python -m rust_local_rag_tpu_torch.tools.scale_check [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine
from rust_local_rag_tpu_torch.experiments.common import card, parse_device
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService
from rust_local_rag_tpu_torch.models.fake_encoder import HashEncoder
from rust_local_rag_tpu_torch.ops.score_segmax import score_segmax
from rust_local_rag_tpu_torch.tools import oracle_check

DIM = 768
TOP_K = 100
DIVERSITY = 0.3
POPULATE_BATCH = 20_000
BATCHES = (16, 64)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def populate(eng: RagEngine, n: int, rng: np.random.Generator) -> None:
    """n seeded unit rows into the store, and 200 texts of each batch of
    POPULATE_BATCH into the lexical index at their slots."""
    for lo in range(0, n, POPULATE_BATCH):
        hi = min(lo + POPULATE_BATCH, n)
        emb = rng.standard_normal((hi - lo, DIM)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        metas = [
            ChunkMeta(id=f"c{i}", document_name=f"doc{i % 500}.pdf",
                      text=f"synthetic chunk {i} with filler words alpha beta",
                      chunk_index=i, page_number=(i % 40) + 1)
            for i in range(lo, hi)
        ]
        slots = eng.store.add_chunks(metas, emb)
        step = max(1, (hi - lo) // 200)
        for m, slot in zip(metas[::step], slots[::step]):
            eng.lexical_index.add_chunk(m.id, m.text, slot)


def run(n: int, device, log=print) -> dict:
    """The whole check on `device`; returns its numbers (and "oracle")."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    out: dict = {"n": n, "dim": DIM, "top_k": TOP_K, "diversity": DIVERSITY}
    svc = EmbeddingService(HashEncoder(dim=DIM, model_name="scale-check"))
    with tempfile.TemporaryDirectory() as tmp:
        eng = RagEngine(tmp, svc, device=dev)
        log(f"populating {n} chunks...")
        t0 = time.monotonic()
        populate(eng, n, rng)
        out["populate_s"] = time.monotonic() - t0
        out["capacity"] = eng.store.capacity
        log(f"populated in {out['populate_s']:.1f}s (capacity {eng.store.capacity})")

        score_segmax.launches = 0
        t0 = time.monotonic()
        eng.search_with_diversity("alpha beta filler", TOP_K, DIVERSITY)
        sync(dev)
        out["first_search_s"] = time.monotonic() - t0
        log(f"first search: {out['first_search_s']:.1f}s")

        queries = [f"synthetic query number {i} alpha" for i in range(20)]
        t0 = time.monotonic()
        for q in queries:
            res = eng.search_with_diversity(q, TOP_K, DIVERSITY)
        sync(dev)
        el = time.monotonic() - t0
        out["ms_per_query"], out["qps"] = el / len(queries) * 1000, len(queries) / el
        log(f"warm engine search_with_diversity(top_k={TOP_K}, mmr={DIVERSITY}): "
            f"{out['ms_per_query']:.1f} ms/query ({out['qps']:.1f} qps single-stream)")

        # the batched engine path (what the server's micro-batcher drives)
        for bq in BATCHES:
            eng.search_with_diversity_batch([f"batched query {i} alpha beta" for i in range(bq)], TOP_K, DIVERSITY)
            batch = [f"batched query {i} gamma delta" for i in range(bq)]
            t0 = time.monotonic()
            got = eng.search_with_diversity_batch(batch, TOP_K, DIVERSITY)
            sync(dev)
            el = time.monotonic() - t0
            if len(got) != bq or not got[0]:
                raise AssertionError(f"batched x{bq}: {len(got)} answers, the first {len(got[0]) if got else 0} long")
            out[f"batch{bq}_ms"], out[f"batch{bq}_qps"] = el * 1000, bq / el
            log(f"engine batched x{bq}: {el * 1000:.1f} ms/batch -> {bq / el:.1f} qps engine-level")
        out["score_segmax_masked_launches"] = score_segmax.launches

        # oracle validation of the first stage on 3 queries
        out["oracle"] = oracle_check.validate(eng, rng, n_queries=3, top_k=20)
        log(f"oracle ranking parity: {'PASS' if out['oracle'] else 'FAIL'}")
        if not res:
            raise AssertionError("search_with_diversity answered nothing")
    return out


def main(argv=None) -> int:
    dev = parse_device(argv, __doc__.split("\n\n")[0])
    print(card(dev) if dev.type == "cuda" else "cpu", flush=True)
    out = run(int(os.environ.get("SCALE_N", 100_000)), dev, log=lambda m: print(m, flush=True))
    print(json.dumps({"scale_check": out}))
    if dev.type == "cuda" and out["score_segmax_masked_launches"] == 0:
        print("the masked score + segment-max kernel was never launched", file=sys.stderr)
        return 1
    return 0 if out["oracle"] else 1


if __name__ == "__main__":
    sys.exit(main())
