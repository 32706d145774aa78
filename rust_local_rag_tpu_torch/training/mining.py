"""Dense hard-negative mining and cross-encoder denoising (port of
rust_local_rag_tpu/training/mining.py on the port's encoder, reranker and
BM25; the top-k is torch.matmul + torch.topk on the device).

Shared by the encoder and reranker trainers. Two pieces:

* ``mine_dense_neighbors`` — nearest-paragraph table under the dense
  encoder at ENCODER_WEIGHTS (else the committed one): the
  semantically-adjacent near-misses the serving hybrid pool surfaces that
  BM25 mining cannot see (moved here from train_reranker.py, which keeps
  importing it).
* ``denoise_with_reranker`` — RocketQA-style false-negative filter
  (Qu et al. 2021): dense-mined neighbors are dominated by paraphrase-level
  TRUE answers, and the recorded reranker v3/v4 negative results show a
  cosine near-duplicate cut (>0.9) alone is not sufficient — paraphrase
  near-positives below the cut still dominate. Here every surviving
  neighbor is additionally judged by the cross-encoder reranker at
  RERANKER_WEIGHTS (else the committed one) against a canonical query
  crop of its source paragraph; neighbors the
  judge answers "yes" to (margin above threshold) are presumed false
  negatives and dropped. Only confidently-"no" neighbors survive as
  training negatives.

Reference behavior anchor: the reference trains nothing (it consumes
Ollama-served pretrained models, embeddings.rs:60-182);
this subsystem exists because the zero-egress environment has no pretrained
checkpoint to convert, so retrieval quality must be trained in-repo.

The disk caches carry a "torch" prefix in their key and file name, so the
port and the JAX package never read a table the other mined.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from rust_local_rag_tpu_torch.device import resolve_device
from rust_local_rag_tpu_torch.models.encoder import resolve_model_file

_CACHE_DIR = os.path.join("~", ".cache", "rag_tpu_premine")
# (environment variable, committed asset) of the models mining runs: the
# files the serving loaders resolve (models/encoder.resolve_model_file)
ENCODER_FILE = ("ENCODER_WEIGHTS", "encoder.safetensors")
RERANKER_FILE = ("RERANKER_WEIGHTS", "reranker.safetensors")


def _cache_path(name: str) -> str:
    return os.path.join(os.path.expanduser(_CACHE_DIR), "torch_" + name)


def _save_cache(path: str, write) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def _unit(embs: np.ndarray) -> np.ndarray:
    embs = embs.astype(np.float32)
    return embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-10)


def _topk_bf16(qs: np.ndarray, corpus: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k of bf16 queries against a bf16 corpus with f32 scores (exact
    bf16 products summed in f32, XLA's preferred_element_type=f32)."""
    q = torch.from_numpy(qs).to(corpus.device).to(torch.bfloat16).float()
    vals, idx = torch.topk(q @ corpus.float().T, k, dim=1)
    return vals.cpu().numpy(), idx.cpu().numpy()


def mine_dense_neighbors(
    paragraphs: List[str],
    n_neighbors: int = 4,
    block: int = 4096,
    max_sim: float = 0.9,
    device="cuda",
) -> Optional[np.ndarray]:
    """[P, n_neighbors] int32 neighbor table mined by the dense encoder at
    ENCODER_WEIGHTS (else the committed one) on `device`: for each paragraph, the nearest other paragraphs
    by cosine — the semantically-adjacent near-misses the hybrid first
    stage surfaces that BM25 mining cannot see. Returns None when that
    weights file does not exist (v2-recipe fallback)."""
    if not os.path.exists(resolve_model_file(None, *ENCODER_FILE)):
        return None
    from rust_local_rag_tpu_torch.models.embedding_service import build_default_service

    svc = build_default_service(device)
    t0 = time.monotonic()
    embs = []
    # modest per-dispatch batch: paragraphs bucket up to the encoder's
    # 512-token cap, and a 4096-wide forward at L=512 allocates a 34 GB
    # attention tensor (measured OOM) — 256 keeps it under 2 GB
    step = 256
    for lo in range(0, len(paragraphs), step):
        embs.append(
            np.asarray(svc.embed_texts(paragraphs[lo : lo + step]))
        )
    embs = _unit(np.concatenate(embs))
    corpus = torch.from_numpy(embs).to(resolve_device(device)).to(torch.bfloat16)
    k = min(n_neighbors + 8, len(paragraphs))

    n = len(paragraphs)
    out = np.full((n, n_neighbors), -1, dtype=np.int32)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        vals, idx = _topk_bf16(embs[lo:hi], corpus, k)
        for r in range(hi - lo):
            # drop the paragraph itself AND near-duplicates: supervising
            # "no" on a passage nearly identical to the positive teaches
            # the judge to reject serving positives (train_reranker.py v3
            # lesson)
            cands = [
                int(j)
                for j, v in zip(idx[r], vals[r])
                if int(j) != lo + r and v <= max_sim
            ]
            out[lo + r, : len(cands[:n_neighbors])] = cands[:n_neighbors]
    print(
        f"dense-mined {n} paragraphs x {n_neighbors} neighbors in "
        f"{time.monotonic() - t0:.1f}s"
    )
    return out


def canonical_crops(texts: List[str], seed: int = 987) -> List[str]:
    """One deterministic 3–12-word crop per paragraph — the same query
    distribution the BM25 premine and the reranker trainer draw from
    (train_reranker.PromptPairBatcher._query_and_passage)."""
    rng = np.random.default_rng(seed)
    crops = []
    for p in texts:
        words = p.split()
        qlen = int(rng.integers(3, 13))
        start = int(rng.integers(0, max(len(words) - qlen, 1)))
        crops.append(" ".join(words[start : start + qlen]))
    return crops


def denoise_with_reranker(
    texts: List[str],
    table: np.ndarray,
    margin: float = 0.0,
    batch: int = 512,
    seed: int = 987,
    device="cuda",
) -> Tuple[np.ndarray, dict]:
    """Drop presumed false negatives from a mined neighbor table.

    For each valid (source i, neighbor j) the reranker at RERANKER_WEIGHTS
    (else the committed one) scores the serving prompt built from a
    canonical query crop of ``texts[i]``
    against ``texts[j]``; entries whose yes/no logit margin exceeds
    ``margin`` are judged to actually ANSWER the query (false negatives —
    paraphrase-level true matches) and replaced with -1. Returns the
    filtered copy and summary stats. Requires a trained reranker asset;
    raises if only the seeded-random fallback would load (filtering with a
    random judge would silently keep every false negative).
    """
    from rust_local_rag_tpu_torch.models.reranker import TransformerReranker
    from rust_local_rag_tpu_torch.models.reranker_service import DEFAULT_PROMPT_TEMPLATE

    if not os.path.exists(resolve_model_file(None, *RERANKER_FILE)):
        raise RuntimeError(
            "denoise_with_reranker needs the trained reranker asset"
        )
    judge = TransformerReranker.from_assets(device=device)

    pairs = [
        (i, k)
        for i in range(table.shape[0])
        for k in range(table.shape[1])
        if table[i, k] >= 0
    ]
    crops = canonical_crops(texts, seed=seed)
    out = table.copy()
    margins = np.empty(len(pairs), dtype=np.float32)
    t0 = time.monotonic()
    for lo in range(0, len(pairs), batch):
        span = pairs[lo : lo + batch]
        prompts = [
            DEFAULT_PROMPT_TEMPLATE.format(
                query=crops[i],
                document="corpus.pdf",
                page="1",
                section="N/A",
                text=texts[int(table[i, k])],
            )
            for i, k in span
        ]
        scored = judge.score_prompts(prompts)
        for off, (_, yes_lp, no_lp) in enumerate(scored):
            margins[lo + off] = yes_lp - no_lp
    dropped = 0
    for n_, (i, k) in enumerate(pairs):
        if margins[n_] > margin:
            out[i, k] = -1
            dropped += 1
    stats = {
        "pairs": len(pairs),
        "dropped": dropped,
        "drop_frac": dropped / max(len(pairs), 1),
        "margin_p50": float(np.median(margins)) if len(pairs) else 0.0,
        "margin_p90": float(np.percentile(margins, 90)) if len(pairs) else 0.0,
        "seconds": time.monotonic() - t0,
    }
    print(
        f"reranker denoise: {stats['dropped']}/{stats['pairs']} neighbors "
        f"judged false-negative ({100 * stats['drop_frac']:.1f}%) in "
        f"{stats['seconds']:.1f}s (margin p50 {stats['margin_p50']:.2f}, "
        f"p90 {stats['margin_p90']:.2f})"
    )
    return out, stats


def mine_junk_neighbors(
    junk: List[str],
    paragraphs: List[str],
    pool: Optional[List[int]] = None,
    n_bm25: int = 2,
    n_dense: int = 2,
    device="cuda",
) -> np.ndarray:
    """[J, n_bm25+n_dense] int32 neighbor table for junk queries: for each
    out-of-domain query, the corpus passages RETRIEVAL would surface for
    it — its top BM25 hits plus its top dense-cosine hits (committed
    encoder) over ``pool`` (indices into ``paragraphs``; None = all).

    Why: pairing junk queries with RANDOM passages (the v7–v10 recipes)
    teaches the judge to reject easy pairs, but the serving rejection
    gate scores the junk query against its TOP-RETRIEVED chunks — the
    most lexically/semantically attractive passages in the corpus. The
    round-4 dev probe showed exactly this gap: v10's training-time OOD
    probe (random pairs) read yes-p mean 0.017 while the same judge gave
    the dev rejection queries' retrieved chunks yes-p up to 0.90. This
    table supplies the hard pairs. Dense columns are -1 when no trained
    encoder asset exists. Disk-cached (same scheme as
    cached_denoised_table): the dense half costs ~1 min of device time
    per 50k pool passages.
    """
    import hashlib

    pool = list(range(len(paragraphs))) if pool is None else list(pool)

    enc_path = resolve_model_file(None, *ENCODER_FILE)
    have_encoder = os.path.exists(enc_path) and n_dense > 0

    h = hashlib.sha256()
    # v2: junk queries embed through the QUERY-side encoder path
    h.update(f"torch|junk2|{n_bm25}|{n_dense}|".encode())
    if have_encoder:
        st = os.stat(enc_path)
        h.update(f"enc:{enc_path}:{st.st_size}:{st.st_mtime_ns}|".encode())
    else:
        h.update(b"enc:none|")
    for q in junk:
        h.update(q.encode())
        h.update(b"\0")
    for i in pool:
        h.update(paragraphs[i].encode())
        h.update(b"\0")
    cache = _cache_path("junk_" + h.hexdigest()[:24] + ".npy")
    if os.path.exists(cache):
        print(f"junk premine cache hit: {cache}")
        return np.load(cache)

    t0 = time.monotonic()
    width = n_bm25 + (n_dense if have_encoder else 0)
    out = np.full((len(junk), max(width, 1)), -1, dtype=np.int32)

    if n_bm25 > 0:
        from rust_local_rag_tpu_torch.ops.native_bm25 import make_lexical_index

        bm25 = make_lexical_index()
        bm25.add_chunks([str(i) for i in pool], [paragraphs[i] for i in pool])
        for r, q in enumerate(junk):
            hits = bm25.score(q, n_bm25)
            for c, (cid, _) in enumerate(hits[:n_bm25]):
                out[r, c] = int(cid)

    if have_encoder:
        from rust_local_rag_tpu_torch.models.embedding_service import build_default_service

        svc = build_default_service(device)
        step = 256

        def embed(texts):
            return _unit(np.concatenate([
                np.asarray(svc.embed_texts(texts[lo : lo + step]))
                for lo in range(0, len(texts), step)
            ]))

        corpus_np = embed([paragraphs[i] for i in pool])
        corpus = torch.from_numpy(corpus_np).to(resolve_device(device)).to(torch.bfloat16)
        # queries ride the QUERY-side encoder path (task prefix) so the
        # mined neighbors match what serving retrieval actually surfaces
        qs_np = _unit(np.concatenate(
            [
                np.asarray(svc._encode_queries(list(junk)[lo : lo + step]))
                for lo in range(0, len(junk), step)
            ]
        ))
        block = 1024
        k = min(n_dense + n_bm25, len(pool))

        pool_arr = np.asarray(pool, dtype=np.int32)
        for lo in range(0, len(junk), block):
            hi = min(lo + block, len(junk))
            _, idx = _topk_bf16(qs_np[lo:hi], corpus, k)
            for r in range(hi - lo):
                have = set(int(x) for x in out[lo + r] if x >= 0)
                c = n_bm25
                for j in idx[r]:
                    g = int(pool_arr[int(j)])
                    if g in have:
                        continue
                    out[lo + r, c] = g
                    have.add(g)
                    c += 1
                    if c >= width:
                        break

    print(
        f"junk-mined {len(junk)} queries x {out.shape[1]} neighbors "
        f"(bm25={n_bm25}, dense={n_dense if have_encoder else 0}) in "
        f"{time.monotonic() - t0:.1f}s"
    )
    _save_cache(cache, lambda f: np.save(f, out))
    return out


def cached_denoised_table(
    texts: List[str],
    n_neighbors: int = 4,
    margin: float = 0.0,
    device="cuda",
) -> Tuple[np.ndarray, dict]:
    """Mined + reranker-denoised neighbor table, disk-cached.

    The cache key covers the corpus, the mining params, AND both model
    assets (remining is ~15 min of device time at 184k paragraphs), so
    the encoder and reranker trainers share entries for the same text
    list. Raises RuntimeError when either trained asset is missing
    (mining needs the encoder, denoising the reranker).
    """
    import hashlib
    import json

    h = hashlib.sha256()
    h.update(f"torch|dense|{n_neighbors}|{margin}|".encode())
    # the resolved weights' paths, sizes and times (ENCODER_WEIGHTS /
    # RERANKER_WEIGHTS first, as mining loads them): a run against other
    # weights gets another key (JAX mining.py:373-387)
    for which in (ENCODER_FILE, RERANKER_FILE):
        asset = which[1]
        p = resolve_model_file(None, *which)
        st = os.stat(p) if os.path.exists(p) else None
        h.update(
            f"{asset}:{p}:{st.st_size}:{st.st_mtime_ns}|".encode()
            if st
            else f"{asset}:none|".encode()
        )
    for t in texts:
        h.update(t.encode())
        h.update(b"\0")
    cache = _cache_path("dense_" + h.hexdigest()[:24] + ".npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            table = z["table"]
            stats = json.loads(str(z["stats"]))
        print(f"dense premine cache hit: {cache}")
        return table, stats
    table = mine_dense_neighbors(texts, n_neighbors=n_neighbors, device=device)
    if table is None:
        raise RuntimeError(
            "cached_denoised_table needs the trained encoder asset"
        )
    table, stats = denoise_with_reranker(texts, table, margin=margin, device=device)
    _save_cache(cache, lambda f: np.savez(f, table=table, stats=json.dumps(stats)))
    return table, stats
