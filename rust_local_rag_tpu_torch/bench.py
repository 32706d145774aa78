"""Exact top-k over one card's corpus shard, and ingest (port of bench.py).

    python -m rust_local_rag_tpu_torch.bench [--n 1245184] [--steps 16] [--device cuda]

The JAX bench's workload (BASELINE.json): exact top_k 100 over 768-d rows.
One chip of eight holds 10M / 8 = 1,250,000 rows; the score + segment-max
kernels need N % 16,384 == 0, so the shard is cut to 1,245,184 rows
(bench.py:135-136), and every line reports what ran at that N: nothing is
scaled up to 1.25M.

Each timed loop is a chain of `steps` query batches in which every step's
queries are perturbed by the previous step's result (bench.py:96-101), so
the steps carry a data dependency; CUDA events time the chain. Lines, each
at Q 128 and Q 512 on a bf16 slab (bf16 queries) and Q 128 on an f32 slab
(f32 queries):

  * segmented_topk: the unmasked score + segment-max kernel and the
    segmented selection (ops/score_segmax.segmented_topk);
  * hybrid_topk_packed: the masked kernel's first stage with an empty
    lexical side (ops/hybrid.hybrid_topk_packed);
  * library: one torch.mm to f32 and torch.topk.

Each line's last step is held to torch.topk of the plain plane on the same
queries. Then ingest: the committed encoder alone (chunks/s at seq 256,
batch 1024, a chain of 8 batches) and the full pipeline (PDF extraction,
chunking, tokenising, encoding, and the store: the rows into a device
slab and the texts into the native BM25 index, which the JAX bench leaves
out) over rendered PDFs with its host split.
JAX's approx99 line (lax.approx_max_k) and its projected v5e-8 figure have
no counterpart here and print as null with the reason. Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from rust_local_rag_tpu_torch.device import resolve_device
from rust_local_rag_tpu_torch.ops.hybrid import hybrid_topk_packed
from rust_local_rag_tpu_torch.ops.score_segmax import fused_score_segmax_plain, segmented_topk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100_BF16_FLOPS = 989e12  # bf16 tensor cores, dense, H100 SXM data sheet
REF_QPS = 1.0 / 30.9  # the reference's p50, 30.9 s a query (BASELINE.md)
SHARD = 1_250_000  # 10M rows over 8 chips


def unit_rows(gen: torch.Generator, shape, device, dtype) -> torch.Tensor:
    x = torch.randn(*shape, generator=gen, device=device, dtype=torch.float32)
    return (x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-10)).to(dtype)


class Clock:
    """Wall milliseconds of a chain of device work: CUDA events on the
    card, perf_counter after a plain wait on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()
            self.a, self.b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            self.ms = self.a.elapsed_time(self.b)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3


def chain(step: Callable, qall: torch.Tensor):
    """The steps in order, each step's queries perturbed by the sum of the
    previous step's top-k values. -> (last queries, last values, last
    indices); the carry forces every step to run."""
    carry = torch.zeros((), dtype=torch.float32, device=qall.device)
    qs = vals = idx = None
    for s in range(qall.shape[0]):
        qs = (qall[s].float() + carry * 1e-6).to(qall.dtype)
        vals, idx = step(qs)
        carry = vals.sum()
    return qs, vals, idx


def timed_chain(step: Callable, qall: torch.Tensor, device: torch.device):
    """One warm-up chain, then the timed chain: (ms, last queries, values,
    indices)."""
    chain(step, qall)
    with Clock(device) as c:
        out = chain(step, qall)
    return (c.ms, *out)


def topk_lines(corpus: torch.Tensor, qall: torch.Tensor, k: int, device: torch.device) -> dict:
    """The three lines at one shape, each with its last step held to
    torch.topk of the plain plane."""
    n = corpus.shape[0]
    mask = torch.ones(n, dtype=torch.bool, device=device)
    q = qall.shape[1]
    lex_slots = torch.full((q, 1), -1, dtype=torch.int32, device=device)
    lex_vals = torch.zeros((q, 1), dtype=torch.float32, device=device)
    w_e = torch.tensor(1.0, device=device)
    w_l = torch.tensor(0.0, device=device)

    def hybrid(qs):
        packed = hybrid_topk_packed(qs, corpus, mask, lex_slots, lex_vals, w_e, w_l, k)
        return packed[:, 0].view(torch.float32), packed[:, 3]  # the packed layout's combined and idx planes

    def library(qs):
        """One GEMM to f32 (bf16 operands on the card; widened to f32 on
        the CPU, which has no mixed-dtype mm) and torch.topk."""
        if qs.dtype == torch.bfloat16 and device.type == "cuda":
            scores = torch.mm(qs, corpus.T, out_dtype=torch.float32)
        else:
            scores = torch.mm(qs.float(), corpus.float().T)
        return torch.topk(scores, k, dim=1)

    steps = {"segmented_topk": lambda qs: segmented_topk(qs, corpus, k), "hybrid_topk_packed": hybrid,
             "library_mm_topk": library}
    out = {}
    for name, step in steps.items():
        ms, qs, vals, idx = timed_chain(step, qall, device)
        want_v, want_i = torch.topk(fused_score_segmax_plain(qs, corpus)[0], k, dim=1)
        vals, idx = torch.as_tensor(vals).float(), torch.as_tensor(idx).long()
        same = (idx == want_i).float().mean().item()
        out[name] = {"ms_per_step": ms / qall.shape[0], "qps": qall.shape[0] * q / (ms / 1e3),
                     "max_abs_err": (vals - want_v).abs().max().item(), "same_index_share": same}
        del vals, idx, want_v, want_i
    return out


def _pdf_docs(n_docs: int, seed: int = 0):
    """The full pipeline's documents: the committed training prose when the
    checkout has it (.cache/train_corpus_full.txt), else Zipf prose made
    from `seed`; rendered as ~6-page PDFs of ~16 kB of text each, as the
    JAX bench renders them."""
    from eval_harness.corpus import _ascii, _make_pdf

    path = os.path.join(ROOT, ".cache", "train_corpus_full.txt")
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            paras = [ln.strip() for ln in f if len(ln.split()) > 25]
        source = "pdf (harvested prose rendered to multi-page PDFs)"
    else:
        rng = np.random.default_rng(seed)
        paras = [" ".join(f"word{int(w)}" for w in rng.zipf(1.3, size=120)) for _ in range(20000)]
        source = "pdf (synthetic zipf prose; no committed corpus)"
    docs, pages, cur, size = [], [], [], 0
    for p in paras[:60000]:
        cur.append(_ascii(p))
        size += len(p)
        if size > 2600:
            pages.append("\n\n".join(cur))
            cur, size = [], 0
        if len(pages) >= 6:
            docs.append(_make_pdf(pages))
            pages = []
        if len(docs) >= n_docs:
            break
    return docs, source


def ingest_lines(device: torch.device, batch: int, seq: int, n_docs: int, batches: int = 8) -> dict:
    """The committed encoder alone over seeded ids (a chain of `batches`
    batches), then the full pipeline over rendered PDFs, host stages timed
    apart and each batch's forward enqueued before the host stores the
    previous batch and prepares the next."""
    from rust_local_rag_tpu_torch.ingest import chunk_text
    from rust_local_rag_tpu_torch.ingest.pdf import extract_pdf_text
    from rust_local_rag_tpu_torch.models.encoder import TransformerEncoderModel

    model = TransformerEncoderModel.from_assets(device=device)
    enc, cfg, tok = model.encoder, model.cfg, model.tokenizer
    gen = torch.Generator(device=device).manual_seed(3)
    ids = torch.randint(4, cfg.vocab_size, (batches, batch, seq), generator=gen, device=device, dtype=torch.int32)
    mask = torch.ones_like(ids)

    def forward_chain():
        carry = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(batches):
            carry = carry + enc(ids[i], mask[i])[:, 0].sum()
        return carry

    with torch.inference_mode():
        forward_chain()
        with Clock(device) as c:
            forward_chain()
    device_cps = batches * batch / (c.ms / 1e3)
    n_par = sum(p.numel() for p in enc.parameters())
    flops_chunk = 2 * n_par * seq + 4 * cfg.depth * cfg.dim * seq * seq
    # the card's roofline (none for a CPU run)
    roofline = H100_BF16_FLOPS / flops_chunk if device.type == "cuda" else None

    docs, source = _pdf_docs(n_docs)

    def pipeline():
        """-> (chunks, wall s, host seconds by stage). Each batch's rows go
        into a fresh store and native BM25 index while the next batch's
        forward runs on the device."""
        from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta, ChunkStore
        from rust_local_rag_tpu_torch.ops.native_bm25 import NativeLexicalIndex

        store, lexical = ChunkStore(cfg.out_dim, device=device), NativeLexicalIndex()
        t = {"extract": 0.0, "chunk": 0.0, "tokenize": 0.0, "store": 0.0}
        carry = torch.zeros((), dtype=torch.float32, device=device)
        pending, prev, total = [], None, 0

        def put(frags, emb):
            tc = time.perf_counter()
            metas = [ChunkMeta(id=f"c{total + i}", document_name="bench.pdf", text=f.text, chunk_index=total + i,
                               page_number=f.page_number, section=f.section) for i, f in enumerate(frags)]
            slots = store.add_chunks(metas, emb.cpu().numpy())
            lexical.add_chunks([m.id for m in metas], [m.text for m in metas], slots)
            t["store"] += time.perf_counter() - tc

        t0 = time.perf_counter()
        for data in docs:
            tc = time.perf_counter()
            text = extract_pdf_text(data)
            t["extract"] += time.perf_counter() - tc
            tc = time.perf_counter()
            pending.extend(chunk_text(text, 200))
            t["chunk"] += time.perf_counter() - tc
            while len(pending) >= batch:
                frags, pending = pending[:batch], pending[batch:]
                tc = time.perf_counter()
                b_ids, b_mask = tok.encode_batch([f.text for f in frags], buckets=(seq,))
                if b_ids.shape[1] < seq:
                    pad = seq - b_ids.shape[1]
                    b_ids, b_mask = np.pad(b_ids, ((0, 0), (0, pad))), np.pad(b_mask, ((0, 0), (0, pad)))
                t["tokenize"] += time.perf_counter() - tc
                # the device computes this batch while the host stores the last one
                emb = enc(torch.from_numpy(b_ids[:, :seq]).to(device), torch.from_numpy(b_mask[:, :seq]).to(device))
                carry = carry + emb[:, 0].sum()
                if prev is not None:
                    put(*prev)
                    total += batch
                prev = (frags, emb)
        if prev is not None:
            put(*prev)
            total += batch
        float(carry)
        if len(store) != total:
            raise AssertionError(f"the pipeline stored {len(store)} chunks of {total}")
        return total, time.perf_counter() - t0, t

    with torch.inference_mode():
        pipeline()
        n_chunks, wall, host = pipeline()
    return {
        "ingest_chunks_per_s_per_chip": device_cps,
        "ingest_encoder": f"{cfg.depth}L x {cfg.dim}d -> {cfg.out_dim}d (trained)",
        "ingest_seq_len": seq,
        "ingest_batch": batch,
        "ingest_full_pipeline": {
            "chunks_per_s_full_pipeline": n_chunks / wall if n_chunks else None,
            "n_chunks": n_chunks,
            "n_documents": len(docs),
            "host_extract_s": host["extract"],
            "host_chunk_s": host["chunk"],
            "host_tokenize_s": host["tokenize"],
            "host_store_s": host["store"],
            "wall_s": wall,
            "text_source": source,
            "tokenizer": type(tok).__name__,
            "device_only_chunks_per_s": device_cps,
            "roofline_chunks_per_s_at_peak_bf16": roofline,
            "device_frac_of_roofline": device_cps / roofline if roofline else None,
        },
    }


def run(n: int = 1_245_184, d: int = 768, q: int = 128, q_big: int = 512, k: int = 100, steps: int = 16,
        device: str = "cuda", ingest: bool = True, ingest_batch: int = 1024, ingest_len: int = 256,
        ingest_docs: int = 300, seed: int = 0) -> dict:
    dev = resolve_device(device)
    if n % 16384:
        raise ValueError(f"n {n} is not a multiple of 16,384 (the kernels' slab granule)")
    gen = torch.Generator(device=dev).manual_seed(seed)
    lines = {}
    corpus = unit_rows(gen, (n, d), dev, torch.bfloat16)
    lines["bf16_q128"] = topk_lines(corpus, unit_rows(gen, (steps, q, d), dev, torch.bfloat16), k, dev)
    lines["bf16_q512"] = topk_lines(corpus, unit_rows(gen, (steps, q_big, d), dev, torch.bfloat16), k, dev)
    corpus = corpus.float()
    lines["f32_q128"] = topk_lines(corpus, unit_rows(gen, (steps, q, d), dev, torch.float32), k, dev)
    del corpus
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    big = lines["bf16_q512"]["segmented_topk"]
    result = {
        "metric": f"exact_top{k}_qps_{n}x{d}_bf16_per_chip",
        "kernel": "score_segmax_unmasked (csrc/score_segmax.cu) + segmented exact selection",
        "value": big["qps"],
        "unit": "qps",
        "vs_baseline": big["qps"] / REF_QPS,
        "batch_latency_ms": big["ms_per_step"],
        "query_batch": q_big,
        "q128_per_chip_qps": lines["bf16_q128"]["segmented_topk"]["qps"],
        "q128_batch_latency_ms": lines["bf16_q128"]["segmented_topk"]["ms_per_step"],
        "n": n,
        "shard_rows": SHARD,
        "steps": steps,
        "lines": lines,
        "approx99_per_chip_qps": None,
        "approx99_reason": "lax.approx_max_k (the TPU's approximate top-k) has no counterpart here; every line is exact",
        "projected_v5e8_qps": None,
        "projected_reason": "no projection: one card's shard measured at the N it ran",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    if ingest:
        result.update(ingest_lines(dev, ingest_batch, ingest_len, ingest_docs))
    result["server_e2e"] = None  # python -m rust_local_rag_tpu_torch.bench_server prints its own line
    return result


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_245_184)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--q", type=int, default=128)
    ap.add_argument("--q-big", type=int, default=512)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--no-ingest", action="store_true")
    ap.add_argument("--ingest-batch", type=int, default=1024)
    ap.add_argument("--ingest-len", type=int, default=256)
    ap.add_argument("--ingest-docs", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.d, args.q, args.q_big, args.k, args.steps, args.device, not args.no_ingest,
                         args.ingest_batch, args.ingest_len, args.ingest_docs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
