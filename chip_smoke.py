#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (rust_local_rag_tpu_torch) on one card.

    python3 chip_smoke.py [--seed 0] [--extra-chunks 33000]

Phases, in order; any failure ends the run with a non-zero exit code:

1. environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi); fails when torch.cuda.is_available() is false;
2. build: nvcc builds every kernel of the port from csrc/ (one process per
   source, started together); prints the seconds and the -Xptxas -v lines;
3. kernel vs plain: the masked score + segment-max kernel against
   score_segmax_plain on the card, N = 65,536, D = 768, Q in {1, 16, 128},
   f32 and bf16 slabs, freed slots next to the top hits;
4. the slice: RagEngine.create over the committed encoder, add_document for
   PDFs written here, then seeded chunks through embed_in_batches and the
   store + lexical index until more than 32,768 chunks are live (slab
   capacity 65,536, the kernel's branch of hybrid_topk); SearchBatcher
   answers bursts of 1, 16 and 64 queries at top_k 10 with the kernel's
   launch count reset just before and read just after; every batch is
   checked against the plain hybrid path on a CPU copy of the same slab,
   mask, query embeddings and lexical hits; a second engine's
   load_from_disk must give the same answers;
5. times (CUDA events, warm-up, median of repeats): kernel, plain version
   and library call against the bound; search latency per burst; ingest
   rate; each printed as a JSON line naming the card.

Every file except the kernel build goes to a temporary directory outside
the repository, removed at the end. The last line is the contract line
{"ok": true, "device": {...}}; the line before it is the card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import uuid
import zlib
from contextlib import contextmanager

import numpy as np
import torch

from rust_local_rag_tpu_torch.config import ResolvedWeights
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta
from rust_local_rag_tpu_torch.engine.rag_engine import PendingSearch, RagEngine
from rust_local_rag_tpu_torch.kernels import build
from rust_local_rag_tpu_torch.ops.fast_topk import segmented_select_from
from rust_local_rag_tpu_torch.ops.hybrid import _blend_union, hybrid_topk_packed, unpack_topk, uses_score_segmax
from rust_local_rag_tpu_torch.ops.score_segmax import SEG, score_segmax, score_segmax_plain
from rust_local_rag_tpu_torch.server.batcher import SearchBatcher
from rust_local_rag_tpu_torch.utils.rwlock import RwLock

N_SLAB = 65536
DIM = 768
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12      # f32 outside the tensor cores, H100 SXM data sheet
# Scores are dots of unit vectors summed in f32 in different orders by the
# kernel and by the plain version; each is within D * 2^-24 * |q| |c| of
# the exact value, so they differ by at most 2 * 768 * 2^-24 = 9.2e-5.
SCORE_TOL = 1e-4
KERNEL_SOURCE = "rust_local_rag_tpu_torch/csrc/score_segmax.cu"
KERNEL_REPLACES = "rust_local_rag_tpu/ops/pallas_topk.py:245"
BURSTS = (1, 16, 64)
TOP_K = 10

WORDS = """
pump valve pressure flow sensor motor bearing seal shaft impeller housing
gasket coupling filter strainer manifold pipe flange bolt torque alignment
vibration temperature lubrication grease oil viscosity coolant circuit
relay breaker fuse voltage current resistance insulation ground terminal
cable connector controller firmware parameter setpoint alarm fault reset
calibration inspection maintenance interval schedule procedure warning
caution operator technician manual section figure table chapter appendix
install remove replace tighten loosen check verify measure record adjust
clean drain fill vent purge isolate lock tag start stop run idle load
speed rotation direction clockwise counter frame base mount bracket guard
cover panel door hinge latch handle switch button indicator display screen
menu option setting mode automatic manual remote local network address
port protocol signal input output analog digital module channel range
scale offset gain filter response time delay cycle count limit threshold
level tank reservoir suction discharge inlet outlet nozzle orifice bypass
check relief safety emergency shutdown isolation fluid water steam air gas
corrosion wear fatigue crack leak noise overheating cavitation blockage
failure cause effect symptom remedy diagnosis repair spare part number
serial model revision date supplier warranty service support training
hydraulic pneumatic electrical mechanical thermal chemical structural
compressor turbine generator transformer conveyor gearbox chain belt pulley
sprocket roller spindle chuck tool fixture clamp jaw blade cutter drill
weld joint seam surface finish coating paint primer layer thickness gauge
micrometer caliper meter probe tester analyzer recorder logger camera
""".split()


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


@contextmanager
def phase(name: str, card: str, seconds: dict):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    seconds[name] = time.perf_counter() - t0
    log({"phase": name, "seconds": seconds[name], "card": card})


# ---------------------------------------------------------------- data ----


def make_pdf(pages) -> bytes:
    """Minimal multi-page text PDF, FlateDecode content streams (the same
    writer as tests/pdfgen.py)."""
    esc = lambda s: s.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")  # noqa: E731
    objects = [b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>"]
    content_nums = []
    for text in pages:
        ops = ["BT", "/F1 12 Tf", "72 720 Td"]
        for i, ln in enumerate(text.split("\n")):
            if i:
                ops.append("0 -16 Td")
            ops.append(f"({esc(ln)}) Tj")
        ops.append("ET")
        comp = zlib.compress("\n".join(ops).encode("latin-1"))
        objects.append(
            b"<< /Length " + str(len(comp)).encode() + b" /Filter /FlateDecode >>\nstream\n"
            + comp + b"\nendstream"
        )
        content_nums.append(len(objects))
    pages_num = len(objects) + len(pages) + 1
    page_nums = []
    for cn in content_nums:
        objects.append(
            f"<< /Type /Page /Parent {pages_num} 0 R /MediaBox [0 0 612 792] "
            f"/Resources << /Font << /F1 1 0 R >> >> /Contents {cn} 0 R >>".encode()
        )
        page_nums.append(len(objects))
    kids = " ".join(f"{p} 0 R" for p in page_nums)
    objects.append(f"<< /Type /Pages /Kids [{kids}] /Count {len(page_nums)} >>".encode())
    objects.append(f"<< /Type /Catalog /Pages {pages_num} 0 R >>".encode())
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, obj in enumerate(objects, start=1):
        offsets.append(len(out))
        out += f"{i} 0 obj\n".encode() + obj + b"\nendobj\n"
    xref = len(out)
    out += f"xref\n0 {len(objects) + 1}\n0000000000 65535 f \n".encode()
    for off in offsets:
        out += f"{off:010d} 00000 n \n".encode()
    out += (
        f"trailer\n<< /Size {len(objects) + 1} /Root {len(objects)} 0 R >>\n"
        f"startxref\n{xref}\n%%EOF\n"
    ).encode()
    return bytes(out)


def passages(rng: np.random.Generator, n: int, probs: np.ndarray, sentences=(9, 14)) -> list:
    """n passages of 9-13 sentences of 8-17 Zipf-weighted words each."""
    n_sent = rng.integers(*sentences, size=n)
    lengths = rng.integers(8, 18, size=int(n_sent.sum()))
    words = np.asarray(WORDS)[rng.choice(len(WORDS), int(lengths.sum()), p=probs)]
    ends = np.cumsum(lengths)
    sents = [" ".join(words[e - k : e]).capitalize() + "." for e, k in zip(ends.tolist(), lengths.tolist())]
    bounds = np.concatenate([[0], np.cumsum(n_sent)]).tolist()
    return [" ".join(sents[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def chunk_texts(rng: np.random.Generator, n: int, probs: np.ndarray) -> list:
    """n distinct chunk-sized passages (~120-200 words)."""
    return [f"Record {i:06d}. {p}" for i, p in enumerate(passages(rng, n, probs))]


def documents(rng: np.random.Generator, probs: np.ndarray) -> dict:
    """Three PDFs of four pages each: a heading and four paragraphs a page."""
    docs = {}
    for d in range(3):
        pages = []
        for p in range(4):
            heading = f"SECTION {d}.{p} {WORDS[rng.integers(len(WORDS))].upper()}"
            pages.append("\n\n".join([heading] + passages(rng, 4, probs, sentences=(5, 6))))
        docs[f"manual_{d}.pdf"] = make_pdf(pages)
    return docs


def queries_for(rng: np.random.Generator, n: int, probs: np.ndarray) -> list:
    return [
        " ".join(WORDS[i] for i in rng.choice(len(WORDS), rng.integers(3, 8), p=probs)) + f" q{j}"
        for j in range(n)
    ]


# --------------------------------------------------------------- checks ----


def unit_rows(gen: torch.Generator, n: int, d: int, device) -> torch.Tensor:
    x = torch.randn(n, d, generator=gen, device=device)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def kernel_case(seed: int, q: int, dtype: torch.dtype, device):
    """Unit corpus and queries near corpus rows; 10% of slots freed, plus
    the neighbours of every query's source row (next to its top hit)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    corpus32 = unit_rows(gen, N_SLAB, DIM, device)
    src = torch.randint(0, N_SLAB, (q,), generator=gen, device=device)
    queries = corpus32[src] + 0.05 * unit_rows(gen, q, DIM, device)
    queries = queries / torch.linalg.vector_norm(queries, dim=1, keepdim=True)
    mask = torch.rand(N_SLAB, generator=gen, device=device) > 0.1
    mask[(src + 1) % N_SLAB] = False
    mask[(src - 1) % N_SLAB] = False
    return queries.contiguous(), corpus32.to(dtype).contiguous(), mask


def check_kernel(queries, corpus, mask) -> float:
    """Kernel against the plain version; returns the max |score diff|."""
    scores, segmax = score_segmax(queries, corpus, mask)
    p_scores, p_segmax = score_segmax_plain(queries, corpus, mask)
    torch.cuda.synchronize()
    q = queries.shape[0]
    if tuple(scores.shape) != (q, N_SLAB) or tuple(segmax.shape) != (q, N_SLAB // SEG):
        raise AssertionError(f"kernel shapes {tuple(scores.shape)} {tuple(segmax.shape)}")
    want_inf = (~mask)[None, :].expand(q, -1)
    if not torch.equal(torch.isneginf(scores), want_inf):
        raise AssertionError("kernel: -inf is not exactly at the freed slots")
    if not torch.equal(segmax, scores.view(q, -1, SEG).amax(dim=2)):
        raise AssertionError("kernel: segmax is not the max of its own scores")
    live = ~want_inf
    err = float((scores[live] - p_scores[live]).abs().max())
    err_seg = float((segmax[torch.isfinite(p_segmax)] - p_segmax[torch.isfinite(p_segmax)]).abs().max())
    if not torch.equal(torch.isneginf(segmax), torch.isneginf(p_segmax)):
        raise AssertionError("kernel: segmax -inf pattern differs from plain")
    err = max(err, err_seg)
    if not err <= SCORE_TOL:
        raise AssertionError(f"kernel vs plain: max |diff| {err} > {SCORE_TOL}")
    return err


def rows_of(results, store) -> list:
    """SearchResults -> [(slot, combined, emb, lex)]."""
    return [
        (store.slot_for_id(r.chunk_id), r.score, r.embedding_score, r.lexical_score)
        for r in results
    ]


def same_topk(got: list, want: list, tol: float, what: str) -> None:
    """Equal result lists up to the score tolerance: sorted scores agree
    within tol, common rows agree within tol, and a row on one side only
    must tie (within tol) with the last score, so order and membership
    differ only between scores tied within the tolerance."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results, want {len(want)}")
    if not got:
        return
    gs = sorted((r[1] for r in got), reverse=True)
    ws = sorted((r[1] for r in want), reverse=True)
    if max(abs(a - b) for a, b in zip(gs, ws)) > tol:
        raise AssertionError(f"{what}: scores {gs} vs {ws}")
    g = {r[0]: r for r in got}
    w = {r[0]: r for r in want}
    floor = min(ws[-1], gs[-1])
    for key in set(g) ^ set(w):
        row = g.get(key) or w.get(key)
        if row[1] - floor > tol:
            raise AssertionError(f"{what}: row {key} ({row[1]}) on one side only, above the tie band")
    for key in set(g) & set(w):
        if max(abs(a - b) for a, b in zip(g[key][1:], w[key][1:])) > tol:
            raise AssertionError(f"{what}: row {key}: {g[key]} vs {w[key]}")


def plain_reference(pending, corpus_cpu, mask_cpu) -> list:
    """The same dispatch through the plain hybrid path on the CPU."""
    r: ResolvedWeights = pending.resolved
    out = hybrid_topk_packed(
        pending.q_emb.cpu(), corpus_cpu, mask_cpu,
        torch.from_numpy(pending.lex_slots), torch.from_numpy(pending.lex_vals),
        torch.tensor(r.embedding, dtype=torch.float32),
        torch.tensor(r.lexical, dtype=torch.float32),
        pending.kb,
    )
    vals, emb, lex, idx = unpack_topk(out.numpy(), pending.nq, pending.k)
    rows = []
    for qi in range(pending.nq):
        rows.append([
            (int(idx[qi, j]), float(vals[qi, j]), float(emb[qi, j]), float(lex[qi, j]))
            for j in range(pending.k)
            if idx[qi, j] >= 0 and np.isfinite(vals[qi, j])
        ])
    return rows


# --------------------------------------------------------------- timing ----


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card, each run between events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(q: int, corpus_itemsize: int):
    """(bound_ms, bound_by): each input read once, each output written once,
    against the card's memory rate; 2*Q*N*D f32 FMA ops against its f32
    rate outside the tensor cores."""
    nbytes = N_SLAB * DIM * corpus_itemsize + q * DIM * 4 + N_SLAB + q * N_SLAB * 4 + q * (N_SLAB // SEG) * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2 * q * N_SLAB * DIM / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(queries, corpus, mask):
    neg = ~mask
    scores = torch.mm(queries, corpus.float().t())
    scores.masked_fill_(neg[None, :], float("-inf"))
    return scores, scores.view(queries.shape[0], -1, SEG).amax(dim=2)


def stage_breakdown(engine, rng, probs, q: int = 16, reps: int = 5) -> dict:
    """Median ms of each stage of one hot-lane batch of q queries, every
    stage ended by a synchronise (host clock), the span of the hybrid stage
    between CUDA events, and its three parts (kernel, selection, blend)
    timed alone; then the ingest split between tokenising and the encoder
    forward for 1024 length-sorted chunks in batches of 128."""
    stages = {"encode_queries": [], "bm25": [], "hybrid_span": [], "hybrid_wall": [],
              "fetch_and_results": []}
    r = ResolvedWeights.from_query_weights(None)
    w_e = torch.tensor(r.embedding, dtype=torch.float32, device=engine.device)
    w_l = torch.tensor(r.lexical, dtype=torch.float32, device=engine.device)
    for _ in range(reps):
        qs = queries_for(rng, q, probs)
        t0 = time.perf_counter()
        q_emb = engine._prep_queries(qs, q)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        slots, vals = engine._prep_lexical(qs, TOP_K, q)
        t2 = time.perf_counter()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = hybrid_topk_packed(
            q_emb, engine.store.corpus(), engine.store.valid_mask(),
            torch.as_tensor(slots, device=engine.device), torch.as_tensor(vals, device=engine.device),
            w_e, w_l, 16,
        )
        b.record()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        col = engine.fetch_columnar(PendingSearch(
            out=out, nq=q, k=TOP_K, floor=0.0, q_emb=q_emb, lex_slots=slots, lex_vals=vals,
            resolved=r, kb=16,
        ))
        results = [engine.results_from_columnar(col, qi) for qi in range(q)]
        t4 = time.perf_counter()
        if sum(map(len, results)) != q * TOP_K:
            raise AssertionError("breakdown batch returned short result lists")
        for k, x in zip(stages, (t1 - t0, t2 - t1, a.elapsed_time(b) / 1e3, t3 - t2, t4 - t3)):
            stages[k].append(x)
    out = {f"batch{q}_{k}_ms": statistics.median(x) * 1e3 for k, x in stages.items()}
    # the hybrid stage's three parts on the last batch's inputs
    corpus, mask = engine.store.corpus(), engine.store.valid_mask()
    lex = [torch.as_tensor(x, device=engine.device) for x in (slots, vals)]
    masked, segmax = score_segmax(q_emb, corpus, mask)
    e_vals, e_idx = segmented_select_from(masked, segmax, 16)
    out[f"batch{q}_kernel_ms"] = cuda_ms(lambda: score_segmax(q_emb, corpus, mask))
    out[f"batch{q}_select_ms"] = cuda_ms(lambda: segmented_select_from(masked, segmax, 16))
    out[f"batch{q}_blend_ms"] = cuda_ms(lambda: _blend_union(masked, e_vals, e_idx, *lex, w_e, w_l, 16, 16))
    model = engine.embedding_service._model
    texts = sorted(chunk_texts(rng, 1024, probs), key=len)  # as embed_in_batches orders them
    t0 = time.perf_counter()
    batches = [model.tokenizer.encode_batch(texts[i : i + 128]) for i in range(0, 1024, 128)]
    t1 = time.perf_counter()
    with torch.inference_mode():
        for ids, m in batches:
            model.encoder(torch.from_numpy(ids).to(engine.device), torch.from_numpy(m).to(engine.device))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out.update({"ingest1024_tokenize_s": t1 - t0, "ingest1024_encoder_s": t2 - t1,
                "ingest1024_tokens": int(sum(m.sum() for _, m in batches)),
                "ingest1024_padded_tokens": int(sum(m.size for _, m in batches))})
    return out


# ----------------------------------------------------------------- main ----


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--extra-chunks", type=int, default=33000)
    args = ap.parse_args(argv)
    seconds: dict = {}

    log({"python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda})
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    with phase("environment", card, seconds):
        log(card)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        log({"device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
             "capability": list(torch.cuda.get_device_capability(0))})

    with phase("build", card, seconds):
        for res in build.build_all().values():
            log({"build": res.name, "seconds": res.seconds, "library": res.path.split("/")[-1]})
            for line in res.ptxas.splitlines():
                if line.strip():
                    log(f"ptxas| {line}")

    max_err = 0.0
    with phase("kernel_vs_plain", card, seconds):
        for dtype in (torch.float32, torch.bfloat16):
            for q in (1, 16, 128):
                err = check_kernel(*kernel_case(args.seed, q, dtype, dev))
                max_err = max(max_err, err)
                log({"kernel_check": "score_segmax_masked", "dtype": str(dtype), "Q": q,
                     "N": N_SLAB, "D": DIM, "max_abs_err": err, "tol": SCORE_TOL, "card": card})
        torch.cuda.synchronize()

    tmp = tempfile.mkdtemp(prefix="rag_port_smoke_")
    try:
        result = run_slice(args, dev, card, seconds, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    with phase("times", card, seconds):
        main_path = None
        for dtype in (torch.float32, torch.bfloat16):
            for q in sorted({1, 16, 128, result["main_q"]}):
                qs, corpus, mask = kernel_case(args.seed, q, dtype, dev)
                ms = cuda_ms(lambda: score_segmax(qs, corpus, mask))
                plain_ms = cuda_ms(lambda: score_segmax_plain(qs, corpus, mask))
                library_ms = cuda_ms(lambda: library_call(qs, corpus, mask))
                b_ms, b_by = bound(q, corpus.element_size())
                row = {"kernel_time": "score_segmax_masked", "dtype": str(dtype), "Q": q, "N": N_SLAB,
                       "D": DIM, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "card": card}
                log(row)
                if dtype == torch.float32 and q == result["main_q"]:
                    main_path = row
        for burst, lat in result["latency"].items():
            log({"search_burst": burst, "top_k": TOP_K, "median_ms": statistics.median(lat),
                 "min_ms": min(lat), "max_ms": max(lat), "reps": len(lat), "card": card})
        log({**result["ingest"], "card": card})
    log({"phase_seconds": seconds, "card": card})

    log({"kernels": [{
        "name": "score_segmax_masked",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": result["launches"],
        "max_abs_err": max_err,
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": main_path["library_ms"],
    }]})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


def run_slice(args, dev, card: str, seconds: dict, tmp: str) -> dict:
    rng = np.random.default_rng(args.seed)
    probs = 1.0 / np.arange(1, len(WORDS) + 1) ** 0.8
    probs = probs / probs.sum()
    rng.shuffle(probs)

    with phase("ingest", card, seconds):
        t0 = time.perf_counter()
        engine = RagEngine.create(tmp, device=dev)
        t_create = time.perf_counter() - t0
        n_pdf = 0
        for name, data in documents(rng, probs).items():
            n = engine.add_document(name, data)
            if n <= 0:
                raise AssertionError(f"add_document({name}) indexed no chunks")
            n_pdf += n
        texts = chunk_texts(rng, args.extra_chunks, probs)
        t0 = time.perf_counter()
        embs = engine.embedding_service.embed_in_batches(texts)
        torch.cuda.synchronize()
        t_embed = time.perf_counter() - t0
        metas = [
            ChunkMeta(id=str(uuid.UUID(int=int(rng.integers(2**63)) << 64 | i)),
                      document_name=f"records_{i // 1000:03d}", text=t, chunk_index=i % 1000)
            for i, t in enumerate(texts)
        ]
        t0 = time.perf_counter()
        engine.add_chunks(metas, embs)
        t_add = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine.save_to_disk()
        t_save = time.perf_counter() - t0
        live = len(engine.store)
        if not (live > N_SLAB // 2 and engine.store.capacity == N_SLAB and uses_score_segmax(N_SLAB)):
            raise AssertionError(f"{live} live chunks, capacity {engine.store.capacity}")
        if not np.isfinite(embs).all() or embs.shape != (args.extra_chunks, DIM):
            raise AssertionError("embeddings are not finite [n, 768]")
        ingest = {"ingest_chunks": len(texts), "pdf_chunks": n_pdf, "live_chunks": live,
                  "create_s": t_create, "embed_s": t_embed, "embed_chunks_per_s": len(texts) / t_embed,
                  "store_and_bm25_s": t_add, "save_s": t_save,
                  "ingest_chunks_per_s": len(texts) / (t_embed + t_add)}
        log(ingest)

    batcher = SearchBatcher(engine, RwLock())
    recorded = []
    dispatch = engine.dispatch_search

    def recording_dispatch(queries, top_k, *a, **kw):
        pending = dispatch(queries, top_k, *a, **kw)
        recorded.append((list(queries), pending))
        return pending

    try:
        with phase("search", card, seconds):
            bursts = {b: queries_for(rng, b, probs) for b in BURSTS}
            engine.dispatch_search = recording_dispatch
            score_segmax.launches = 0
            answers = {}
            for b in BURSTS:
                futs = [batcher.submit(q, TOP_K, 0.0, None, use_reranker=False) for q in bursts[b]]
                for q, f in zip(bursts[b], futs):
                    answers[q] = f.result(timeout=300)
            launches = score_segmax.launches
            engine.dispatch_search = dispatch
            log({"launches": {"score_segmax_masked": launches}, "dispatches": len(recorded),
                 "batch_sizes": [len(qs) for qs, _ in recorded]})
            if launches <= 0:
                raise AssertionError("the search path never launched the score_segmax kernel")
            for q, res in answers.items():
                if len(res) != TOP_K or not all(np.isfinite(r.score) for r in res):
                    raise AssertionError(f"query {q!r}: {len(res)} results, want {TOP_K} finite")

        with phase("check_plain", card, seconds):
            corpus_cpu = engine.store.corpus().cpu()
            mask_cpu = engine.store.valid_mask().cpu()
            for queries, pending in recorded:
                for q, want in zip(queries, plain_reference(pending, corpus_cpu, mask_cpu)):
                    same_topk(rows_of(answers[q], engine.store), want, SCORE_TOL, f"plain vs kernel {q!r}")
            log({"checked_against_plain": sum(len(qs) for qs, _ in recorded)})

        with phase("reload", card, seconds):
            engine2 = RagEngine(tmp, engine.embedding_service, device=dev)
            if len(engine2.store) != len(engine.store):
                raise AssertionError(f"reload: {len(engine2.store)} chunks, want {len(engine.store)}")
            qs = bursts[16]
            for q, a, b in zip(qs, engine.search_batch(qs, TOP_K, use_reranker=False),
                               engine2.search_batch(qs, TOP_K, use_reranker=False)):
                ka = [(r.chunk_id, r.score, r.embedding_score, r.lexical_score) for r in a]
                kb = [(r.chunk_id, r.score, r.embedding_score, r.lexical_score) for r in b]
                same_topk(ka, kb, SCORE_TOL, f"reload {q!r}")
            log({"reload_checked": len(qs)})
            del engine2

        with phase("latency", card, seconds):
            latency = {}
            for b in BURSTS:
                lat = []
                for rep in range(6):
                    qs = queries_for(rng, b, probs)
                    t0 = time.perf_counter()
                    futs = [batcher.submit(q, TOP_K, 0.0, None, use_reranker=False) for q in qs]
                    for f in futs:
                        f.result(timeout=300)
                    if rep:  # the first burst of a size is a warm-up
                        lat.append((time.perf_counter() - t0) * 1e3)
                latency[b] = lat

        with phase("breakdown", card, seconds):
            breakdown = stage_breakdown(engine, rng, probs)
            log({**breakdown, "card": card})
    finally:
        batcher.stop()
        engine.embedding_service.close()
    # the query batch the kernel saw most often on the main path
    padded = [p.out.shape[0] for _, p in recorded]
    return {"launches": launches, "latency": latency, "ingest": ingest, "breakdown": breakdown,
            "main_q": max(set(padded), key=padded.count)}


if __name__ == "__main__":
    sys.exit(main())
