#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (rust_local_rag_tpu_torch) on one card.

    python3 chip_smoke.py [--seed 0] [--extra-chunks 33000]

Phases, in order; any failure ends the run with a non-zero exit code:

1. environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi); fails when torch.cuda.is_available() is false;
2. build: nvcc builds every kernel of the port from csrc/*.cu and g++ its
   three host libraries from csrc/*.cpp (the BM25 index, the WordPiece
   tokenizer and the response serializer; one process per source,
   started together); prints the
   seconds and the -Xptxas -v lines;
3. kernel vs plain: the masked and the unmasked score + segment-max
   kernels against their plain versions on the card, N = 65,536, D = 768,
   Q in {1, 16, 128}, f32 and bf16 slabs, freed slots next to the top
   hits; then at the edges of the Q <= 16 stream: every query tile and the
   step to the Q > 16 body (Q 1, 2, 3, 5, 8, 9, 15, 16, 17), N 65,536 and
   65,920 (not a multiple of the stream's stride), D 768 and 776 (ragged
   against its tile depth), with one segment wholly freed, and slabs with
   every slot freed; then the tensor-core body on bf16 slabs at the same
   shapes and freed slots, with f32 queries (three bf16 terms) at Q 17,
   32, 64, 128, 129 and 512 and bf16 queries (one term) at those and Q 1
   and 16; the f32 FMA body on f32 slabs with f32 queries at Q 17, 32, 64,
   128, 129 and 512 at the same shapes and freed slots; both entries at
   Q 17 on an f32 slab of 65,537 segments (8,388,736 rows, 25.8 GB: one
   past what a grid's y could hold), freed afterwards; the attention
   kernel against attention_plain at every
   shape the path gives it (reranker causal H 6 L 192, encoder H 8 L 64 /
   256 / 512), with a length-1 row and an all-masked row, then at edge
   shapes (L 1, 17, 100, 257, 500, 512; B 1 and 3; causal and not) and,
   under causal, with masks that are not prefixes (key 0 masked and later
   keys valid, a row masked in its first half, a row with no valid key);
4. the slice: RagEngine.create over the committed encoder (the native
   WordPiece tokenizer and the native BM25 index, checked), add_document
   for PDFs written here, then seeded chunks through embed_in_batches and
   the store + lexical index until more than 32,768 chunks are live (slab
   capacity 65,536, the kernel's branch of hybrid_topk), one save of that
   index (seconds and bytes); engine.warmup();
   lexical_check (its queries, and those of every phase added with it,
   from a stream of their own, so earlier phases keep theirs): a
   pure-Python BM25 index over the same chunks and slots against the
   native one on 256 seeded queries (some non-ASCII; same slot sets,
   scores within rel 1e-5, unseen mass within 1e-6), then 8 threads
   scoring at once against the sequential answers; tokenizer_check: the
   native tokenizer against the pure-Python one over the chunk texts and
   one judged batch's prompts (identical ids; the routed count printed);
   SearchBatcher answers bursts of 1, 16 and 64 queries at top_k 10 with
   the kernel's launch count reset just before and read just after; every
   batch is checked against the plain hybrid path on a CPU copy of the
   same slab, mask, query embeddings and lexical hits; a second engine's
   load_from_disk (then its warmup) must give the same answers;
   bf16_wide: another engine loads the saved index with
   RAG_TPU_CORPUS_DTYPE=bf16 behind a SearchBatcher of max batch 64; one
   burst of 64 queries must run a Q 64 batch through the masked kernel's
   tensor-core body (launches counted), every batch equal to the plain
   hybrid path on a CPU copy; then 64-bursts timed through it and through
   a batcher of max batch 16 on the same engine; f32_wide: the same on
   the saved index's default f32 slab (RAG_TPU_CORPUS_DTYPE=f32), whose
   Q 64 batch runs the masked kernel's f32 FMA body; int8: the saved
   index as an int8 store (RAG_TPU_INT8_CORPUS=1) behind a SearchBatcher:
   bursts of 1, 16 and 64 with no score + segment-max launch (counted),
   every batch equal to a CPU copy of the int8 engine and to a brute-force
   scan of the dequantised slab on the card (1e-4), the judged and object
   lanes (16 queries, RAG_TPU_FUSED_ATTN=1) against a CPU copy under the
   rerank_check rules, MMR bursts (top_k 10 and 100) on the object lane
   against the CPU copy's, get_embedding_candidates, a save and reload
   (within 2e-3), bursts timed beside the f32 engine's, and an engine of
   its own holding tests/test_int8_exact.py's band at D 768 among 20,000
   seeded rows: the band's query must fail its certificate, escalate
   (counted) and equal the scan within 1e-6, a random query certify;
5. the rerank-on lanes, with RAG_TPU_FUSED_ATTN=1 and the committed
   reranker: encoder_fused holds the encoder with the attention kernel
   against the encoder without it (1,024 ingest chunks and a query batch,
   cosine > 0.999); judged (reranker weight 0, unseen gate 0.35 / 0.6 /
   0.2, threshold 0) and object (the default 0.7 / 0.3 blend) send bursts
   of 1, 16 and 64 queries through SearchBatcher, with the launch counts
   reset just before and read just after (attention launches = 4 x judge
   forwards + 6 x query-encoder forwards); rerank_check replays every
   batch with the kernel off on the card and the first batch of each lane
   on a CPU copy; every fallback counter must stay 0; the judge forward is
   timed with the kernel and without it at the lanes' 16-query batches;
   then the MMR lane: the first 64 chunks are added once more (the same
   texts and rows: pools with exact duplicates) and the MMR hot lane
   (diversity 0.3, rerank off) answers bursts of 1, 16 and 64 queries at
   top_k 10, a 16-query burst whose pools hold duplicate chunks, and a
   16-query burst at top_k 100 (BASELINE.json config 2), the kernel's
   launches counted; every MMR batch is checked against a CPU copy's
   object lane (same ordered slots, scores within 1e-4; a divergence is
   allowed only where the two picks' MMR values tie within 2e-4, printed
   and counted);
6. the server tier, on a copy of the saved index with the committed
   models and RAG_TPU_FUSED_ATTN=1: server_start (build_runtime,
   prepare: the worker supervisor, warmup and every response fragment,
   then HttpServer.run, the serve loop of main, on a thread; seconds
   until /readyz answers 200); entry_point (`python -m
   rust_local_rag_tpu_torch` on its own copy: ready, one hot-lane answer
   equal to the in-process server's; then its saved index is cut back to
   32,000 chunks on disk, so the 33,033 it serves are a state no save
   covers, and SIGTERM must log a completed flush save within the 5 s
   budget, exit 0 and leave every served chunk on disk: ROADMAP C8);
   reindex (the three PDFs and two new ones: POST
   /reindex until the job completes, /jobs/active null, a second reindex
   hash-skips all five with the chunk count unchanged, an MCP session's
   GET /mcp stream receives both completions, progress_tracking.log has
   their lines); http_check (a burst of 16 in each of the hot, MMR,
   judged and object lanes over HTTP, sent as http_latency's are,
   against the in-process batcher on the same engine and query rows: hot
   and MMR equal within 1e-6 up to ties, judged and object under the
   rerank_check rules with differences printed and counted; MCP
   initialize, tools/list, search_documents equal to
   format_search_results of the batcher's answer, get_stats,
   get_job_status, calibrate_reranker; bad bodies 400; the launch counts
   reset just before each HTTP burst and each MCP search_documents /
   calibrate_reranker call and read just after it, before anything runs
   in process: the masked kernel and attention above 0 for each,
   attention launches = 4 x judge forwards + 6 x query-encoder forwards,
   judge forwards only in the lanes that rerank; the serializer against
   json.dumps of to_dict on one 16-query batch); http_latency (bursts of
   1, 16, 64 keep-alive clients in the hot and judged lanes, sent by a
   client process of its own, every request of a burst released at once,
   median of 5, beside the in-process median of the same run, with the
   batch sizes and arrival spread the batcher saw); gate_check (ROADMAP
   C2: a second runtime reindexes the eval corpus, 31 authored documents
   and 45 distractors, over HTTP; the 168 dev queries go one at a time
   with baseline.yaml's parameters, once through the judged lane
   (diversity 0 in the body) and once with the eval harness's own body
   (no diversity_factor: the object lane with MMR at the server's
   default 0.3); in each pass the 15 rejection queries and the first 33
   retrieval queries are replayed in process on the card, which must
   decide as the HTTP answers did, and on a CPU copy under the
   rerank_check rules);
7. segmented_topk: the unmasked kernel's own path (bench.py's exact
   top-k) at Q 1, 16 and 128 on an f32 slab and Q 128 on a bf16 slab,
   checked against torch.topk over the full scores; then the
   exact top-k experiments (scripts/exp_*.py, ported in
   rust_local_rag_tpu_torch/experiments/) at their shape, N 1,245,184,
   D 768, Q 128, bf16: experiments_check holds the segment-max kernel
   (exact), the streaming score + segment-max kernel in every layout,
   seg and operand order (scores within 1e-4 of the largest plain score,
   maxima exactly those of its own scores), the resident-block dot probe
   (within 1e-4, every chunk identical; at Q 1, 17, 64, 128, blk 2,048,
   4,096, 16,384, natural on and off, slots 2 and 4, and at small shapes:
   D 64 and 1,472, Q 65 and 100, 3 chunks) and the
   read probe (exact) against
   their plain versions, the split pipeline against torch.topk over the
   same scores, and split2.stream_fused (the unmasked kernel's tensor-core
   body with bf16 queries) against the GEMM's scores and its selection
   against torch.topk; experiments runs every sweep of every module's main
   with the launch counts set to 0 just before and read just after;
   experiments_times times each new kernel, its plain version and a
   library call beside its bound, and fails unless the dot probe takes at
   least 1.8 times as long at N 1,245,184 as at N 622,592 (every chunk's
   product is computed);
8. times (CUDA events around a back-to-back run of calls, after a
   warm-up, median of repeats, per call): each kernel, its plain version
   and a library call against the bound (score + segment-max at Q 1, 2,
   4, 8, 16 and 128, f32 and bf16, with a plain read of the slab beside
   them; the tensor-core body on bf16 slabs at Q 64 (N 65,536) and Q 128
   and 512 (N 1,245,184) with f32 and bf16 queries, beside one library
   GEMM to f32 + amax and, for f32 queries, the split terms' three bf16
   GEMMs; the f32 FMA body on f32 slabs at Q 64 and 512 (N 65,536) and
   Q 128 (N 1,245,184), beside f32 mm (TF32 off) + amax; then checked and
   timed at bench.py's shard, N 1,245,184, Q 16),
   and for attention also the span of a single call (host enqueue
   included, the measure of earlier runs) in one table; search latency
   per burst, rerank burst latency per lane and a stage breakdown; ingest
   rate; MMR burst latency and the MMR lane's stage spans; each printed as
   a JSON line naming the card. A host_libs line gives the three host
   libraries' build seconds and times against their pure-Python twins
   (the serializer against json.dumps of to_dict);
9. int8_scale: 10,010,624 x 768 seeded unit rows quantised on the card
   (7.69 GB, ~1% of slots freed): hybrid_topk_quantized_packed at Q 16
   and 64, top_k 10 and 100, with 512 distinct lexical hits a query; each
   certified query against a row-blocked f32 scan (1e-5), each other one
   through hybrid_topk_dequant_full against it; the times of the call and
   its parts (_int_mm, the planes, the selection) against the 2.32 ms
   bound, peak memory above the slab, the _int_mm kernels torch.profiler
   sees; the band planted once more, whose query fails its certificate
   and escalates at Q 1 (timed; under 4 GB above the slab); the bf16
   masked kernel at the same N on a slab of its own;
10. the slice of SRX, the PDF tiers, profiling, the eval harness and the
   benches: trace (the last phase of the slice, on the served index: one
   utils/profiling.device_trace window over 5 hot-lane bursts and one
   judged burst of 16 queries in the default configuration, the device's
   busy and idle share of each lane's span and of the window, the top
   device operations and the longest idle gaps with the host operation
   over each; entry_point has already made one POST /capture to the
   RAG_TPU_PROFILE_PORT listener of its `python -m` server while it
   answered searches, whose trace must hold the server's kernels); srx
   (which splitter RAG_TPU_SRX_FILE gives on this host, and chunk_text
   under tests/test_srx_engine.py's ruleset against that splitter);
   pdf_tiers (the pdftext library's build; the native tier against the
   built-in one, byte for byte, on the smoke's PDFs and the eval
   corpus's; ms a document each; pdftotext on PATH or not); quality
   (evaluation.quality --heldout against a `python -m` server on the
   card, RAG_TPU_FUSED_ATTN unset: each config's summary and the queries
   that differ from the JAX package's round-5 reports); bench (at
   bench.py's N 1,245,184 with 4 chained steps; every line's last step
   against torch.topk of the plain plane) and bench_server (131,072
   chunks, 4 s a point), each printed as its program's JSON line;
11. sharded (right after trace, on the slice's engine): corpus sharding
   with its shards standing on the one card (the lines say "stand_in").
   sharded_functions: 1,310,720 x 768 seeded unit rows (4.03 GB f32, a
   bf16 and an int8 copy; 1% freed, slots next to the top hits freed),
   512 lexical hits a query (one on its own row); meshes of 4 shards
   ("corpus"), 2 x 4 ("slice", "corpus") and 2 x 4 ("data", "corpus")
   over the card; at Q 1, 16 and 64 (padded to the data blocks as the
   engine pads) and top_k 10 and 30, sharded_hybrid_topk on the f32 and
   bf16 slabs with and without the candidates' similarities,
   sharded_hybrid_topk_quantized (certified rows) and
   sharded_hybrid_topk_dequant_full on the int8 slab, sharded_topk and
   multislice_topk (the padded tail masked), each against the unsharded
   function on the card (same_topk at 1e-4; similarities where the
   candidates agree), the masked kernel's launches zeroed just before
   each sharded call and read just after (one a shard a data block, none
   on int8); sharded_times: the 4-shard f32 first stage against the
   unsharded one at Q 16 and 64 (CUDA events), the merge alone on
   candidate planes of the same shapes, and the peak memory each call
   adds above the slab. sharded_engines: the warn path
   (RAG_TPU_SHARD_CORPUS=4 on the one card must log the JAX warning and
   answer as the unsharded engine), then four engines over the main
   engine's chunks (slab capacity 262,144; its lexical index shared):
   4 shards, 2 query replicas x 4 shards, 2 slices x 4 shards, and
   4 shards of int8, each through SearchBatcher in 16- and 64-bursts
   (rerank off, rerank on with the judge, MMR at 0.3) with
   the launches counted a burst, against the unsharded engine on the
   card and a CPU copy of the same sharded engine (the CPU mesh; the
   card's encoder and judge), every request on the object lane; the
   4-shard engine saved and reloaded;
12. train (after bench_server): the trainers at the committed assets'
   widths on the first 20,000 lines of .cache/train_corpus.txt, every cut
   from the JAX defaults in the phase's first line. train_step_check: one
   hard-negative InfoNCE step of the committed encoder on 64 pairs of the
   trainer's own batcher (PairBatcher.mixed_hn_batch over its train
   split; the BM25 premine it writes is the one the trainer below reads)
   and one pairwise + calibration step of the committed judge on 64
   prompt pairs, each on the card and on a CPU copy: losses within 2e-2,
   the gradients' global cosine >= 0.999 and each parameter's >= 0.99;
   train_sharded: the committed encoder's step on a (1, 1) ("data",
   "model") mesh against the plain module's, under the same bounds, then a
   seeded encoder at the committed widths with a vocabulary of 8,192 rows
   (the committed 8,193 does not divide over a model axis of 2, which the
   port refuses as JAX does; ids past it become [UNK]) on a (2, 2) mesh
   standing on the card against its (1, 1) mesh: loss within 5e-3,
   gradients' global cosine >= 0.9995; train_encoder and train_reranker: `python -m
   rust_local_rag_tpu_torch.training.<trainer>` (cold start, default
   widths, RAG_TPU_FUSED_ATTN=1 in its environment), which must exit 0
   with finite losses, the last dispatch's below the first, 0 attention
   launches, a checkpoint whose reload differs by at most f16 rounding
   and that the serving loaders load and serve; each trainer's summary
   line (steps/s, pairs/s, peak memory, each dispatch's host / device
   split) is printed;
13. the last modules of the JAX package: tok (after train): `python -m
   rust_local_rag_tpu_torch.training.tok` on .cache/train_corpus.txt,
   two runs at once, whose piece set must be the committed
   tokenizer.json's (symmetric difference 0), whose files must be byte
   for byte the same, and whose file must load in the port's WordPiece
   tokenizers with "yes" and "no" one piece each and both tokenizers
   giving the same ids on 2,000 corpus lines (seconds, sizes and the
   difference printed); tui (inside entry_point, against its `python -m`
   server): the terminal client's Controller and ApiClient headless: the
   typed query's debounced search equal to /search's answer to the same
   body (1e-6), stats and health, a reindex from the Controller pushed to
   `completed` over watch_jobs, one frame of each mode drawn onto a
   recording screen, then `python -m rust_local_rag_tpu_torch.tui` in a
   pseudo-terminal (drawn, the query's first result shown, Esc exits 0),
   with no kernel launch in this process; eval_cli (inside quality, while
   its server serves): `python -m rust_local_rag_tpu_torch.evaluation.run`
   list-configs, check (exit 0, ready, 168 queries) and evaluate with
   bm25_only.yaml, whose summary must equal the quality phase's; and in
   bench_server, scripts/bench_server.py's engine lines (the object lane
   at 128 and 512 queries, the MMR hot lane pipelined at 64 and 512, the
   object lane with the judge at 128), each with the masked kernel's
   launches, which must be above 0 in each;
14. the model-update loop (rust_local_rag_tpu_torch/tools/, ROADMAP C13):
   sweep (after quality): tools.sweep_rejection at thresholds 0.0 and
   0.06 against `python -m rust_local_rag_tpu_torch` over the eval corpus,
   each point's hit, mrr and rejection in [0, 1] and the threshold-0 point
   (baseline.yaml itself) equal to quality's baseline; model_paths (after
   train, on its checkpoints): build_default_service / build_default_reranker
   with ENCODER_WEIGHTS / RERANKER_WEIGHTS naming them must serve the
   embeddings and yes-p of the same files loaded by explicit path (within
   1e-6) and not the committed encoder's, and a named file that does not
   exist the seeded random init with JAX's log line; calibration:
   tools.judge_dev builds the dev heads (168 queries x 15) with the
   committed encoder into a cache of this run, then judge_dev's and
   gate_grid's mains with RAG_TPU_FUSED_ATTN=1 (attention launches counted,
   above 0), every candidate's yes-p with the kernel within RR_TOL of the
   same fused path with attention_plain in the kernel's place, the gap to
   the plain path (RAG_TPU_FUSED_ATTN unset, f32 q.k) recorded with the
   gate table it gives, and the gate table's headline numbers; scale_check:
   tools.scale_check at 100,000 rows (capacity 131,072: the masked kernel,
   counted, above 0), oracle PASS, ms a query and qps; soak: tools.soak
   for 20 s against `python -m rust_local_rag_tpu_torch` (committed models,
   RAG_TPU_FUSED_ATTN=1) over 6 eval documents, one of them rewritten and
   reindexed each cycle: 0 errors and the final revision served;
15. the last scripts of ROADMAP A: topk_profiles (after
   experiments_times): experiments.profile_topk, qscale, qscale2 and
   blockn at the bench shard, N 1,245,184 bf16, freed after (qscale's and
   qscale2's mains raise unless segmented_topk at Q 512 and 1,024 equals
   torch.topk over the kernel's scores and holds to the plain plane), then
   profile_topk's pipeline against the same; xla_studies:
   experiments.rw_segmax, xla_blocked, xla_segmax and partialreduce at the
   bench shard, each main's check fatal, row 2's kernel timed beside each
   (the unmasked kernel's launches counted over both phases); after soak,
   engine_profiles: tools.server_profile and tools.dispatch_profile (QB
   512) on one engine of bench_server's smoke size (131,072 chunks, f32
   slab), the masked kernel's launches counted and above 0; ceilings:
   tools.stack_ceiling (null, and bm25 over 131,072 Zipf texts),
   http_ceiling, proto_ceiling and reuseport, each `python -m` for a few
   seconds in a session of its own: exit 0, 0 errors, nothing left in its
   session, its port free. Phase 3 holds the tensor-core body at Q 1,024
   too (f32 and bf16 queries, N 65,536 and 65,920), and the times table
   adds it at Q 256 and 1,024 on the bench shard with bf16 queries. The
   phase_seconds line gives the total.

Every file except the kernel build goes to a temporary directory outside
the repository, removed at the end. The last line is the contract line
{"ok": true, "device": {...}}; the line before it is the card.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import http.client
import json
import logging
import os
import pty
import re
import select
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import uuid
import zlib
from contextlib import ExitStack, contextmanager

import numpy as np
import torch

import rust_local_rag_tpu_torch.models.encoder as encoder_module
from rust_local_rag_tpu_torch.experiments import (
    blockn,
    common as exp_common,
    dma_probe,
    isolate2,
    isolate_kernel,
    partialreduce,
    profile_topk,
    qscale,
    qscale2,
    rw_segmax,
    split2,
    split_pipeline,
    stream_kernel,
    xla_blocked,
    xla_segmax,
)
from rust_local_rag_tpu_torch.config import QueryWeights, ResolvedWeights, get_embedding_model
from rust_local_rag_tpu_torch.engine import persistence
from rust_local_rag_tpu_torch.engine.chunk_store import ChunkMeta, ChunkStore
from rust_local_rag_tpu_torch.engine.rag_engine import PendingSearch, RagEngine, _bucket_k
from rust_local_rag_tpu_torch.kernels import build
from rust_local_rag_tpu_torch.models.encoder import Encoder, default_asset, load_encoder_checkpoint
from rust_local_rag_tpu_torch.models.native_tokenizer import NativeWordPieceTokenizer
from rust_local_rag_tpu_torch.models.reranker import TransformerReranker, load_reranker_checkpoint
from rust_local_rag_tpu_torch.models.reranker_service import (
    DEFAULT_PROMPT_TEMPLATE,
    RerankerCandidate,
    RerankerService,
)
from rust_local_rag_tpu_torch.models.tokenizer import WordPieceTokenizer, load_tokenizer
from rust_local_rag_tpu_torch.ops import attention as attention_ops
from rust_local_rag_tpu_torch.ops.attention import attention_plain, fused_attention
from rust_local_rag_tpu_torch.ops.bm25 import LexicalIndex
from rust_local_rag_tpu_torch.ops.fast_topk import segmented_select_from
from rust_local_rag_tpu_torch.ops.hybrid import (
    F32_EPSILON,
    _blend_union,
    _int8_p1,
    _int8_upper,
    _next_pow2,
    _select,
    hybrid_topk,
    hybrid_topk_dequant_full,
    hybrid_topk_packed,
    hybrid_topk_packed_mmr,
    hybrid_topk_quantized_packed,
    unpack_topk,
    uses_score_segmax,
)
from rust_local_rag_tpu_torch.ops.mmr import mmr_select_batch
from rust_local_rag_tpu_torch.ops.native_bm25 import NativeLexicalIndex
from rust_local_rag_tpu_torch.ops.quantized import gather_dequantized, int8_scores, quantize_corpus, quantize_rows
from rust_local_rag_tpu_torch.ops.score_segmax import (
    SEG,
    STREAM_MAX_Q,
    fused_score_segmax,
    fused_score_segmax_plain,
    score_segmax,
    score_segmax_plain,
    segmented_topk,
    split_terms_plain,
)
from rust_local_rag_tpu_torch.ops.segmax import segmax, segmax_plain
from rust_local_rag_tpu_torch.ops.stream_probe import (
    read_probe,
    read_probe_plain,
    resident_dot_feed_bytes,
    resident_dot_plain,
    resident_dot_segmax,
    stream_segmax,
    stream_segmax_plain,
)
from rust_local_rag_tpu_torch.parallel import mesh as mesh_module
from rust_local_rag_tpu_torch.parallel import sharded_search
from rust_local_rag_tpu_torch.parallel.mesh import build_mesh
from rust_local_rag_tpu_torch.parallel.multislice import multislice_topk
from rust_local_rag_tpu_torch.parallel.sharded_search import (
    shard_corpus,
    sharded_hybrid_topk,
    sharded_hybrid_topk_dequant_full,
    sharded_hybrid_topk_quantized,
    sharded_topk,
)
from rust_local_rag_tpu_torch.parallel.train import info_nce_loss_hn, place_batch, shard_params
from rust_local_rag_tpu_torch.server.app import build_runtime, prepare
from rust_local_rag_tpu_torch.server.batcher import SearchBatcher
from rust_local_rag_tpu_torch.server.fastpath import HttpServer
from rust_local_rag_tpu_torch.server.formatting import format_search_results
from rust_local_rag_tpu_torch.server.http_api import App
from rust_local_rag_tpu_torch.training.pairs import PairBatcher
from rust_local_rag_tpu_torch.training.train_encoder import load_training_paragraphs, split_holdout
from rust_local_rag_tpu_torch.training.train_reranker import PromptPairBatcher, decision_ids, pair_loss
from rust_local_rag_tpu_torch.utils.rwlock import RwLock

from eval_harness.corpus import generate_corpus

N_SLAB = 65536
DIM = 768
# edges of the Q <= 16 stream: every query tile and the step to the Q > 16
# body; a row count that is not a multiple of its stride (132 SMs x 128
# rows) and a depth that is ragged against its tile (64 f32, 128 bf16)
EDGE_Q = (1, 2, 3, 5, 8, 9, 15, 16, 17)
EDGE_SHAPES = ((65536, 768), (65920, 768), (65536, 776), (65920, 776))
# the tensor-core body on bf16 slabs: its query tiles (64 queries at Q <= 64,
# 128 beyond, Q 129 and 512 several), f32 queries (three bf16 terms) and
# bf16 queries (one term; at any Q, so Q 1 and 16 too), at EDGE_SHAPES
WIDE_Q = (17, 32, 64, 128, 129, 512)
BF16_QUERY_Q = (1, 16) + WIDE_Q
# the tensor-core body's widest batch (experiments/qscale's Q 1,024: eight
# query tiles), f32 and bf16 queries, at the stream's two row counts
WIDEST_Q = (1024,)
WIDEST_SHAPES = ((65536, 768), (65920, 768))
# the tensor-core body timed: the serving shape at a batch of 64
# (RAG_TPU_BATCH_MAX=64), bench.py's shard at its Q 128 and 512
WIDE_TIMES = ((64, 65536), (128, 1245184), (512, 1245184))
# and at experiments/qscale's new widths, bf16 queries (its case)
QSCALE_TIMES = ((256, 1245184), (1024, 1245184))
# the f32 FMA body timed (f32 slab, f32 queries): a batch of 64, Q 512 at
# the serving slab, bench.py's shard at Q 128 (Q 128 at N 65,536 is in TIME_Q)
F32_WIDE_TIMES = ((64, 65536), (512, 65536), (128, 1245184))
# an f32 slab of 65,537 segments (25.8 GB), one past a grid's y limit, at
# the first Q past the stream
N_BIG = 65537 * 128
BIG_Q = 17
WIDE_BATCH = 64  # bf16_wide: the batcher's max batch
TIME_Q = (1, 2, 4, 8, 16, 128)
N_BENCH = 1245184  # bench.py's 1,250,000-row shard cut to a multiple of 16,384
# ~2 ms of the card's clock (1,980 MHz): the host enqueues a timed run of
# calls meanwhile
AHEAD_CYCLES = 4_000_000
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12      # f32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12    # bf16 tensor cores, dense, H100 SXM data sheet
H100_INT8_OPS = 1979e12     # int8 tensor cores, dense, H100 SXM data sheet
# exps on the SFU: 16 a clock on each of 132 SMs, at the 1.83 GHz at which
# the data sheet's bf16 tensor peak holds (132 SMs x 4,096 x 1.83e9 = 989e12)
H100_EXPS_PER_S = 132 * 16 * 1.83e9
# Scores are dots of unit vectors summed in f32 in different orders by the
# kernel and by the plain version; each is within D * 2^-24 * |q| |c| of
# the exact value, so they differ by at most 2 * 768 * 2^-24 = 9.2e-5.
SCORE_TOL = 1e-4
KERNEL_SOURCE = "rust_local_rag_tpu_torch/csrc/score_segmax.cu"
KERNEL_REPLACES = "rust_local_rag_tpu/ops/pallas_topk.py:245"
UNMASKED_REPLACES = "rust_local_rag_tpu/ops/pallas_topk.py:117"
ATTN_SOURCE = "rust_local_rag_tpu_torch/csrc/attention.cu"
ATTN_REPLACES = "rust_local_rag_tpu/ops/attention.py:105"
# the exact top-k experiments (scripts/exp_*.py) at their shape: N_BENCH
# rows, D 768, Q 128, bf16 slab and queries, f32 scores
SEGMAX_SOURCE = "rust_local_rag_tpu_torch/csrc/segmax.cu"
STREAM_SOURCE = "rust_local_rag_tpu_torch/csrc/stream_probe.cu"
SEGMAX_REPLACES = "scripts/exp_split_pipeline.py:30"
STREAM_REPLACES = "scripts/exp_stream_kernel.py:27"
PROBE_REPLACES = "scripts/exp_dma_probe.py:19"
RESIDENT_SOURCE = "rust_local_rag_tpu_torch/csrc/resident_dot.cu"
RESIDENT_REPLACES = "scripts/exp_isolate_kernel.py:34"
# the dot probe's cases (Q, blk, natural, slots) at N_BENCH, D 768: its
# query halves (Q 1, 17 inside one, 64 one whole, 128 two), blk as the
# experiments set it (2,048, 4,096, 16,384), both operand orders and two
# ring depths; and small shapes (Q, N, D, blk, natural): D 64 (one stage a
# product), the largest D the kernel takes (a ring of two stages), a second
# query half of one query, and 3 or 1 chunks (a unit's last chunks not stored)
RESIDENT_CASES = ((128, 2048, False, 2), (128, 4096, False, 2), (128, 4096, True, 2), (1, 2048, False, 2),
                  (17, 2048, True, 2), (64, 2048, False, 2), (64, 2048, True, 2), (128, 4096, False, 4),
                  (128, 16384, False, 2), (128, 16384, True, 4))
RESIDENT_SMALL = ((128, 8192, 64, 2048, False), (128, 8192, 64, 2048, True), (128, 8192, 64, 8192, False),
                  (100, 8192, 1472, 2048, False), (100, 8192, 1472, 2048, True), (65, 6144, 768, 2048, True),
                  (65, 6144, 768, 2048, False))
# the dot probe timed below a query half's 64 (beside Q 128)
RESIDENT_SMALL_Q = (1, 17, 64)
# the dot probe's time must scale with N: every chunk's product computed
RESIDENT_WORK_RATIO = 1.8
EXPERIMENTS = (split_pipeline, split2, stream_kernel, isolate_kernel, isolate2, dma_probe)
# the product kernels against f32 GEMMs of the same exact bf16 products:
# max |kernel - plain| over the largest |plain| score
EXP_REL_TOL = 1e-4
BURSTS = (1, 16, 64)
# int8 capacity mode: the band of tests/test_int8_exact.py at D 768 among
# seeded distractors, compared at BAND_TOL (its rows tie within 2e-5)
INT8_BAND = 200
INT8_DISTRACTORS = 20000
BAND_TOL = 1e-6
# a load renormalises the saved (dequantised) rows before it quantises them
# again, so a reload's scores move within tests/test_int8_engine.py's budget
INT8_RELOAD_TOL = 2e-3
# int8_scale: the README's 10M chunks on one chip, N cut to 611 x 16,384
INT8_N = 611 * 16384
INT8_SCALE_Q = (16, 64)
INT8_SCALE_TOP_K = (10, 100)
INT8_SCALE_TOL = 1e-5
INT8_BLOCK = 1 << 18  # rows generated, quantised or scanned at once
INT8_ESCALATION_PEAK = 4e9  # bytes the escalation lane may add above the slab
TOP_K = 10
# the MMR lane: BASELINE.json config 2's diversity, and its top_k 100 for
# one burst; 64 chunks ingested twice give pools with exact duplicates
DIVERSITY = 0.3
MMR_WIDE_K = 100
N_DUPLICATES = 64
# an MMR value is (1 - lambda) * score - lambda * max similarity, each
# within SCORE_TOL between the card and the CPU copy
MMR_TIE_TOL = 2 * SCORE_TOL
# native BM25 against the Python index: f32 sums of f64 terms against f64
# sums (the JAX package's own bound); the unseen mass is an f32 ratio
BM25_REL = 1e-5
UNSEEN_TOL = 1e-6
LEX_QUERIES = 256
LEX_THREADS = 8
LEXICAL_SOURCE = "rust_local_rag_tpu_torch/csrc/lexical.cpp"
WORDPIECE_SOURCE = "rust_local_rag_tpu_torch/csrc/wordpiece.cpp"
# bf16 outputs: the kernel and attention_plain sum the same exact bf16
# products in f32 in other orders and round p and the output to bf16; one
# bf16 ulp at |x| ~ 2 is 1.6e-2 (the bound tests/test_attention.py uses)
ATTN_TOL = 2e-2
# attention at the path's shapes: (B, H, L, causal). The reranker sees
# bucket_batch(prompts) rows at L 192 (16 / 32 for one query, 256 / 512 for
# 16 queries in the judged / object lane); the query encoder 1 or 16 rows
# at L 64; ingest (encoder_fused only) 128 rows at L 256 and 512.
ATTN_SHAPES = [(16, 6, 192, True), (32, 6, 192, True), (256, 6, 192, True), (512, 6, 192, True),
               (1, 8, 64, False), (16, 8, 64, False), (128, 8, 256, False), (128, 8, 512, False)]
ATTN_MAIN = (256, 6, 192, True)  # the judged lane's 16-query batch
# edge shapes (B, H, L, causal): odd and long L, one and three batch rows
ATTN_EDGE = [(b, 2, l, causal) for l in (1, 17, 100, 257, 500, 512) for b in (1, 3) for causal in (False, True)]
# causal shapes checked again with masks that are not prefixes
ATTN_SCATTERED = [s for s in ATTN_SHAPES if s[3]] + [(3, 2, l, True) for l in (1, 17, 100, 257, 512)]
# rerank-on lanes: the quality configuration (eval_harness/configs/baseline.yaml)
JUDGED_WEIGHTS = QueryWeights(reranker=0.0, initial=1.0)
JUDGED_GATE = {"rejection_threshold": 0.0, "rejection_unseen_mass": 0.35, "rejection_unseen_cos": 0.6,
               "rejection_unseen_judge": 0.2}
# the judge with the kernel against the judge without it (or on the CPU):
# bf16 rounded at other places through 4 layers
LOGPROB_TOL = 0.1
RR_TOL = 0.02

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
def env_set(name: str, value: str):
    """The environment variable `name` set to `value` inside the block,
    restored (or removed) after it."""
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name)
        else:
            os.environ[name] = prev


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


def kernel_case(seed: int, q: int, dtype: torch.dtype, device, n: int = N_SLAB, d: int = DIM,
                freed: str = "some"):
    """Unit corpus and queries near corpus rows; 10% of slots freed, plus
    the neighbours of every query's source row (next to its top hit).
    freed="segment" also frees segment 1 wholly, "all" every slot."""
    gen = torch.Generator(device=device).manual_seed(seed)
    corpus32 = unit_rows(gen, n, d, device)
    src = torch.randint(0, n, (q,), generator=gen, device=device)
    queries = corpus32[src] + 0.05 * unit_rows(gen, q, d, device)
    queries = queries / torch.linalg.vector_norm(queries, dim=1, keepdim=True)
    mask = torch.rand(n, generator=gen, device=device) > 0.1
    mask[(src + 1) % n] = False
    mask[(src - 1) % n] = False
    if freed == "segment":
        mask[SEG : 2 * SEG] = False
    elif freed == "all":
        mask[:] = False
    return queries.contiguous(), corpus32.to(dtype).contiguous(), mask


def big_case(seed: int, q: int, n: int, d: int, device):
    """kernel_case for a slab too large to build twice: unit f32 rows made
    in place a chunk at a time; 10% of slots freed, the neighbours of each
    query's source row, segment 1 and the last segment wholly."""
    gen = torch.Generator(device=device).manual_seed(seed)
    corpus = torch.empty(n, d, device=device)
    for i in range(0, n, 1 << 20):
        rows = corpus[i : i + (1 << 20)]
        rows.normal_(generator=gen)
        rows.div_(torch.linalg.vector_norm(rows, dim=1, keepdim=True))
    src = torch.randint(0, n, (q,), generator=gen, device=device)
    queries = corpus[src] + 0.05 * unit_rows(gen, q, d, device)
    queries = queries / torch.linalg.vector_norm(queries, dim=1, keepdim=True)
    mask = torch.rand(n, generator=gen, device=device) > 0.1
    mask[(src + 1) % n] = False
    mask[(src - 1) % n] = False
    mask[SEG : 2 * SEG] = False
    mask[n - SEG :] = False
    return queries.contiguous(), corpus, mask


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|, 0.0 over no elements (a slab with every slot freed)."""
    return float((a - b).abs().max()) if a.numel() else 0.0


def check_kernel(queries, corpus, mask) -> float:
    """Kernel against the plain version; returns the max |score diff|."""
    scores, segmax = score_segmax(queries, corpus, mask)
    p_scores, p_segmax = score_segmax_plain(queries, corpus, mask)
    torch.cuda.synchronize()
    q, n = queries.shape[0], corpus.shape[0]
    if tuple(scores.shape) != (q, n) or tuple(segmax.shape) != (q, n // SEG):
        raise AssertionError(f"kernel shapes {tuple(scores.shape)} {tuple(segmax.shape)}")
    want_inf = (~mask)[None, :].expand(q, -1)
    if not torch.equal(torch.isneginf(scores), want_inf):
        raise AssertionError("kernel: -inf is not exactly at the freed slots")
    if not torch.equal(segmax, scores.view(q, -1, SEG).amax(dim=2)):
        raise AssertionError("kernel: segmax is not the max of its own scores")
    live = ~want_inf
    err = max_abs(scores[live], p_scores[live])
    err_seg = max_abs(segmax[torch.isfinite(p_segmax)], p_segmax[torch.isfinite(p_segmax)])
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


def check_unmasked(queries, corpus) -> float:
    """The unmasked kernel against its plain version; the max |diff|."""
    scores, segmax = fused_score_segmax(queries, corpus)
    p_scores, p_segmax = fused_score_segmax_plain(queries, corpus)
    torch.cuda.synchronize()
    q, n = queries.shape[0], corpus.shape[0]
    if tuple(scores.shape) != (q, n) or tuple(segmax.shape) != (q, n // SEG):
        raise AssertionError(f"unmasked kernel shapes {tuple(scores.shape)} {tuple(segmax.shape)}")
    if not torch.isfinite(scores).all():
        raise AssertionError("unmasked kernel: non-finite scores")
    if not torch.equal(segmax, scores.view(q, -1, SEG).amax(dim=2)):
        raise AssertionError("unmasked kernel: segmax is not the max of its own scores")
    err = max(float((scores - p_scores).abs().max()), float((segmax - p_segmax).abs().max()))
    if not err <= SCORE_TOL:
        raise AssertionError(f"unmasked kernel vs plain: max |diff| {err} > {SCORE_TOL}")
    return err


def attention_case(seed: int, b: int, h: int, l: int, device, scattered: bool = False):
    """q, k, v ~ N(0, 1) in bf16 and random key lengths: row 0 has one
    valid key, the last row none (the finite bias makes it uniform).
    scattered: masks that are not prefixes instead, 70% of keys valid at
    random, with key 0 of row 0 masked (later keys valid), row 1 masked in
    its first half, and the last row with no valid key."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, h, l, 64, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
    if scattered:
        mask = (torch.rand(b, l, generator=gen, device=device) < 0.7).to(torch.int32)
        mask[0, 0] = 0
        mask[0, 1:] |= (torch.arange(1, l, device=device) % 2).to(torch.int32)
        if b > 2:
            mask[1, : l // 2] = 0
        mask[-1] = 0
        return q, k, v, mask
    lens = torch.randint(1, l + 1, (b,), generator=gen, device=device)
    lens[0] = 1
    lens[-1] = 0
    mask = (torch.arange(l, device=device)[None, :] < lens[:, None]).to(torch.int32)
    return q, k, v, mask


def attention_launcher(body: int):
    """fused_attention's signature on the body named (ops.attention.BODIES),
    counting no launch."""
    return lambda q, k, v, mask, causal: attention_ops.launch_body(q, k, v, mask, causal, body)


def check_attention(q, k, v, mask, causal: bool, kernel=None) -> float:
    """The kernel (fused_attention, or the given call) against
    attention_plain on the same inputs; with v read through the transposed
    view the models pass, and k through rows padded to 66 values (the
    kernel's 4-byte load path) it must give the same bits. Returns the max
    |diff|."""
    kernel = kernel or fused_attention
    out = kernel(q, k, v, mask, causal)
    ref = attention_plain(q, k, v, mask, causal)
    strided = kernel(q, k, v.transpose(1, 2).contiguous().transpose(1, 2), mask, causal)
    padded = torch.zeros(*k.shape[:3], 66, dtype=k.dtype, device=k.device)
    padded[..., :64] = k
    unaligned = kernel(q, padded[..., :64], v, mask, causal)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError("attention kernel: non-finite output")
    if not (torch.equal(out, strided) and torch.equal(out, unaligned)):
        raise AssertionError("attention kernel: strided or padded inputs give another result")
    err = float((out.float() - ref.float()).abs().max())
    if not torch.allclose(out.float(), ref.float(), atol=ATTN_TOL, rtol=ATTN_TOL):
        raise AssertionError(f"attention kernel vs plain: max |diff| {err} beyond atol = rtol = {ATTN_TOL}")
    return err


# --------------------------------------------------------------- timing ----


def cuda_ms(fn, reps: int = 7, calls: int = 10, warmup: int = 3) -> float:
    """Milliseconds a call of fn() takes on the card: events around a
    back-to-back run of `calls` calls, so the device time of one call is
    not hidden behind the host's enqueue of the next; median over reps.
    The card spins for AHEAD_CYCLES before the first event, so the host's
    enqueue of the first call is not in the window either."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(AHEAD_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds between events around one call of fn() on an
    idle card: the host's enqueue included."""
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


def bound(q: int, n: int, d: int, corpus_itemsize: int, query_itemsize: int = 4, masked: bool = True):
    """(bound_ms, bound_by): each input read once, each output written once,
    against the card's memory rate; the product against the rate of the
    units that run it: 2*Q*N*D f32 FMAs outside the tensor cores (f32
    slabs; f32 queries at Q <= 16), else terms x 2*Q*N*D on the bf16 tensor
    cores (three terms for f32 queries, one for bf16)."""
    nbytes = n * d * corpus_itemsize + q * d * query_itemsize + (n if masked else 0) + q * n * 4 + q * (n // SEG) * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    if corpus_itemsize == 2 and (q > STREAM_MAX_Q or query_itemsize == 2):
        t_ops = (3 if query_itemsize == 4 else 1) * 2 * q * n * d / H100_BF16_FLOPS * 1e3
    else:
        t_ops = 2 * q * n * d / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(queries, corpus, mask=None):
    """One library GEMM to f32 and the segment max: bf16 queries x the bf16
    slab with f32 output; f32 queries x the slab widened to f32 (TF32 off)."""
    if queries.dtype == torch.bfloat16:
        scores = torch.mm(queries, corpus.T, out_dtype=torch.float32)
    else:
        scores = torch.mm(queries, corpus.float().T)
    if mask is not None:
        scores.masked_fill_(~mask[None, :], float("-inf"))
    return scores, scores.view(queries.shape[0], -1, SEG).amax(dim=2)


def library_split(terms, corpus, mask=None):
    """The split terms' three bf16 GEMMs to f32, summed, and the segment max
    (the terms made beforehand by split_terms_plain)."""
    scores = torch.mm(terms[0], corpus.T, out_dtype=torch.float32)
    for t in terms[1:]:
        scores += torch.mm(t, corpus.T, out_dtype=torch.float32)
    if mask is not None:
        scores.masked_fill_(~mask[None, :], float("-inf"))
    return scores, scores.view(terms.shape[1], -1, SEG).amax(dim=2)


def score_segmax_times(qs, corpus, mask, card: str, reps: int = 7, calls: int = 10):
    """The masked and the unmasked kernel, their plain versions and a
    library call at one shape, each row logged beside its bound; where the
    tensor-core body splits f32 queries into three bf16 terms, also the
    terms' three bf16 GEMMs. -> (masked, unmasked)."""
    (q, d), n = qs.shape, corpus.shape[0]
    split = corpus.dtype == torch.bfloat16 and qs.dtype == torch.float32 and q > STREAM_MAX_Q
    terms = split_terms_plain(qs) if split else None
    rows = []
    for name, kernel, plain, m in (
        ("score_segmax_masked", lambda: score_segmax(qs, corpus, mask), lambda: score_segmax_plain(qs, corpus, mask),
         mask),
        ("fused_score_segmax", lambda: fused_score_segmax(qs, corpus), lambda: fused_score_segmax_plain(qs, corpus),
         None),
    ):
        b_ms, b_by = bound(q, n, d, corpus.element_size(), qs.element_size(), m is not None)
        row = {"kernel_time": name, "dtype": str(corpus.dtype), "queries": str(qs.dtype), "Q": q, "N": n, "D": d,
               "ms": cuda_ms(kernel, reps, calls), "plain_ms": cuda_ms(plain, reps, calls),
               "library_ms": cuda_ms(lambda: library_call(qs, corpus, m), reps, calls),
               "bound_ms": b_ms, "bound_by": b_by, "card": card}
        if split:
            row["library_split_ms"] = cuda_ms(lambda: library_split(terms, corpus, m), reps, calls)
        log(row)
        rows.append(row)
    return rows


def wide_times(seed: int, dev, card: str) -> dict:
    """The bodies past the stream (score_segmax_times): the tensor-core body
    at WIDE_TIMES on bf16 slabs with f32 and bf16 queries, the f32 FMA body
    at F32_WIDE_TIMES on f32 slabs, the tensor-core body at QSCALE_TIMES
    with bf16 queries. -> {(entry, Q, N, slab, query dtype): row}."""
    rows = {}
    for slab, shapes, qdts in ((torch.bfloat16, WIDE_TIMES, (torch.float32, torch.bfloat16)),
                               (torch.float32, F32_WIDE_TIMES, (torch.float32,)),
                               (torch.bfloat16, QSCALE_TIMES, (torch.bfloat16,))):
        for q, n in shapes:
            queries, corpus, mask = kernel_case(seed, q, slab, dev, n)
            reps, calls = (7, 10) if n == N_SLAB else (5, 3)
            for qdt in qdts:
                for row in score_segmax_times(queries.to(qdt), corpus, mask, card, reps, calls):
                    rows[(row["kernel_time"], q, n, str(slab), str(qdt))] = row
            del queries, corpus, mask
            torch.cuda.empty_cache()
    return rows


def wide_batch(engine, dev, card: str, rng, probs, slab: str, reps: int = 5) -> dict:
    """Another engine over the saved index with RAG_TPU_CORPUS_DTYPE=slab
    ("bf16" or "f32") behind a SearchBatcher of max batch WIDE_BATCH: one
    burst of WIDE_BATCH queries, its batches (the masked kernel at Q 64: the
    tensor-core body on bf16, the f32 FMA body on f32) checked against the
    plain hybrid path on a CPU copy, then the burst's latency beside the
    same engine behind a batcher of max batch 16 (median of reps after a
    warm-up). Logged as the phase's name, f"{slab}_wide"."""
    name = f"{slab}_wide"
    want_dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[slab]
    with env_set("RAG_TPU_CORPUS_DTYPE", slab):
        wide = RagEngine(engine.data_dir, engine.embedding_service, device=dev)
    if wide.store.corpus().dtype != want_dtype or len(wide.store) != len(engine.store):
        raise AssertionError(f"{name}: {wide.store.corpus().dtype} slab of {len(wide.store)} chunks")
    wide.warmup()
    recorded = []
    dispatch = wide.dispatch_search

    def recording_dispatch(queries, top_k, *a, **kw):
        pending = dispatch(queries, top_k, *a, **kw)
        recorded.append((list(queries), pending))
        return pending

    batchers = {size: SearchBatcher(wide, RwLock(), max_batch=size) for size in (WIDE_BATCH, 16)}
    try:
        burst = queries_for(rng, WIDE_BATCH, probs)
        wide.dispatch_search = recording_dispatch
        score_segmax.launches = 0
        futs = [batchers[WIDE_BATCH].submit(q, TOP_K, 0.0, None, use_reranker=False) for q in burst]
        answers = {q: f.result(timeout=300) for q, f in zip(burst, futs)}
        launches = score_segmax.launches
        wide.dispatch_search = dispatch
        padded = [p.out.shape[0] for _, p in recorded]
        log({name: "burst", "queries": len(burst), "batch_sizes": [len(qs) for qs, _ in recorded],
             "kernel_q": padded, "launches": {"score_segmax_masked": launches}, "card": card})
        if launches <= 0 or WIDE_BATCH not in padded:
            raise AssertionError(f"{name}: launches {launches}, kernel batches {padded}: no Q {WIDE_BATCH} batch")
        corpus_cpu = wide.store.corpus().cpu()
        mask_cpu = wide.store.valid_mask().cpu()
        for queries, pending in recorded:
            for q, want in zip(queries, plain_reference(pending, corpus_cpu, mask_cpu)):
                same_topk(rows_of(answers[q], wide.store), want, SCORE_TOL, f"{name} plain vs kernel {q!r}")
        latency = {}
        for max_batch, batcher in batchers.items():
            lat = []
            for rep in range(reps + 1):
                qs = queries_for(rng, WIDE_BATCH, probs)
                t0 = time.perf_counter()
                for f in [batcher.submit(q, TOP_K, 0.0, None, use_reranker=False) for q in qs]:
                    f.result(timeout=300)
                if rep:  # the first burst is a warm-up
                    lat.append((time.perf_counter() - t0) * 1e3)
            latency[max_batch] = lat
            log({f"{name}_burst": WIDE_BATCH, "max_batch": max_batch, "median_ms": statistics.median(lat),
                 "min_ms": min(lat), "max_ms": max(lat), "reps": reps, "card": card})
    finally:
        for batcher in batchers.values():
            batcher.stop()
    return {"launches": launches, "checked": len(burst), "latency": latency}


def int8_engine(data_dir: str, service, dev, reranker=None):
    """A RagEngine over data_dir with RAG_TPU_INT8_CORPUS=1."""
    with env_set("RAG_TPU_INT8_CORPUS", "1"):
        return RagEngine(data_dir, service, reranker, device=dev)


def scan_topk(q32, values, scales, mask, lex_slots, lex_vals, w_e: float, w_l: float, k: int) -> list:
    """The exact hybrid top-k by a full scan, per query [(slot, combined,
    emb, lex)]: every row's f32 dense score against its dequantised row
    (values.float() * scale, INT8_BLOCK rows at a time; TF32 off), the
    lexical hits' normalised scores added at their slots, freed slots out.
    An implementation of its own, not the port's two-phase path."""
    qn, n = q32.shape[0], values.shape[0]
    dense = torch.empty((qn, n), dtype=torch.float32, device=q32.device)
    for r0 in range(0, n, INT8_BLOCK):
        rows = values[r0 : r0 + INT8_BLOCK].float() * scales[r0 : r0 + INT8_BLOCK]
        dense[:, r0 : r0 + INT8_BLOCK] = q32 @ rows.T
    dense.masked_fill_(~mask[None, :], float("-inf"))
    lex_slots = torch.as_tensor(lex_slots, device=q32.device)[:qn].long()
    lv = torch.as_tensor(lex_vals, device=q32.device)[:qn].float()
    hit = lex_slots >= 0
    lv = torch.where(hit, lv, 0.0)
    lexn_sparse = lv / torch.clamp(lv.amax(dim=1, keepdim=True), min=F32_EPSILON)
    lexn = torch.zeros_like(dense)
    rows_of_hit = torch.arange(qn, device=q32.device)[:, None].expand_as(lex_slots)
    lexn[rows_of_hit[hit], lex_slots[hit]] = lexn_sparse[hit]
    combined = w_e * dense + w_l * lexn
    vals, idx = torch.topk(combined, k, dim=1)
    emb, lex = torch.gather(dense, 1, idx), torch.gather(lexn, 1, idx)
    del dense, lexn, combined
    return [[(int(i), float(v), float(e), float(x)) for i, v, e, x in zip(*(t[r].tolist() for t in (idx, vals, emb, lex)))
             if np.isfinite(v)] for r in range(qn)]


def columnar_rows(col, qi: int) -> list:
    """[(slot, combined, emb, lex)] of one query of a ColumnarResults."""
    return [(int(s), float(v), float(e), float(x))
            for s, v, e, x in zip(col.slots[qi], col.vals[qi], col.emb[qi], col.lex[qi]) if s >= 0 and np.isfinite(v)]


def band_rows(rng: np.random.Generator, d: int):
    """tests/test_int8_exact.py's rows at width d: INT8_BAND rows at cosine
    0.7 + 2e-5 u to `base`, INT8_DISTRACTORS below 0.3. -> (rows, base)."""
    base = rng.standard_normal(d).astype(np.float32)
    base /= np.linalg.norm(base)
    n = INT8_BAND + INT8_DISTRACTORS
    noise = rng.standard_normal((n, d)).astype(np.float32)
    noise -= (noise @ base)[:, None] * base[None, :]
    noise /= np.linalg.norm(noise, axis=1, keepdims=True)
    c = np.where(np.arange(n) < INT8_BAND, 0.7 + 2e-5 * rng.random(n), 0.3 * rng.random(n)).astype(np.float32)
    rows = c[:, None] * base[None, :] + np.sqrt(np.maximum(1 - c * c, 0.0))[:, None] * noise
    return rows.astype(np.float32), base


def burst_ms(batcher, rng, probs, b: int, reps: int = 5, top_k: int = TOP_K) -> list:
    """ms of `reps` bursts of b rerank-off queries through the batcher,
    after one burst as a warm-up."""
    lat = []
    for rep in range(reps + 1):
        qs = queries_for(rng, b, probs)
        t0 = time.perf_counter()
        for f in [batcher.submit(q, top_k, 0.0, None, use_reranker=False) for q in qs]:
            f.result(timeout=300)
        if rep:
            lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def run_int8(engine, batcher, dev, card: str, seconds: dict, tmp: str, probs, seed: int) -> dict:
    """The int8 capacity mode on the saved index (RAG_TPU_INT8_CORPUS=1):
    the hot lane through SearchBatcher (no score + segment-max launch; each
    batch against a CPU copy of the int8 engine and a brute-force scan of
    the dequantised slab on the card), the judged and object lanes with
    the attention kernel against the CPU copy (rerank_check rules), MMR on
    the object lane against the CPU copy's, get_embedding_candidates, a
    save and reload, burst latency beside the f32 engine's, and the
    adversarial band in an engine of its own (the certificate fails, the
    query escalates and equals the scan; a random query certifies)."""
    rng = np.random.default_rng([seed, 13])
    out = {}
    with phase("int8", card, seconds):
        e8 = int8_engine(engine.data_dir, engine.embedding_service, dev, engine.reranker)
        store = e8.store
        if store.corpus().dtype != torch.int8 or len(store) != len(engine.store):
            raise AssertionError(f"int8: a {store.corpus().dtype} slab of {len(store)} chunks")
        e8.warmup()
        b8 = SearchBatcher(e8, RwLock())
        recorded = []
        dispatch = e8.dispatch_search

        def recording_dispatch(queries, top_k, *a, **kw):
            pending = dispatch(queries, top_k, *a, **kw)
            recorded.append((list(queries), pending))
            return pending

        try:
            # hot lane
            bursts = {b: queries_for(rng, b, probs) for b in BURSTS}
            e8.dispatch_search = recording_dispatch
            score_segmax.launches = 0
            answers = {}
            for b in BURSTS:
                futs = [b8.submit(q, TOP_K, 0.0, None, use_reranker=False) for q in bursts[b]]
                answers.update({q: f.result(timeout=300) for q, f in zip(bursts[b], futs)})
            launches = score_segmax.launches
            del e8.dispatch_search
            channels = {p.out.shape[1] for _, p in recorded}
            out["hot"] = {"score_segmax_masked": launches, "int8_escalations": e8.int8_escalations,
                          "batch_sizes": [len(qs) for qs, _ in recorded], "packed_channels": sorted(channels)}
            log({"int8": "hot", **out["hot"], "card": card})
            if launches != 0 or channels != {5}:
                raise AssertionError(f"int8 hot lane: {launches} score_segmax launches, packed channels {channels}")
            cpu = cpu_engine(e8, tmp, "int8_cpu_copy")
            values, scales, mask = store.corpus(), store.scales(), store.valid_mask()
            for queries, p in recorded:
                cpu._prep_queries = lambda qs, nq_pad, e=p.q_emb.cpu(): e
                col = cpu.fetch_columnar(cpu.dispatch_search(queries, TOP_K))
                scan = scan_topk(p.q_emb[: len(queries)], values, scales, mask, p.lex_slots, p.lex_vals,
                                 p.resolved.embedding, p.resolved.lexical, TOP_K)
                for qi, q in enumerate(queries):
                    got = rows_of(answers[q], store)
                    same_topk(got, columnar_rows(col, qi), SCORE_TOL, f"int8 hot vs CPU copy {q!r}")
                    same_topk(got, scan[qi], SCORE_TOL, f"int8 hot vs scan {q!r}")
            log({"int8_checked_against_cpu_copy_and_scan": len(answers)})

            # rerank lanes, with the attention kernel
            q_embs = {}
            prep = e8._prep_queries

            def recording_prep(queries, nq_pad):
                q_embs[tuple(queries)] = prep(queries, nq_pad)
                return q_embs[tuple(queries)]

            qs = queries_for(rng, 16, probs)
            near, worst = [], {"rr": 0.0, "logprob": 0.0}
            with env_set("RAG_TPU_FUSED_ATTN", "1"):
                e8._prep_queries = recording_prep
                fused_attention.launches = 0
                score_segmax.launches = 0
                pre, jc = judged_pass(e8, qs)
                obj = e8.search_batch(qs, TOP_K, None)
                attn, masked = fused_attention.launches, score_segmax.launches
                del e8._prep_queries
                out["rerank"] = {"fused_attention": attn, "score_segmax_masked": masked}
                if attn <= 0 or masked != 0 or e8.rerank_fallbacks or e8.reranker.fallbacks:
                    raise AssertionError(f"int8 rerank lanes: {attn} attention, {masked} score_segmax launches, "
                                         f"fallbacks {e8.rerank_fallbacks} / {e8.reranker.fallbacks}")
                rcpu = cpu_engine(e8, tmp, "int8_rerank_cpu",
                                  RerankerService(TransformerReranker.from_assets(device="cpu")))
                rcpu._prep_queries = lambda queries, nq_pad: q_embs[tuple(queries)].cpu()
                pre_c, jc_c = judged_pass(rcpu, qs)
                compare_judged({"queries": qs, "pre_slots": pre, "jc": jc}, pre_c, jc_c, False, near, worst,
                               "int8 judged, CPU copy")
                compare_object(obj, rcpu.search_batch(qs, TOP_K, None), qs, False, near, worst,
                               "int8 object, CPU copy")
            log({"int8": "rerank", **out["rerank"], "judge_max_diff_vs_cpu_copy": worst, "near": near,
                 "card": card})

            # MMR: the object lane on dequantised rows
            if e8.supports_columnar_mmr() or e8.dispatch_search_mmr(["x"], TOP_K, DIVERSITY) is not None:
                raise AssertionError("int8: the MMR hot lane answered an int8 store")
            general = e8.search_with_diversity_batch
            mmr_batches = []

            def recording_general(queries, top_k, diversity, weights=None, **kw):
                res = general(queries, top_k, diversity, weights, **kw)
                mmr_batches.append((list(queries), top_k, res))
                return res

            e8._prep_queries, e8.search_with_diversity_batch = recording_prep, recording_general
            try:
                for b, top_k in ((1, TOP_K), (16, TOP_K), (16, MMR_WIDE_K)):
                    burst = queries_for(rng, b, probs)
                    for f in [b8.submit(q, top_k, DIVERSITY, None, use_reranker=False) for q in burst]:
                        if len(f.result(timeout=600)) != top_k:
                            raise AssertionError("int8 MMR: a short result list")
            finally:
                del e8._prep_queries, e8.search_with_diversity_batch
            cpu._prep_queries = lambda queries, nq_pad: q_embs[tuple(queries)].cpu()
            deq = gather_dequantized(cpu.store.corpus(), cpu.store.scales(), torch.arange(cpu.store.capacity))
            mmr_near = []
            for i, (queries, top_k, res) in enumerate(mmr_batches):
                want = cpu.search_with_diversity_batch(queries, top_k, DIVERSITY, use_reranker=False)
                for q, a, w in zip(queries, res, want):
                    compare_mmr(rows_of(a, store), rows_of(w, store), deq, DIVERSITY, mmr_near, f"int8 mmr {i} {q!r}")
            out["mmr"] = {"object_lane_batches": len(mmr_batches), "near": len(mmr_near)}
            log({"int8": "mmr", **out["mmr"], "near_cases": mmr_near[:10], "card": card})
            if not mmr_batches:
                raise AssertionError("int8: no MMR batch took the object lane")

            # calibration candidates, save and reload
            for q in bursts[16][:4]:
                got = [(c.chunk_id, c.initial_score, c.initial_score, 0.0) for c in e8.get_embedding_candidates(q, TOP_K)]
                want = [(c.chunk_id, c.initial_score, c.initial_score, 0.0) for c in cpu.get_embedding_candidates(q, TOP_K)]
                same_topk(got, want, SCORE_TOL, f"int8 get_embedding_candidates {q!r}")
            e8.data_dir = os.path.join(tmp, "int8_index")
            os.makedirs(e8.data_dir)
            e8.save_to_disk()
            e8b = int8_engine(e8.data_dir, engine.embedding_service, dev)
            if not e8b.store.quantized or len(e8b.store) != len(store):
                raise AssertionError("int8 reload: the index did not come back as an int8 store")
            for q, a, b in zip(bursts[16], e8.search_batch(bursts[16], TOP_K, use_reranker=False),
                               e8b.search_batch(bursts[16], TOP_K, use_reranker=False)):
                same_topk(rows_of(a, store), rows_of(b, e8b.store), INT8_RELOAD_TOL, f"int8 reload {q!r}")
            del e8b, cpu, rcpu, deq

            # burst latency beside the f32 engine's, in turns
            lat = {"int8": {}, "f32": {}}
            for b in BURSTS:
                for name, bt in (("int8", b8), ("f32", batcher)):
                    lat[name][b] = burst_ms(bt, rng, probs, b)
                log({"int8_burst": b, "top_k": TOP_K, "median_ms": statistics.median(lat["int8"][b]),
                     "f32_median_ms": statistics.median(lat["f32"][b]), "int8_ms": lat["int8"][b],
                     "f32_ms": lat["f32"][b], "card": card})
            out["latency"] = lat
        finally:
            b8.stop()

        # the adversarial band, in an engine of its own
        os.makedirs(os.path.join(tmp, "int8_band"))
        band = int8_engine(os.path.join(tmp, "int8_band"), engine.embedding_service, dev)
        rows, base = band_rows(rng, DIM)
        rand = rng.standard_normal(DIM).astype(np.float32)
        rand /= np.linalg.norm(rand)
        metas = [ChunkMeta(id=str(uuid.UUID(int=int(rng.integers(2**63)) << 64 | i)), document_name="int8_band",
                 text=f"{'near tie' if i < INT8_BAND else 'distractor'} chunk {i}", chunk_index=i)
                 for i in range(len(rows))]
        band.add_chunks(metas, rows)
        probes = {"qqq adversarial direction": base, "qqq random direction": rand}

        def probe_prep(queries, nq_pad):
            q = np.zeros((nq_pad, DIM), np.float32)
            q[: len(queries)] = [probes[t] for t in queries]
            return torch.as_tensor(q, device=dev)

        band._prep_queries = probe_prep
        bb = SearchBatcher(band, RwLock())
        try:
            bs = band.store
            for text, escalates in (("qqq adversarial direction", True), ("qqq random direction", False)):
                before = band.int8_escalations
                got = rows_of(bb.submit(text, TOP_K, 0.0, None, use_reranker=False).result(timeout=300), bs)
                if (band.int8_escalations > before) != escalates:
                    raise AssertionError(f"int8 band {text!r}: escalations {before} -> {band.int8_escalations}")
                r = ResolvedWeights.from_query_weights(None)
                want = scan_topk(torch.as_tensor(probes[text][None, :], device=dev), bs.corpus(), bs.scales(),
                                 bs.valid_mask(), np.full((1, 1), -1, np.int32), np.zeros((1, 1), np.float32),
                                 r.embedding, r.lexical, TOP_K)[0]
                same_topk(got, want, BAND_TOL, f"int8 band {text!r} vs scan")
            out["band"] = {"rows": len(bs), "int8_escalations": band.int8_escalations}
            log({"int8": "band", **out["band"], "tol": BAND_TOL, "card": card})
        finally:
            bb.stop()
    return out


def quantized_slab(n: int, d: int, seed: int, dev):
    """n seeded standard-normal rows, unit-normalised and quantised on the
    card INT8_BLOCK rows at a time by ops/quantized.quantize_corpus ->
    (values [n, d] int8, scales [n, 1], l1 [n])."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    values = torch.empty((n, d), dtype=torch.int8, device=dev)
    scales = torch.empty((n, 1), dtype=torch.float32, device=dev)
    for r0 in range(0, n, INT8_BLOCK):
        rows = torch.randn((min(INT8_BLOCK, n - r0), d), generator=gen, device=dev)
        qc = quantize_corpus(torch.nn.functional.normalize(rows, dim=1))
        values[r0 : r0 + len(rows)], scales[r0 : r0 + len(rows)] = qc.values, qc.scales
    l1 = scales[:, 0] * values.abs().sum(dim=1, dtype=torch.int32).float()
    return values, scales, l1


def bf16_slab(n: int, d: int, seed: int, dev) -> torch.Tensor:
    """quantized_slab's rows before quantisation, as a bf16 slab."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
    for r0 in range(0, n, INT8_BLOCK):
        rows = torch.randn((min(INT8_BLOCK, n - r0), d), generator=gen, device=dev)
        out[r0 : r0 + len(rows)] = torch.nn.functional.normalize(rows, dim=1).to(torch.bfloat16)
    return out


def lexical_hits(live: torch.Tensor, q: int, gen, width: int = 512):
    """Per query `width` distinct live slots with seeded BM25-like scores
    in [0, 10): ([q, width] int32, [q, width] f32). Distinct, as the
    lexical index returns them (a repeated slot would add its boost twice
    in the blend)."""
    slots = []
    for _ in range(q):
        u = torch.unique(torch.randint(0, len(live), (2 * width,), generator=gen, device=live.device))
        slots.append(live[u[torch.randperm(len(u), generator=gen, device=live.device)[:width]]])
    return torch.stack(slots).to(torch.int32), torch.rand((q, width), generator=gen, device=live.device) * 10


def peak_above(fn) -> tuple:
    """(fn(), bytes the call's peak allocation reached above what was
    allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated() - base


def device_kernels(fn) -> list:
    """Names of the kernels one call of fn() launches, from torch.profiler;
    ["not measured: ..."] where the profiler sees no device events."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA})
        return names or ["not measured: the profiler saw no device events"]
    except RuntimeError as e:
        return [f"not measured: {e}"]


def run_int8_scale(seed: int, dev, card: str) -> dict:
    """10,010,624 x 768 int8 rows on the card (about 1% of slots freed):
    hybrid_topk_quantized_packed at Q 16 and 64, top_k 10 and 100 (the
    engine's k buckets) with 512 lexical hits a query; each certified
    query against the scan, each uncertified one through
    hybrid_topk_dequant_full against it; the planted band's query must
    fail its certificate and escalate at Q 1. Times by CUDA events (the
    whole call and its parts), peak memory above the slab, the bound,
    _int_mm alone as the library line, and the bf16 masked kernel at the
    same N (a slab of its own, freed after)."""
    n, d = INT8_N, DIM
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    values, scales, l1 = quantized_slab(n, d, seed, dev)
    mask = torch.rand(n, generator=gen, device=dev) > 0.01
    r = ResolvedWeights.from_query_weights(None)
    w_e, w_l = (torch.tensor(x, dtype=torch.float32, device=dev) for x in (r.embedding, r.lexical))
    slab_bytes = values.numel() + scales.numel() * 4 + l1.numel() * 4 + mask.numel()
    b_bytes = slab_bytes / H100_BYTES_PER_S * 1e3
    log({"int8_scale": "slab", "N": n, "D": d, "live": int(mask.sum()), "slab_bytes": slab_bytes,
         "int8_gb": values.numel() / 1e9, "card": card})
    rows_out = []
    live = torch.nonzero(mask)[:, 0]
    for q in INT8_SCALE_Q:
        queries = torch.nn.functional.normalize(torch.randn((q, d), generator=gen, device=dev), dim=1)
        lex_slots, lex_vals = lexical_hits(live, q, gen)
        for top_k in INT8_SCALE_TOP_K:
            k = _bucket_k(top_k)
            c = min(_next_pow2(4 * k), n)
            args = (queries, values, scales, l1, mask, lex_slots, lex_vals, w_e, w_l, k)
            packed, peak = peak_above(lambda: hybrid_topk_quantized_packed(*args))
            arr = packed.cpu().numpy()
            vals, emb, lex, idx = unpack_topk(arr, q, top_k)
            certified = arr[:, 4, 0] > 0
            scan = scan_topk(queries, values, scales, mask, lex_slots, lex_vals, r.embedding, r.lexical, top_k)
            fail = np.flatnonzero(~certified)
            if len(fail):
                esc = hybrid_topk_dequant_full(queries[torch.as_tensor(fail, device=dev)], values, scales, mask,
                                               lex_slots[fail], lex_vals[fail], w_e, w_l, k)
                e_vals, e_emb, e_lex, e_idx = (x.cpu().numpy()[:, :top_k] for x in esc)
            for qi in range(q):
                if certified[qi]:
                    got = [(int(s), float(v), float(e), float(x))
                           for s, v, e, x in zip(idx[qi], vals[qi], emb[qi], lex[qi]) if s >= 0]
                else:
                    j = int(np.flatnonzero(fail == qi)[0])
                    got = [(int(s), float(v), float(e), float(x))
                           for s, v, e, x in zip(e_idx[j], e_vals[j], e_emb[j], e_lex[j]) if s >= 0]
                same_topk(got, scan[qi], INT8_SCALE_TOL, f"int8_scale Q{q} top{top_k} query {qi}")
            q_int8, _ = quantize_rows(queries)
            ms = cuda_ms(lambda: hybrid_topk_quantized_packed(*args), reps=5, calls=3)
            mm_ms = cuda_ms(lambda: int8_scores(q_int8, values), reps=5, calls=3)

            def planes():
                p1, q_scale = _int8_p1(queries, values, scales)
                return _int8_upper(p1, q_scale, l1, mask)

            planes_ms = cuda_ms(planes, reps=5, calls=3)
            upper = planes()
            select_ms = cuda_ms(lambda: _select(upper, c), reps=5, calls=3)
            del upper
            b_ops = 2 * q * n * d / H100_INT8_OPS * 1e3
            row = {"int8_scale": "first_stage", "Q": q, "top_k": top_k, "k": k, "candidates": c, "N": n, "D": d,
                   "certified": int(certified.sum()), "escalated_checked": len(fail), "ms": ms,
                   "int_mm_ms": mm_ms, "planes_ms": planes_ms - mm_ms, "select_ms": select_ms,
                   "rescore_blend_ms": ms - planes_ms - select_ms, "peak_above_slab_bytes": peak,
                   "bound_ms": max(b_bytes, b_ops), "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                   "library_ms": mm_ms, "card": card}
            log(row)
            rows_out.append(row)
        if q == INT8_SCALE_Q[0]:
            q_int8, _ = quantize_rows(queries)
            log({"int8_scale": "int_mm_kernels", "Q": q, "kernels": device_kernels(lambda: int8_scores(q_int8, values)),
                 "card": card})
        del queries, lex_slots, lex_vals

    # the band, planted once more: its query fails the certificate and
    # escalates at Q 1
    rows, base = band_rows(np.random.default_rng([seed, 14]), d)
    base = torch.from_numpy(base).to(dev)
    qc = quantize_corpus(torch.nn.functional.normalize(torch.from_numpy(rows[:INT8_BAND]).to(dev), dim=1))
    values[:INT8_BAND], scales[:INT8_BAND] = qc.values, qc.scales
    l1[:INT8_BAND] = qc.scales[:, 0] * qc.values.abs().sum(dim=1, dtype=torch.int32).float()
    mask[:INT8_BAND] = True
    no_lex = (torch.full((1, 512), -1, dtype=torch.int32, device=dev), torch.zeros((1, 512), device=dev))
    one = torch.ones((), device=dev)
    zero = torch.zeros((), device=dev)
    flag = hybrid_topk_quantized_packed(base[None, :], values, scales, l1, mask, *no_lex, one, zero,
                                        _bucket_k(TOP_K))[0, 4, 0].item()
    (e_vals, _, _, e_idx), peak = peak_above(
        lambda: hybrid_topk_dequant_full(base[None, :], values, scales, mask, *no_lex, one, zero, _bucket_k(TOP_K)))
    got = [(int(s), float(v), float(v), 0.0) for s, v in zip(e_idx[0, :TOP_K].tolist(), e_vals[0, :TOP_K].tolist())]
    want = scan_topk(base[None, :], values, scales, mask, no_lex[0], no_lex[1], 1.0, 0.0, TOP_K)[0]
    same_topk(got, want, BAND_TOL, "int8_scale band escalation vs scan")
    if flag or not all(s < INT8_BAND for s, *_ in got):
        raise AssertionError(f"int8_scale band: certificate {flag}, slots {[s for s, *_ in got]}")
    esc_ms = cuda_ms(lambda: hybrid_topk_dequant_full(base[None, :], values, scales, mask, *no_lex, one, zero,
                                                      _bucket_k(TOP_K)), reps=3, calls=1)
    escalation = {"int8_scale": "escalation", "Q": 1, "top_k": TOP_K, "certificate": flag, "ms": esc_ms,
                  "peak_above_slab_bytes": peak, "limit_bytes": INT8_ESCALATION_PEAK, "card": card}
    log(escalation)
    if not peak < INT8_ESCALATION_PEAK:
        raise AssertionError(f"int8_scale: the escalation lane took {peak} bytes above the slab")
    del values, scales, l1, qc
    torch.cuda.empty_cache()

    # the same N on a bf16 slab through the masked kernel
    corpus = bf16_slab(n, d, seed, dev)
    bf16_rows = []
    for q in INT8_SCALE_Q:
        queries = torch.nn.functional.normalize(torch.randn((q, d), generator=gen, device=dev), dim=1)
        lex_slots, lex_vals = lexical_hits(live, q, gen)
        args = (queries, corpus, mask, lex_slots, lex_vals, w_e, w_l, _bucket_k(TOP_K))
        score_segmax.launches = 0
        hybrid_topk_packed(*args)
        torch.cuda.synchronize()
        if score_segmax.launches != 1:
            raise AssertionError(f"int8_scale bf16: {score_segmax.launches} masked kernel launches")
        b_ms, b_by = bound(q, n, d, 2, 4, True)
        row = {"int8_scale": "bf16_masked", "Q": q, "top_k": TOP_K, "N": n, "D": d,
               "ms": cuda_ms(lambda: hybrid_topk_packed(*args), reps=5, calls=3),
               "kernel_ms": cuda_ms(lambda: score_segmax(queries, corpus, mask), reps=5, calls=3),
               "bound_ms": b_ms, "bound_by": b_by, "slab_only_bound_ms": n * d * 2 / H100_BYTES_PER_S * 1e3,
               "card": card}
        log(row)
        bf16_rows.append(row)
        del queries, lex_slots, lex_vals
    del corpus, mask, live
    torch.cuda.empty_cache()
    return {"first_stage": rows_out, "escalation": escalation, "bf16": bf16_rows}


def attention_bound(b: int, h: int, l: int):
    """(bound_ms, bound_by): q, k, v read and the output written once in
    bf16 plus the int32 mask, against the memory rate; 4*B*H*L^2*Dh
    operations (QK^T and PV) against the bf16 tensor-core rate. The exps
    are a third floor, kept beside the bound (attention_exp_floor), not in
    it, so the bound stays comparable with earlier records."""
    t_bytes = (4 * b * h * l * 64 * 2 + b * l * 4) / H100_BYTES_PER_S * 1e3
    t_ops = 4 * b * h * l * l * 64 / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_exp_floor(b: int, h: int, l: int) -> float:
    """ms for the B*H*L^2 exps of the softmax at the SFU rate."""
    return b * h * l * l / H100_EXPS_PER_S * 1e3


def ptxas_summary(log: str) -> list:
    """[{function, registers, spill_stores, spill_loads}] a kernel
    instantiation, from nvcc's -Xptxas -v output."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def attention_bias(mask, causal: bool):
    """The kernel's finite float bias as an attn_mask for
    scaled_dot_product_attention, the library call timed beside it."""
    l = mask.shape[1]
    bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
    if causal:
        pos = torch.arange(l, device=mask.device)
        bias = bias + torch.where(pos[None, :] > pos[:, None], -1e9, 0.0)
    return bias


def stage_breakdown(engine, py_index, rng, probs, q: int = 16, reps: int = 5) -> dict:
    """Median ms of each stage of one hot-lane batch of q queries, every
    stage ended by a synchronise (host clock), the span of the hybrid stage
    between CUDA events, and its three parts (kernel, selection, blend)
    timed alone; BM25 (_prep_lexical) of the same queries also with the
    pure-Python index py_index; then the ingest split between tokenising
    and the encoder forward for 1024 length-sorted chunks in batches of
    128."""
    stages = {"encode_queries": [], "bm25": [], "hybrid_span": [], "hybrid_wall": [],
              "fetch_and_results": [], "bm25_python": []}
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
        native, engine.lexical_index = engine.lexical_index, py_index
        try:
            t_py = time.perf_counter()
            engine._prep_lexical(qs, TOP_K, q)
            t_py = time.perf_counter() - t_py
        finally:
            engine.lexical_index = native
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
        for k, x in zip(stages, (t1 - t0, t2 - t1, a.elapsed_time(b) / 1e3, t3 - t2, t4 - t3, t_py)):
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


# ------------------------------------------------------------ host tier ----


def lex_rows(index, query: str, limit: int = TOP_K * 5):
    """(slots, scores) of index.score_slots_into at the hot lane's width."""
    slots = np.full(limit, -1, dtype=np.int32)
    vals = np.zeros(limit, dtype=np.float32)
    n = index.score_slots_into(query, limit, slots, vals)
    return slots[:n].tolist(), vals[:n].tolist()


def same_hits(a, b, what: str) -> float:
    """Native hits a against Python hits b, as (slots, scores): the same
    slot sets up to rows tied with the last score within BM25_REL, scores
    within rel BM25_REL. -> the largest relative difference."""
    if len(a[0]) != len(b[0]):
        raise AssertionError(f"{what}: {len(a[0])} hits vs {len(b[0])}")
    ga, gb = dict(zip(*a)), dict(zip(*b))
    if not ga:
        return 0.0
    floor = min(min(ga.values()), min(gb.values()))
    for slot in set(ga) ^ set(gb):
        v = ga.get(slot, gb.get(slot))
        if v - floor > BM25_REL * max(abs(floor), 1.0):
            raise AssertionError(f"{what}: slot {slot} ({v}) on one side only, above the tie band of {floor}")
    worst = 0.0
    for slot in set(ga) & set(gb):
        rel = abs(ga[slot] - gb[slot]) / max(abs(gb[slot]), 1e-30)
        if rel > BM25_REL and abs(ga[slot] - gb[slot]) > 1e-12:
            raise AssertionError(f"{what}: slot {slot}: {ga[slot]} vs {gb[slot]}")
        worst = max(worst, rel if gb[slot] else 0.0)
    return worst


def lexical_check(engine, rng, probs) -> tuple:
    """The native index against a pure-Python index over the same chunks
    and slots, then LEX_THREADS threads scoring at once against the
    sequential answers. -> (the Python index, a stats dict)."""
    native = engine.lexical_index
    if not isinstance(native, NativeLexicalIndex):
        raise AssertionError(f"the engine's BM25 index is {type(native).__name__}, not the native one")
    t0 = time.perf_counter()
    py = LexicalIndex()
    for slot, m in engine.store.iter_meta():
        py.add_chunk(m.id, m.text, slot)
    t_build = time.perf_counter() - t0
    queries = queries_for(rng, LEX_QUERIES, probs)
    for i in range(0, LEX_QUERIES, 8):  # non-ASCII terms: the Python tokenizer's path
        queries[i] += " café naïve Straße"
    worst_rel, worst_mass = 0.0, 0.0
    t_native = t_py = 0.0
    want = []
    for q in queries:
        t0 = time.perf_counter()
        a = lex_rows(native, q)
        t1 = time.perf_counter()
        b = lex_rows(py, q)
        t2 = time.perf_counter()
        t_native += t1 - t0
        t_py += t2 - t1
        worst_rel = max(worst_rel, same_hits(a, b, f"lexical_check {q!r}"))
        dm = abs(native.unseen_mass(q) - py.unseen_mass(q))
        if dm > UNSEEN_TOL:
            raise AssertionError(f"lexical_check {q!r}: unseen mass differs by {dm}")
        worst_mass = max(worst_mass, dm)
        want.append(a)
    got = [[None] * len(queries) for _ in range(LEX_THREADS)]
    errors = []

    def worker(t):
        try:
            order = np.random.default_rng(t).permutation(len(queries)).tolist()
            for i in order:
                got[t][i] = lex_rows(native, queries[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(LEX_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    t_threads = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"lexical_check threads: {errors or 'a thread did not finish'}")
    for t in range(LEX_THREADS):
        if got[t] != want:
            bad = sum(x != y for x, y in zip(got[t], want))
            raise AssertionError(f"lexical_check: thread {t} differs from the sequential answers on {bad} queries")
    return py, {"lexical_check_queries": len(queries), "non_ascii_queries": len(range(0, LEX_QUERIES, 8)),
                "max_rel_score_diff": worst_rel, "max_unseen_mass_diff": worst_mass, "tol_rel": BM25_REL,
                "tol_unseen": UNSEEN_TOL, "python_index_build_s": t_build,
                "native_ms_per_query": t_native / len(queries) * 1e3, "python_ms_per_query": t_py / len(queries) * 1e3,
                "threads": LEX_THREADS, "threaded_s": t_threads, "threads_equal_sequential": True}


def judged_prompts(engine, rng, probs, q: int = 16) -> list:
    """The prompts a judged batch of q queries sends to the judge (its
    top_k head), one query with non-ASCII text."""
    qs = queries_for(rng, q, probs)
    qs[-1] += " — naïve café"
    prompts = []
    for query, res in zip(qs, engine.search_batch(qs, TOP_K, use_reranker=False)):
        for r in res:
            prompts.append(engine.reranker.build_prompt(query, RerankerCandidate(
                chunk_id=r.chunk_id, document=r.document, text=r.text, page_number=r.page_number,
                section=r.section, initial_score=r.score)))
    return prompts


def tokenizer_check(engine, texts, prompts) -> dict:
    """The native tokenizers of the encoder and the judge against the
    pure-Python one: identical ids and masks over the chunk texts (in the
    encoder's batches of 128) and the judged prompts (head/tail at the
    judge's length)."""
    enc_tok = engine.embedding_service._model.tokenizer
    judge = engine.reranker._model
    for tok in (enc_tok, judge.tokenizer):
        if not isinstance(tok, NativeWordPieceTokenizer):
            raise AssertionError(f"a model tokenizes with {type(tok).__name__}, not the native tokenizer")
    py = WordPieceTokenizer(default_asset("tokenizer.json"), max_len=enc_tok.max_len)
    routed0 = enc_tok.routed_texts + judge.tokenizer.routed_texts
    t_nat = t_py = 0.0
    for i in range(0, len(texts), 128):
        batch = texts[i : i + 128]
        t0 = time.perf_counter()
        a = enc_tok.encode_batch(batch)
        t1 = time.perf_counter()
        b = py.encode_batch(batch)
        t2 = time.perf_counter()
        t_nat += t1 - t0
        t_py += t2 - t1
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            raise AssertionError(f"tokenizer_check: chunk batch {i // 128} differs from the pure-Python ids")
    t0 = time.perf_counter()
    a = judge.tokenizer.encode_batch_headtail(prompts, judge.judge_seq_len)
    t1 = time.perf_counter()
    b = py.encode_batch_headtail(prompts, judge.judge_seq_len)
    t2 = time.perf_counter()
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        raise AssertionError("tokenizer_check: the judged prompts' ids differ from the pure-Python ids")
    return {"tokenizer_check_texts": len(texts), "tokenizer_check_prompts": len(prompts),
            "routed_texts": enc_tok.routed_texts + judge.tokenizer.routed_texts - routed0,
            "chunks_native_s": t_nat, "chunks_python_s": t_py,
            "prompts_native_ms": (t1 - t0) * 1e3, "prompts_python_ms": (t2 - t1) * 1e3}


# ------------------------------------------------------------- MMR lane ----


def cpu_engine(engine, tmp: str, name: str, reranker=None):
    """A CPU engine over the card engine's slab, mask, metadata and lexical
    index (the slab copied to the host)."""
    store = copy.copy(engine.store)
    store._emb = engine.store.corpus().cpu()
    store._mask = engine.store.valid_mask().cpu()
    if store.quantized:
        store._scales, store._l1 = engine.store.scales().cpu(), engine.store.l1().cpu()
    store.device = torch.device("cpu")
    cpu = RagEngine(os.path.join(tmp, name), engine.embedding_service, reranker, device="cpu")
    cpu.store, cpu.lexical_index = store, engine.lexical_index
    return cpu


def mmr_value(slot: int, rel: float, chosen: list, corpus_cpu, lam: float) -> float:
    """(1 - lambda) * rel - lambda * (max similarity to the chosen slots,
    floored at 0), in f64 on the CPU copy's rows."""
    if not chosen:
        return (1.0 - lam) * rel
    row = corpus_cpu[slot].double()
    sims = corpus_cpu[chosen].double() @ row
    sims = torch.where(torch.isfinite(sims), sims, 0.0)
    return (1.0 - lam) * rel - lam * max(0.0, float(sims.max()))


def compare_mmr(got: list, want: list, corpus_cpu, lam: float, near: list, what: str) -> None:
    """Card MMR rows against the CPU copy's, as [(slot, combined, emb,
    lex)]: the same slots in the same order with scores within SCORE_TOL,
    until a step where the two picks' MMR values (their scores and their
    similarities to the common prefix) tie within MMR_TIE_TOL, after which
    the lists may diverge (recorded in `near`)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results, want {len(want)}")
    for j, (a, b) in enumerate(zip(got, want)):
        if a[0] != b[0]:
            chosen = [r[0] for r in want[:j]]
            va = mmr_value(a[0], a[1], chosen, corpus_cpu, lam)
            vb = mmr_value(b[0], b[1], chosen, corpus_cpu, lam)
            if abs(va - vb) > MMR_TIE_TOL:
                raise AssertionError(f"{what}: rank {j}: card slot {a[0]} (MMR {va}) vs CPU slot {b[0]} (MMR {vb})")
            duplicate = bool(torch.equal(corpus_cpu[a[0]], corpus_cpu[b[0]]))
            near.append({"lane": "mmr", "check": what, "rank": j, "card_slot": a[0], "cpu_slot": b[0],
                         "card_mmr": va, "cpu_mmr": vb, "duplicate_rows": duplicate})
            if not duplicate:  # the greedy paths part here
                return
        # the same slot, or a duplicate row: the later steps see the same
        # similarities, so the comparison goes on
        if max(abs(x - y) for x, y in zip(a[1:], b[1:])) > SCORE_TOL:
            raise AssertionError(f"{what}: rank {j} slot {a[0]} / {b[0]}: {a} vs {b}")


def mmr_stages(engine, rng, probs, top_k: int, q: int = 16, reps: int = 5) -> dict:
    """Median ms of the stages of one q-query MMR hot-lane batch: query
    encoder and BM25 (host clock, synchronised), the pool select
    (hybrid_topk at the pool; CUDA events), the greedy MMR alone
    (mmr_select_batch over the gathered pool; CUDA events), the whole
    hybrid_topk_packed_mmr call (CUDA events) and fetch + results."""
    r = ResolvedWeights.from_query_weights(None)
    w_e = torch.tensor(r.embedding, dtype=torch.float32, device=engine.device)
    w_l = torch.tensor(r.lexical, dtype=torch.float32, device=engine.device)
    pool = max(top_k * 3, top_k + 10)
    kb = 16 if top_k <= 16 else 128
    corpus, mask = engine.store.corpus(), engine.store.valid_mask()
    stages = {k: [] for k in ("encode_queries", "bm25", "pool_select_span", "mmr_select_span", "mmr_call_span",
                              "fetch_and_results")}

    def span(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b) / 1e3

    for rep in range(reps + 1):
        qs = queries_for(rng, q, probs)
        t0 = time.perf_counter()
        q_emb = engine._prep_queries(qs, q)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        slots, vals = engine._prep_lexical(qs, pool, q)
        t2 = time.perf_counter()
        lex = [torch.as_tensor(x, device=engine.device) for x in (slots, vals)]
        (pv, pe, pl, pi), t_pool = span(lambda: hybrid_topk(q_emb, corpus, mask, *lex, w_e, w_l, pool))
        cand = corpus[pi.clamp(min=0).long()]
        counts = ((pi >= 0) & torch.isfinite(pv)).sum(dim=1)
        _, t_mmr = span(lambda: mmr_select_batch(cand, pv, kb, DIVERSITY, counts))
        out, t_call = span(lambda: hybrid_topk_packed_mmr(q_emb, corpus, mask, *lex, w_e, w_l, DIVERSITY, 0.0, pool, kb))
        t3 = time.perf_counter()
        col = engine.fetch_columnar(PendingSearch(out=out, nq=q, k=top_k, floor=0.0, q_emb=q_emb, lex_slots=slots,
                                                  lex_vals=vals, resolved=r, kb=kb))
        results = [engine.results_from_columnar(col, qi) for qi in range(q)]
        t4 = time.perf_counter()
        if sum(map(len, results)) != q * top_k:
            raise AssertionError("mmr breakdown batch returned short result lists")
        if rep:  # the first batch is a warm-up
            for k, x in zip(stages, (t1 - t0, t2 - t1, t_pool, t_mmr, t_call, t4 - t3)):
                stages[k].append(x)
    return {f"mmr_top{top_k}_batch{q}_{k}_ms": statistics.median(x) * 1e3 for k, x in stages.items()}


def run_mmr(engine, batcher, card: str, seconds: dict, rng, probs, tmp: str, dup_texts: list) -> dict:
    """The MMR hot lane through SearchBatcher (diversity 0.3, rerank off),
    every batch checked against a CPU copy's object lane."""
    recorded, routed = [], {"general": 0}
    dispatch, general = engine.dispatch_search_mmr, engine.search_with_diversity_batch

    def recording_dispatch(queries, top_k, *a, **kw):
        pending = dispatch(queries, top_k, *a, **kw)
        recorded.append((list(queries), top_k, pending))
        return pending

    def counting_general(*a, **kw):
        routed["general"] += 1
        return general(*a, **kw)

    bursts = {f"burst{b}": (queries_for(rng, b, probs), TOP_K) for b in BURSTS}
    # queries made of duplicated chunks' own words: both copies in the pool
    bursts["duplicates16"] = ([" ".join(t.split()[2:10]) for t in dup_texts[:16]], TOP_K)
    bursts[f"top{MMR_WIDE_K}_burst16"] = (queries_for(rng, 16, probs), MMR_WIDE_K)
    out = {"launches": 0, "latency": {}}
    with phase("mmr", card, seconds):
        engine.dispatch_search_mmr, engine.search_with_diversity_batch = recording_dispatch, counting_general
        score_segmax.launches = 0
        answers = {}
        try:
            for name, (qs, top_k) in bursts.items():
                futs = [batcher.submit(q, top_k, DIVERSITY, None, use_reranker=False) for q in qs]
                for q, f in zip(qs, futs):
                    answers[(top_k, q)] = f.result(timeout=600)
        finally:
            del engine.dispatch_search_mmr, engine.search_with_diversity_batch
        out["launches"] = score_segmax.launches
        log({"lane": "mmr", "launches": {"score_segmax_masked": out["launches"]}, "dispatches": len(recorded),
             "batch_sizes": [len(qs) for qs, _, _ in recorded], "general_lane_batches": routed["general"]})
        if out["launches"] <= 0 or routed["general"] or not recorded:
            raise AssertionError(f"mmr: {out['launches']} kernel launches, {routed['general']} batches on the general lane")
        for (top_k, q), res in answers.items():
            if len(res) != top_k or not all(np.isfinite(r.score) for r in res):
                raise AssertionError(f"mmr {q!r}: {len(res)} results, want {top_k} finite")
        check_fallbacks(engine, batcher, "mmr")

    with phase("mmr_check", card, seconds):
        cpu = cpu_engine(engine, tmp, "mmr_cpu_copy")
        q_embs = {tuple(qs): p.q_emb.cpu() for qs, _, p in recorded}
        cpu._prep_queries = lambda queries, nq_pad: q_embs[tuple(queries)]
        corpus_cpu = cpu.store.corpus()
        near: list = []
        dup_pools = 0
        for i, (qs, top_k, _) in enumerate(recorded):
            want = cpu.search_with_diversity_batch(qs, top_k, DIVERSITY, use_reranker=False)
            for q, w in zip(qs, want):
                compare_mmr(rows_of(answers[(top_k, q)], engine.store), rows_of(w, engine.store), corpus_cpu,
                            DIVERSITY, near, f"mmr batch {i} {q!r}")
        for q in bursts["duplicates16"][0]:  # pools holding both copies of a chunk
            pool = engine.search_batch([q], max(TOP_K * 3, TOP_K + 10), use_reranker=False)[0]
            texts = [r.text for r in pool]
            dup_pools += len(texts) != len(set(texts))
        log({"mmr_checked_batches": len(recorded), "mmr_checked_queries": sum(len(qs) for qs, _, _ in recorded),
             "pools_with_duplicate_chunks": dup_pools})
        log({"mmr_near_tie_cases": near[:20], "count": len(near),
             "between_duplicate_rows": sum(x["duplicate_rows"] for x in near)})
        if not dup_pools:
            raise AssertionError("mmr_check: no pool of the duplicates burst held a duplicated chunk")

    with phase("mmr_latency", card, seconds):
        sizes = [(b, TOP_K) for b in BURSTS] + [(16, MMR_WIDE_K)]
        for b, top_k in sizes:
            lat = []
            for rep in range(6):
                qs = queries_for(rng, b, probs)
                t0 = time.perf_counter()
                futs = [batcher.submit(q, top_k, DIVERSITY, None, use_reranker=False) for q in qs]
                for f in futs:
                    f.result(timeout=600)
                if rep:  # the first burst of a size is a warm-up
                    lat.append((time.perf_counter() - t0) * 1e3)
            out["latency"][f"{b}@top{top_k}"] = lat
        check_fallbacks(engine, batcher, "mmr_latency")

    with phase("mmr_breakdown", card, seconds):
        for top_k in (TOP_K, MMR_WIDE_K):
            log({**mmr_stages(engine, rng, probs, top_k), "card": card})
    return out


# ---------------------------------------------------------- rerank lanes ----


def counting(fn, counts: dict, key: str):
    def wrapped(*a, **kw):
        counts[key] += 1
        return fn(*a, **kw)
    return wrapped


def check_fallbacks(engine, batcher, what: str) -> None:
    counters = {"batcher.judged_fallbacks": batcher.judged_fallbacks,
                "engine.rerank_fallbacks": engine.rerank_fallbacks,
                "reranker.fallbacks": engine.reranker.fallbacks}
    if any(counters.values()):
        raise AssertionError(f"{what}: a fallback was taken {counters}")


def judge_forward_times(judge, dev) -> dict:
    """Milliseconds of one judge forward (forward_last_logits) on the card
    with the attention kernel and without it, at the judged and object
    lanes' 16-query batches (256 and 512 prompts at L 192, right-padded as
    the reranker pads them; ids and lengths from a fixed seed)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    model, l = judge.model, judge.judge_seq_len
    out = {}
    with torch.inference_mode():
        for batch in (256, 512):
            ids = torch.randint(4, model.cfg.vocab_size, (batch, l), generator=gen, device=dev, dtype=torch.int32)
            lens = torch.randint(l // 2, l + 1, (batch,), generator=gen, device=dev)
            mask = (torch.arange(l, device=dev)[None, :] < lens[:, None]).to(torch.int32)
            for fused in (True, False):
                key = f"judge_forward_{batch}x{l}_{'kernel' if fused else 'plain'}_ms"
                out[key] = cuda_ms(lambda: model.forward_last_logits(ids, mask, fused_attn=fused), reps=5, calls=3)
    return out


def encoder_fused_check(engine, rng, probs) -> dict:
    """1,024 ingest chunks (length-sorted batches of 128) and one 16-query
    batch through the encoder with the attention kernel and without it;
    every row's cosine must exceed 0.999."""
    model = engine.embedding_service._model
    depth = model.encoder.cfg.depth
    texts = sorted(chunk_texts(rng, 1024, probs), key=len)
    batches = [
        tuple(torch.from_numpy(x).to(engine.device) for x in model.tokenizer.encode_batch(texts[i : i + 128]))
        for i in range(0, 1024, 128)
    ]
    out, times = {}, {True: [], False: []}
    fused_attention.launches = 0
    with torch.inference_mode():
        for fused in (True, False):
            out[fused] = torch.cat([model.encoder(ids, m, fused_attn=fused) for ids, m in batches])
    chunk_launches = fused_attention.launches
    with torch.inference_mode():  # then the encode time, kernel on and off in turns
        for _ in range(3):
            for fused in (True, False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for ids, m in batches:
                    model.encoder(ids, m, fused_attn=fused)
                torch.cuda.synchronize()
                times[fused].append(time.perf_counter() - t0)
    if chunk_launches != depth * len(batches):
        raise AssertionError(f"encoder_fused: {chunk_launches} launches for {len(batches)} batches")
    cos_chunks = (out[True] * out[False]).sum(dim=1)
    qs = queries_for(rng, 16, probs)
    q_out = {}
    for flag in ("1", "0"):
        os.environ["RAG_TPU_FUSED_ATTN"] = flag
        q_out[flag] = model.encode_queries_device(qs)[: len(qs)]
    os.environ.pop("RAG_TPU_FUSED_ATTN")
    cos_q = (q_out["1"] * q_out["0"]).sum(dim=1)
    worst = min(float(cos_chunks.min()), float(cos_q.min()))
    if not worst > 0.999:
        raise AssertionError(f"encoder_fused: cosine {worst} <= 0.999 between the kernel and plain encoders")
    return {"encoder_fused_min_cos_chunks": float(cos_chunks.min()), "encoder_fused_min_cos_queries": float(cos_q.min()),
            "ingest1024_encoder_fused_s": statistics.median(times[True]),
            "ingest1024_encoder_plain_s": statistics.median(times[False]),
            "encoder_fused_launches": chunk_launches + depth}


def judged_rows(jc, pre_slots, qi: int) -> tuple:
    """({slot: (initial, emb, lex, rr, yes, no)} over the pre-gate head,
    rejected?) for one query of a judged batch."""
    col = jc.col
    rows = {}
    for rank, slot in enumerate(pre_slots[qi].tolist()):
        if slot >= 0 and np.isfinite(col.vals[qi, rank]):
            rows[slot] = (float(col.vals[qi, rank]), float(col.emb[qi, rank]), float(col.lex[qi, rank]),
                          float(jc.rr[qi, rank]), float(jc.yes[qi, rank]), float(jc.no[qi, rank]))
    rejected = bool(rows) and bool((col.slots[qi] < 0).all())
    return rows, rejected


def compare_judge(a, b, what: str, worst: dict) -> None:
    """(rr, yes, no) of one row, kernel side a against plain side b; the
    largest differences seen go to `worst`."""
    worst["rr"] = max(worst["rr"], abs(a[0] - b[0]))
    worst["logprob"] = max(worst["logprob"], abs(a[1] - b[1]), abs(a[2] - b[2]))
    if abs(a[0] - b[0]) > RR_TOL or abs(a[1] - b[1]) > LOGPROB_TOL or abs(a[2] - b[2]) > LOGPROB_TOL:
        raise AssertionError(f"{what}: judge (rr, yes, no) {a} vs {b} beyond {RR_TOL} / {LOGPROB_TOL}")


def compare_judged(rec: dict, pre_b, jc_b, exact: bool, near: list, worst: dict, what: str) -> None:
    """A judged batch of the kernel run (rec) against its replay (jc_b,
    with the kernel off on the card or on the CPU copy): first-stage
    planes identical on the card (within SCORE_TOL on the CPU), judge
    outputs within RR_TOL / LOGPROB_TOL, and the same gate decisions and
    sets, except where the plain best yes-probability lies within RR_TOL
    of the judge-rescue threshold (recorded in `near`)."""
    jc_a, pre_a = rec["jc"], rec["pre_slots"]
    nq = len(rec["queries"])
    if exact:
        for name in ("vals", "emb", "lex"):
            if not np.array_equal(getattr(jc_a.col, name)[:nq], getattr(jc_b.col, name)[:nq]):
                raise AssertionError(f"{what}: first-stage plane {name} differs")
        if not np.array_equal(pre_a[:nq], pre_b[:nq]):
            raise AssertionError(f"{what}: first-stage slots differ")
    judge_t = JUDGED_GATE["rejection_unseen_judge"]
    for qi, q in enumerate(rec["queries"]):
        ra, rej_a = judged_rows(jc_a, pre_a, qi)
        rb, rej_b = judged_rows(jc_b, pre_b, qi)
        same_topk([(k, *v[:3]) for k, v in ra.items()], [(k, *v[:3]) for k, v in rb.items()],
                  0.0 if exact else SCORE_TOL, f"{what} {q!r} first stage")
        for slot in set(ra) & set(rb):
            if np.isfinite(ra[slot][3]) or np.isfinite(rb[slot][3]):
                compare_judge(ra[slot][3:], rb[slot][3:], f"{what} {q!r} slot {slot}", worst)
        if rej_a != rej_b:
            best = max((v[3] for v in rb.values()), default=float("-inf"))
            if abs(best - judge_t) > RR_TOL:
                raise AssertionError(f"{what} {q!r}: gate {rej_a} vs {rej_b}, plain best yes-p {best}")
            near.append({"lane": "judged", "check": what, "query": q, "kind": "gate",
                         "plain_value": best, "threshold": judge_t})


def compare_object(res_a, res_b, queries, exact: bool, near: list, worst: dict, what: str) -> None:
    """Object-lane results of the kernel run against the replay: the
    first-stage scores of common rows identical on the card (within
    SCORE_TOL on the CPU), judge outputs within RR_TOL / LOGPROB_TOL, and
    the same top-k sets except where a row's plain blended score lies
    within the blend's tolerance of the k-th one (recorded in `near`).
    With rr within RR_TOL, rr / max(rr) moves by at most 2 RR_TOL / max(rr),
    so the blend by 0.7 times that (plus the initial side's 0.3 times
    2 SCORE_TOL / max(initial) on the CPU)."""
    for q, a, b in zip(queries, res_a, res_b):
        if len(a) != len(b) or (a and any(r.reranker_score is None for r in a + b)):
            raise AssertionError(f"{what} {q!r}: {len(a)} vs {len(b)} results, or an unjudged row")
        if not a:
            continue
        max_rr = max(r.reranker_score for r in b)
        max_init = max(r.initial_score for r in b)
        band = 0.7 * 2 * RR_TOL / max(max_rr, 1e-6)
        if not exact:
            band += 0.3 * 2 * SCORE_TOL / max(max_init, 1e-6)
        ga, gb = {r.chunk_id: r for r in a}, {r.chunk_id: r for r in b}
        for cid in set(ga) & set(gb):
            x, y = ga[cid], gb[cid]
            first = [abs(x.initial_score - y.initial_score), abs(x.embedding_score - y.embedding_score),
                     abs(x.lexical_score - y.lexical_score)]
            if max(first) > (0.0 if exact else SCORE_TOL):
                raise AssertionError(f"{what} {q!r} {cid}: first-stage scores differ by {max(first)}")
            compare_judge((x.reranker_score, x.yes_logprob, x.no_logprob),
                          (y.reranker_score, y.yes_logprob, y.no_logprob), f"{what} {q!r} {cid}", worst)
            if abs(x.score - y.score) > band:
                raise AssertionError(f"{what} {q!r} {cid}: blended {x.score} vs {y.score}, band {band}")
        for side, rows in (("kernel", ga), ("plain", gb)):
            kth = min(r.score for r in rows.values())
            for cid in set(rows) - (set(gb) if side == "kernel" else set(ga)):
                if rows[cid].score - kth > band:
                    raise AssertionError(f"{what} {q!r}: {cid} only on the {side} side, above the band")
                near.append({"lane": "object", "check": what, "query": q, "kind": "topk", "side": side,
                             "value": rows[cid].score, "kth": kth, "band": band})


def cpu_copy(engine, tmp: str):
    """cpu_engine with its own reranker loaded on the CPU (the same
    committed weights)."""
    return cpu_engine(engine, tmp, "cpu_copy", RerankerService(TransformerReranker.from_assets(device="cpu")))


def judged_pass(engine, queries, top_k: int = TOP_K):
    """The judged lane's engine calls, as SearchBatcher makes them."""
    pending = engine.dispatch_search(queries, top_k, JUDGED_WEIGHTS, rejection_threshold=0.0,
                                     rejection_cosine_floor=0.0)
    pj = engine.judge_columnar(pending, queries, weights=JUDGED_WEIGHTS, **JUDGED_GATE)
    pre = pj.col.slots.copy()
    return pre, engine.fetch_judged(pj)


def rerank_stages(engine, rng, probs, lane: str, q: int = 16, reps: int = 3) -> dict:
    """Median ms of the stages of one q-query batch of a lane, each ended
    by a synchronise: first stage (query encoder, BM25, hybrid), prompt
    build, head/tail tokenising, judge forward (host wall and CUDA
    events), and the rest (fetch, gate, blend, results)."""
    judge = engine.reranker._model
    t = {}

    def timed(obj, name: str, key: str, sync: bool = False):
        fn = getattr(obj, name)

        def wrapped(*a, **kw):
            if sync:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                ev[1].record()
                torch.cuda.synchronize()
                t[key + "_device"] += ev[0].elapsed_time(ev[1]) / 1e3
            t[key] += time.perf_counter() - t0
            return out
        setattr(obj, name, wrapped)

    timed(engine, "_dispatch", "first_stage", sync=True)
    timed(engine.reranker, "build_prompt", "prompt_build")
    timed(judge, "encode", "tokenise")
    timed(judge.model, "forward_last_logits", "judge_forward", sync=True)
    stages = {}
    try:
        for rep in range(reps + 1):
            qs = queries_for(rng, q, probs)
            for k in ("first_stage", "first_stage_device", "prompt_build", "tokenise", "judge_forward",
                      "judge_forward_device"):
                t[k] = 0.0
            t0 = time.perf_counter()
            if lane == "judged":
                _, jc = judged_pass(engine, qs)
                [engine.results_from_judged(jc, qi) for qi in range(q)]
            else:
                engine.search_batch(qs, TOP_K, None)
            total = time.perf_counter() - t0
            row = {"first_stage": t["first_stage"], "prompt_build": t["prompt_build"], "tokenise": t["tokenise"],
                   "judge_forward": t["judge_forward"], "judge_forward_device": t["judge_forward_device"],
                   "rest": total - t["first_stage"] - t["prompt_build"] - t["tokenise"] - t["judge_forward"],
                   "total": total}
            if rep:  # the first batch is a warm-up
                for k, v in row.items():
                    stages.setdefault(k, []).append(v)
    finally:
        for obj, name in ((engine, "_dispatch"), (engine.reranker, "build_prompt"), (judge, "encode"),
                          (judge.model, "forward_last_logits")):
            delattr(obj, name)
    return {f"{lane}_batch{q}_{k}_ms": statistics.median(v) * 1e3 for k, v in stages.items()}


def run_rerank(engine, batcher, dev, card: str, seconds: dict, rng, probs, tmp: str) -> dict:
    """The rerank-on lanes with the attention kernel (RAG_TPU_FUSED_ATTN=1)."""
    encoder = engine.embedding_service._model.encoder
    judge = engine.reranker._model
    with phase("encoder_fused", card, seconds):
        log({**encoder_fused_check(engine, rng, probs), "card": card})

    os.environ["RAG_TPU_FUSED_ATTN"] = "1"
    shapes = set()
    plain_fa = encoder_module.fused_attention

    def recording_fa(q, k, v, mask, causal=False):
        shapes.add((q.shape[0], q.shape[1], q.shape[2], bool(causal)))
        return plain_fa(q, k, v, mask, causal=causal)

    forwards = {"encoder": 0, "judge": 0}
    q_embs, judged_batches, object_batches = {}, [], []
    prep, judge_columnar, fetch_judged = engine._prep_queries, engine.judge_columnar, engine.fetch_judged
    general = engine.search_with_diversity_batch

    def recording_prep(queries, nq_pad):
        out = prep(queries, nq_pad)
        q_embs[tuple(queries)] = out
        return out

    def recording_judge(pending, queries, **kw):
        pj = judge_columnar(pending, queries, **kw)
        judged_batches.append({"queries": list(queries), "pre_slots": pj.col.slots.copy(), "pj": pj})
        return pj

    def recording_fetch(pj):
        jc = fetch_judged(pj)
        next(b for b in judged_batches if b["pj"] is pj)["jc"] = jc
        return jc

    def recording_general(queries, top_k, diversity, weights=None, **kw):
        res = general(queries, top_k, diversity, weights, **kw)
        object_batches.append({"queries": list(queries), "results": res})
        return res

    encoder_module.fused_attention = recording_fa
    encoder.forward = counting(encoder.forward, forwards, "encoder")
    judge.model.forward_last_logits = counting(judge.model.forward_last_logits, forwards, "judge")
    engine._prep_queries = recording_prep
    engine.judge_columnar, engine.fetch_judged = recording_judge, recording_fetch
    engine.search_with_diversity_batch = recording_general
    lanes = {"judged": (JUDGED_WEIGHTS, JUDGED_GATE), "object": (None, {})}
    out = {"launches": {}, "latency": {}}
    try:
        for lane, (weights, gate) in lanes.items():
            with phase(lane, card, seconds):
                bursts = {b: queries_for(rng, b, probs) for b in BURSTS}
                if lane == "judged":  # one off-corpus query a burst, for the unseen-term gate
                    for b in BURSTS:
                        bursts[b][-1] = f"zebra xylophone quasar nebula sonnet q{b}"
                n_j, n_o = len(judged_batches), len(object_batches)
                forwards.update(encoder=0, judge=0)
                fused_attention.launches = 0
                score_segmax.launches = 0
                answers = {}
                for b in BURSTS:
                    futs = [batcher.submit(q, TOP_K, 0.0, weights, **gate) for q in bursts[b]]
                    for q, f in zip(bursts[b], futs):
                        answers[q] = f.result(timeout=600)
                launches, masked, fw = fused_attention.launches, score_segmax.launches, dict(forwards)
                want = judge.cfg.depth * fw["judge"] + encoder.cfg.depth * fw["encoder"]
                routed = (len(judged_batches) - n_j, len(object_batches) - n_o)
                out["launches"][lane] = {"fused_attention": launches, "judge_forwards": fw["judge"],
                                         "query_encoder_forwards": fw["encoder"], "score_segmax_masked": masked,
                                         "judged_batches": routed[0], "object_batches": routed[1]}
                log({"lane": lane, **out["launches"][lane], "attention_shapes": sorted(shapes)})
                if launches == 0 or launches != want:
                    raise AssertionError(f"{lane}: {launches} attention launches, want {want} = "
                                         f"{judge.cfg.depth} x {fw['judge']} + {encoder.cfg.depth} x {fw['encoder']}")
                if (routed[0] > 0, routed[1] > 0) != (lane == "judged", lane == "object") or masked == 0:
                    raise AssertionError(f"{lane}: batches went to (judged, object) lanes {routed}, "
                                         f"{masked} first-stage kernel launches")
                for q, res in answers.items():
                    if len(res) not in (0, TOP_K) or any(r.reranker_score is None for r in res):
                        raise AssertionError(f"{lane} {q!r}: {len(res)} results or an unjudged row")
                if not any(answers.values()):
                    raise AssertionError(f"{lane}: every query was rejected")
                log({"lane": lane, "queries": len(answers), "rejected": sum(not r for r in answers.values())})
                if lane == "judged":  # the gate's three signals for the off-corpus queries
                    for q in (bursts[b][-1] for b in BURSTS):
                        log({"off_corpus_query": q, "unseen_mass": engine.lexical_index.unseen_mass(q),
                             "best_cosine": max((r.embedding_score for r in answers[q]), default=None),
                             "best_judge_yes_p": max((r.reranker_score for r in answers[q]), default=None),
                             "rejected": not answers[q]})
                check_fallbacks(engine, batcher, lane)
    finally:
        encoder_module.fused_attention = plain_fa
        for obj, name in ((encoder, "forward"), (judge.model, "forward_last_logits"), (engine, "_prep_queries"),
                          (engine, "judge_columnar"), (engine, "fetch_judged"),
                          (engine, "search_with_diversity_batch")):
            delattr(obj, name)

    with phase("rerank_check", card, seconds):
        # a burst the batcher split otherwise gives shapes beyond ATTN_SHAPES
        for i, (b, h, l, causal) in enumerate(sorted(shapes - set(ATTN_SHAPES))):
            err = check_attention(*attention_case(1000 + i, b, h, l, dev), causal)
            log({"kernel_check": "fused_attention", "B": b, "H": h, "L": l, "Dh": 64, "causal": causal,
                 "max_abs_err": err, "tol": ATTN_TOL, "card": card})
        near: list = []
        worst = {"card": {"rr": 0.0, "logprob": 0.0}, "cpu": {"rr": 0.0, "logprob": 0.0}}
        engine._prep_queries = lambda queries, nq_pad: q_embs[tuple(queries)]
        os.environ["RAG_TPU_FUSED_ATTN"] = "0"
        try:
            for i, rec in enumerate(judged_batches):
                pre, jc = judged_pass(engine, rec["queries"])
                compare_judged(rec, pre, jc, True, near, worst["card"], f"judged batch {i}, kernel off")
            for i, rec in enumerate(object_batches):
                compare_object(rec["results"], engine.search_batch(rec["queries"], TOP_K, None), rec["queries"],
                               True, near, worst["card"], f"object batch {i}, kernel off")
            check_fallbacks(engine, batcher, "kernel-off replay")
            cpu = cpu_copy(engine, tmp)
            cpu._prep_queries = lambda queries, nq_pad: q_embs[tuple(queries)].cpu()
            os.environ["RAG_TPU_FUSED_ATTN"] = "1"
            rec = judged_batches[0]
            pre, jc = judged_pass(cpu, rec["queries"])
            compare_judged(rec, pre, jc, False, near, worst["cpu"], "judged batch 0, CPU copy")
            rec = object_batches[0]
            compare_object(rec["results"], cpu.search_batch(rec["queries"], TOP_K, None), rec["queries"],
                           False, near, worst["cpu"], "object batch 0, CPU copy")
            if cpu.rerank_fallbacks or cpu.reranker.fallbacks:
                raise AssertionError("CPU copy: a fallback was taken")
        finally:
            del engine._prep_queries
        log({"rerank_checked_batches": {"judged": len(judged_batches), "object": len(object_batches)},
             "cpu_copy_batches": {"judged": 1, "object": 1}})
        log({"judge_max_diff_vs_kernel_off": worst["card"], "judge_max_diff_vs_cpu_copy": worst["cpu"],
             "tol": {"rr": RR_TOL, "logprob": LOGPROB_TOL}})
        log({"near_tolerance_cases": near, "count": len(near)})

    with phase("rerank_latency", card, seconds):
        for lane, (weights, gate) in lanes.items():
            out["latency"][lane] = {}
            for b in BURSTS:
                lat = []
                for rep in range(6):
                    qs = queries_for(rng, b, probs)
                    t0 = time.perf_counter()
                    futs = [batcher.submit(q, TOP_K, 0.0, weights, **gate) for q in qs]
                    for f in futs:
                        f.result(timeout=600)
                    if rep:  # the first burst of a size is a warm-up
                        lat.append((time.perf_counter() - t0) * 1e3)
                out["latency"][lane][b] = lat
        check_fallbacks(engine, batcher, "rerank_latency")

    with phase("rerank_breakdown", card, seconds):
        for lane in lanes:
            log({**rerank_stages(engine, rng, probs, lane), "card": card})
        check_fallbacks(engine, batcher, "rerank_breakdown")
        log({**judge_forward_times(judge, dev), "card": card})
    os.environ.pop("RAG_TPU_FUSED_ATTN")
    return out


# --------------------------------------------------------------- server ----

# what a user sends to /search for each lane (a bare {"query": ...} takes
# the object lane: the HTTP defaults are diversity 0.3 with the reranker on)
HTTP_LANES = {
    "hot": {"diversity_factor": 0, "use_reranker": False},
    "mmr": {"diversity_factor": DIVERSITY, "use_reranker": False},
    "judged": {"diversity_factor": 0, "use_reranker": True, "weights": {"reranker": 0.0, "initial": 1.0},
               **JUDGED_GATE},
    "object": {},
}
# the serializer writes 7 fractional digits (a parsed score is within 5e-8
# of its f32), and batches of other shapes sum f32 dots of unit vectors in
# other orders (~1e-7): an HTTP answer and the in-process one agree within
SERVER_TOL = 1e-6
DISK_BEHIND = 32000  # chunks left on disk under the running server (C8)
HTTP_BURSTS = (1, 16, 64)
SERIALIZER_SOURCE = "rust_local_rag_tpu_torch/csrc/serializer.cpp"
GATE_QUERIES = "eval_harness/ground_truth/queries.jsonl"
GATE_TOP_K = 5  # eval_harness/configs/baseline.yaml top_k
GATE_REPLAY = (15, 33)  # rejection queries, then the first retrieval queries, replayed on a CPU copy
# gate_check's two bodies: the judged lane (diversity 0, named), and the
# eval harness's own body (eval_harness/runner.py evaluate_query: query,
# top_k and baseline.yaml's search_params, no diversity_factor), which the
# server's defaults (diversity 0.3, reranker on) send to the object lane
# with MMR
GATE_BODIES = {"judged": HTTP_LANES["judged"],
               "harness": {k: v for k, v in HTTP_LANES["judged"].items()
                           if k not in ("diversity_factor", "use_reranker")}}
ROOT = os.path.dirname(os.path.abspath(__file__))
BAD_SEARCH = [b"{not json", b"[1]", b'{"query": "x", "top_k": "many"}', b'{"query": "x", "diversity_factor": NaN}',
              b'{"query": "x", "use_reranker": "yes"}', b'{"query": "x", "rejection_threshold": "high"}',
              b'{"query": "x", "rejection_unseen_mass": Infinity}']


class Http:
    """One keep-alive client connection (http.client: the port imports no
    requests)."""

    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def call(self, method: str, path: str, body=None, headers=None):
        data = body if isinstance(body, bytes) or body is None else json.dumps(body).encode()
        self.conn.request(method, path, body=data, headers=headers or {})
        r = self.conn.getresponse()
        raw = r.read()
        parsed = json.loads(raw) if "json" in (r.getheader("Content-Type") or "") else raw
        return r.status, {k.lower(): v for k, v in r.getheaders()}, parsed

    def close(self) -> None:
        self.conn.close()


# the burst client of http_check and http_latency, run as a process of its
# own so that its threads do not share the server's interpreter lock: one
# keep-alive connection a client; each stdin line, a JSON list of /search
# bodies, is sent at once (every thread released by one barrier) and
# answered on stdout with the milliseconds from the release to the last
# answer, the statuses and the results
BURST_CLIENT = r"""
import http.client, json, sys, threading, time
port, n = int(sys.argv[1]), int(sys.argv[2])
conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=600) for _ in range(n)]
for line in sys.stdin:
    bodies = [json.dumps(b).encode() for b in json.loads(line)]
    go = threading.Barrier(len(bodies) + 1)
    out = [None] * len(bodies)

    def one(i):
        go.wait()
        conns[i].request("POST", "/search", body=bodies[i])
        r = conns[i].getresponse()
        out[i] = (r.status, r.read())

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    go.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({"ms": ms, "status": [st for st, _ in out],
                      "results": [json.loads(b)["results"] if st == 200 else b.decode()[:300] for st, b in out]}),
          flush=True)
"""


class BurstClient:
    """BURST_CLIENT in a subprocess, n keep-alive connections to the port."""

    def __init__(self, port: int, n: int):
        self.proc = subprocess.Popen([sys.executable, "-c", BURST_CLIENT, str(port), str(n)], stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True)

    def burst(self, lane: str, queries: list, top_k: int = TOP_K):
        """(ms from the release of the burst's requests to its last answer,
        each query's parsed results): each query a concurrent POST /search
        on its own keep-alive connection."""
        self.proc.stdin.write(json.dumps([{"query": q, "top_k": top_k, **HTTP_LANES[lane]} for q in queries]) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise AssertionError(f"the burst client exited with {self.proc.wait(timeout=60)}")
        out = json.loads(line)
        if set(out["status"]) != {200}:
            raise AssertionError(f"/search answered {out['status']}: {out['results']}")
        return out["ms"], out["results"]

    def close(self) -> None:
        self.proc.stdin.close()
        try:
            self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def lane_args(p: dict):
    """(diversity, QueryWeights or None, submit options) of a /search
    body's parameters p, with the server's defaults."""
    kw = {k: v for k, v in p.items() if k.startswith("rejection_")}
    w = p.get("weights")
    return p.get("diversity_factor", 0.3), QueryWeights(**w) if w else None, dict(kw, use_reranker=p.get(
        "use_reranker", True))


def serve_runtime(ctx):
    """ctx served by HttpServer.run, the serve loop of main, on a thread."""
    server = HttpServer(App(ctx), "127.0.0.1", 0)
    ready = threading.Event()
    thread = threading.Thread(target=server.run, kwargs={"ready": ready.set}, daemon=True)
    thread.start()
    if not ready.wait(60):
        raise AssertionError("the server did not start")
    return server, thread


def stop_runtime(ctx, server, thread) -> None:
    ctx.supervisor.stop(timeout=30)
    server.stop()
    thread.join(timeout=60)
    ctx.batcher.stop()
    if thread.is_alive():
        raise AssertionError("the server thread did not stop")


def wait_ready(port: int, timeout: float, proc=None) -> float:
    """Seconds until GET /readyz answers 200."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"the server exited with {proc.returncode} before it was ready")
        try:
            c = Http(port)
            status = c.call("GET", "/readyz")[0]
            c.close()
            if status == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"/readyz did not answer 200 within {timeout} s")


def wait_job(c: Http, job_id: str, timeout: float = 900) -> dict:
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        job = c.call("GET", f"/jobs/{job_id}")[2]
        if job["status"] in ("completed", "failed"):
            return job
        time.sleep(0.05)
    raise AssertionError(f"job {job_id} did not finish in {timeout} s")


def batcher_burst(batcher, lane: str, queries: list, top_k: int = TOP_K):
    """(ms, answers) of the same burst submitted in process."""
    div, weights, kw = lane_args(HTTP_LANES[lane])
    t0 = time.perf_counter()
    futs = [batcher.submit(q, top_k, div, weights, **kw) for q in queries]
    res = [f.result(timeout=600) for f in futs]
    return (time.perf_counter() - t0) * 1e3, res


def compare_http(lane: str, got: list, want: list, queries: list, near: list, worst: dict, what: str) -> None:
    """HTTP answers (parsed rows) against the in-process SearchBatcher's on
    the same engine. Hot and MMR lanes: the same rows up to ties within
    SERVER_TOL. Judged and object lanes, the rerank_check rules (a batch of
    another shape may round the judge's bf16 elsewhere): first-stage
    scores of common rows within SERVER_TOL, judge outputs within RR_TOL /
    LOGPROB_TOL; where the judge outputs agree within SERVER_TOL the
    answers must be equal, else an order or membership difference is
    printed and counted; a judged-lane rejection that differs only where
    the best yes-probability lies within RR_TOL of the judge-rescue term."""
    for q, a, b in zip(queries, got, want):
        b = [r.to_dict() for r in b]
        if lane in ("hot", "mmr"):
            key = lambda r: (r["chunk_id"], r["score"], r["embedding_score"], r["lexical_score"])  # noqa: E731
            same_topk([key(r) for r in a], [key(r) for r in b], SERVER_TOL, f"{what} {q!r}")
            continue
        if bool(a) != bool(b):
            best = max(r["reranker_score"] for r in a + b)
            if lane != "judged" or abs(best - JUDGED_GATE["rejection_unseen_judge"]) > RR_TOL:
                raise AssertionError(f"{what} {q!r}: {len(a)} rows over HTTP, {len(b)} in process")
            near.append({"lane": lane, "check": what, "query": q, "kind": "gate", "best_yes_p": best})
            continue
        ga, gb = {r["chunk_id"]: r for r in a}, {r["chunk_id"]: r for r in b}
        rr_diff = 0.0
        for cid in set(ga) & set(gb):
            x, y = ga[cid], gb[cid]
            first = max(abs(x[k] - y[k]) for k in ("initial_score", "embedding_score", "lexical_score"))
            if first > SERVER_TOL:
                raise AssertionError(f"{what} {q!r} {cid}: first-stage scores differ by {first}")
            compare_judge((x["reranker_score"], x["yes_logprob"], x["no_logprob"]),
                          (y["reranker_score"], y["yes_logprob"], y["no_logprob"]), f"{what} {q!r} {cid}", worst)
            rr_diff = max(rr_diff, abs(x["reranker_score"] - y["reranker_score"]))
        same = [r["chunk_id"] for r in a] == [r["chunk_id"] for r in b] and all(
            abs(ga[c]["score"] - gb[c]["score"]) <= SERVER_TOL for c in ga)
        if not same:
            if rr_diff <= SERVER_TOL:
                raise AssertionError(f"{what} {q!r}: the answers differ with the same judge outputs")
            near.append({"lane": lane, "check": what, "query": q, "kind": "order", "max_rr_diff": rr_diff})


def mcp_call(c: Http, method: str, params=None, sid=None, rid: int = 1):
    body = {"jsonrpc": "2.0", "id": rid, "method": method}
    if params is not None:
        body["params"] = params
    status, headers, out = c.call("POST", "/mcp", body, {"Mcp-Session-Id": sid} if sid else None)
    if status != 200 or "error" in out or out["result"].get("isError"):
        raise AssertionError(f"MCP {method}: {status} {out}")
    return headers, out["result"]


def sse_reader(port: int, sid: str, events: list) -> threading.Thread:
    """A thread reading the session's GET /mcp stream into `events` (the
    JSON-RPC messages) until the stream ends."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    conn.request("GET", "/mcp", headers={"Accept": "text/event-stream", "Mcp-Session-Id": sid})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"GET /mcp answered {resp.status}")

    def read():
        try:
            while line := resp.readline():
                if line.startswith(b"data: "):
                    events.append(json.loads(line[6:]))
        finally:
            conn.close()

    t = threading.Thread(target=read, daemon=True)
    t.start()
    return t


def timed_ms(fn, reps: int = 20) -> float:
    """Median host milliseconds of fn() (host code: no device work)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def entry_point_check(data_dir: str, ref_port: int, tmp: str, query: str, n_chunks: int, during=None) -> dict:
    """`python -m rust_local_rag_tpu_torch` on its own copy of the index:
    ready, one hot-lane answer equal to the in-process server's,
    `during(port)` (phase tui) while it serves, then
    (ROADMAP C8) the saved index on disk is cut back to its first
    DISK_BEHIND chunks while the server runs, so the server's whole index
    is a state no save covers; SIGTERM must run the graceful flush, whose
    save must complete within its 5 s budget, and exit 0, and the index on
    disk must then hold every chunk the server held."""
    port = free_port()
    logs = os.path.join(tmp, "entry_logs")
    profile_port = free_port()
    env = dict(os.environ, DATA_DIR=data_dir, DOCUMENTS_DIR=os.path.join(tmp, "entry_docs"), LOG_DIR=logs,
               MCP_HTTP_BIND=f"127.0.0.1:{port}", RAG_TPU_PROFILE_PORT=str(profile_port),
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    env.pop("RAG_TPU_PLATFORM", None)
    out_path = os.path.join(tmp, "entry_out.txt")
    with open(out_path, "w") as out_f:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "rust_local_rag_tpu_torch"], cwd=ROOT, env=env,
                                stdout=out_f, stderr=subprocess.STDOUT)
        try:
            ready_s = wait_ready(port, 600, proc)
            body = {"query": query, "top_k": TOP_K, **HTTP_LANES["hot"]}
            a, b = Http(port).call("POST", "/search", body), Http(ref_port).call("POST", "/search", body)
            if a[0] != 200 or b[0] != 200:
                raise AssertionError(f"entry point /search: {a[0]} and {b[0]}")
            key = lambda r: (r["chunk_id"], r["score"], r["embedding_score"], r["lexical_score"])  # noqa: E731
            same_topk([key(r) for r in a[2]["results"]], [key(r) for r in b[2]["results"]], SERVER_TOL,
                      "entry point vs in-process server")
            capture = entry_capture(port, profile_port, query, os.path.join(tmp, "entry_traces"))
            if during is not None:
                during(port)
            full = persistence.load_index(data_dir, get_embedding_model()).state
            behind = persistence.IndexState(model=full.model, embeddings=full.embeddings[:DISK_BEHIND],
                                            metas=full.metas[:DISK_BEHIND], document_hashes=full.document_hashes)
            persistence.save_index(data_dir, behind)
            t_stop = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=120)
            stop_s = time.perf_counter() - t_stop
            if code != 0:
                raise AssertionError(f"python -m rust_local_rag_tpu_torch exited {code}")
        except BaseException:
            with open(out_path) as f:
                log(f"entry point output:\n{f.read()[-3000:]}")
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(os.path.join(logs, "rust-local-rag-tpu.log")) as f:
        messages = [json.loads(line)["message"] for line in f]
    # graceful_flush: the write lock, then a save with the reference's 5 s
    # budget (main.rs:217-241), which must now complete
    flush = [m for m in messages if m.startswith(("RAG state successfully saved", "Save operation timed out"))]
    if ("Lock acquired. Flushing state to disk (5s timeout)..." not in messages
            or flush != ["RAG state successfully saved to disk"] or messages[-1] != "MCP server shut down gracefully"):
        raise AssertionError(f"entry point: no completed graceful flush in its log ({messages[-3:]})")
    state = persistence.load_index(data_dir, get_embedding_model()).state
    if state is None or len(state.metas) != n_chunks or {m.id for m in state.metas} != {m.id for m in full.metas}:
        raise AssertionError("entry point: the index on disk after the shutdown is not the server's")
    return {"entry_ready_s": ready_s, "entry_total_s": time.perf_counter() - t0, "entry_sigterm_to_exit_s": stop_s,
            "entry_exit_code": code, "entry_same_answer": a[2] == b[2], "entry_flush": flush[0],
            "entry_disk_behind_chunks": DISK_BEHIND, "entry_index_loads_after_exit": len(state.metas),
            "entry_capture": capture}


def entry_capture(port: int, profile_port: int, query: str, log_dir: str, ms: float = 1500) -> dict:
    """POST /capture to the entry point's RAG_TPU_PROFILE_PORT listener
    while a thread sends it hot-lane searches: the trace must hold the
    server's device kernels."""
    stop = threading.Event()
    sent = []

    def load():
        c = Http(port)
        while not stop.is_set():
            sent.append(c.call("POST", "/search", {"query": query, "top_k": TOP_K, **HTTP_LANES["hot"]})[0])
        c.close()

    t = threading.Thread(target=load, daemon=True)
    t.start()
    try:
        status, _, body = Http(profile_port).call("POST", "/capture", {"duration_ms": ms, "log_dir": log_dir})
    finally:
        stop.set()
        t.join(timeout=60)
    if status != 200:
        raise AssertionError(f"POST /capture answered {status}: {body}")
    with open(body["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    if kernels == 0 or set(sent) != {200}:
        raise AssertionError(f"the captured trace holds {kernels} kernels ({len(sent)} searches: {set(sent)})")
    return {"duration_ms": body["duration_ms"], "events": body["events"], "kernels": kernels,
            "searches_during": len(sent), "trace_bytes": os.path.getsize(body["trace"])}


def run_server(engine, card: str, seconds: dict, tmp: str, pdfs: dict, rng, probs) -> dict:
    """The server tier on the card over a copy of the saved index (the
    33,033 ingest chunks; slab 65,536, so the masked kernel runs), with
    the committed encoder and reranker and RAG_TPU_FUSED_ATTN=1."""
    env_keys = ("RAG_TPU_FUSED_ATTN", "RAG_TPU_RERANK_MODEL", "LOG_DIR")
    os.environ.update(RAG_TPU_FUSED_ATTN="1", RAG_TPU_RERANK_MODEL=engine.reranker.model_name,
                      LOG_DIR=os.path.join(tmp, "server_logs"))
    docs = os.path.join(tmp, "server_docs")
    os.makedirs(docs)
    for name, data in pdfs.items():
        with open(os.path.join(docs, name), "wb") as f:
            f.write(data)

    def data_copy(name: str) -> str:
        """The files of the saved index (the top level of tmp)."""
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for f in os.listdir(tmp):
            if os.path.isfile(os.path.join(tmp, f)):
                shutil.copy2(os.path.join(tmp, f), d)
        return d

    out = {}
    ctx = server = thread = client = None
    try:
        with phase("server_start", card, seconds):
            t0 = time.perf_counter()
            built = build.build_all()  # main's first step; up to date after the build phase
            t_build = time.perf_counter()
            ctx = build_runtime(data_copy("server_data"), docs, device="cuda")
            t_runtime = time.perf_counter()
            prepare(ctx)
            t_prepare = time.perf_counter()
            server, thread = serve_runtime(ctx)
            bind_s = wait_ready(server.port, 60)
            start = {"server_start_s": time.perf_counter() - t0, "build_all_s": t_build - t0,
                     "built": sorted(n for n, r in built.items() if r.seconds), "build_runtime_s": t_runtime - t_build,
                     "warmup_and_fragments_s": t_prepare - t_runtime, "bind_to_ready_s": bind_s,
                     "chunks": len(ctx.engine.store), "fragments": ctx.batcher._serializer().count()}
            if start["chunks"] != start["fragments"] or start["chunks"] <= N_SLAB // 2:
                raise AssertionError(f"server_start: {start}")
            log({**start, "card": card})
            out["start"] = start

        with phase("entry_point", card, seconds):
            n_chunks = len(ctx.engine.store)

            def during(port: int) -> None:
                with phase("tui", card, seconds):
                    out["tui"] = tui_check(port, card, tmp, queries_for(rng, 1, probs)[0], n_chunks)

            ep = entry_point_check(data_copy("entry_data"), server.port, tmp, queries_for(rng, 1, probs)[0],
                                   n_chunks, during)
            log({**ep, "card": card})
            out["entry_point"] = ep

        c = Http(server.port)
        with phase("reindex", card, seconds):
            for i in range(2):  # two new PDFs beside the smoke's three
                pages = ["\n\n".join([f"BULLETIN {i}.{p}"] + passages(rng, 3, probs, sentences=(5, 6)))
                         for p in range(3)]
                with open(os.path.join(docs, f"bulletin_{i}.pdf"), "wb") as f:
                    f.write(make_pdf(pages))
            headers, _ = mcp_call(c, "initialize")
            sid = headers["mcp-session-id"]
            events: list = []
            reader = sse_reader(server.port, sid, events)
            session = server.app.hub.get(sid)
            deadline = time.perf_counter() + 30
            while not session._listeners and time.perf_counter() < deadline:
                time.sleep(0.01)
            chunks0 = c.call("GET", "/stats")[2]["chunks"]
            jobs, times = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                status, _, body = c.call("POST", "/reindex")
                if status != 200:
                    raise AssertionError(f"POST /reindex answered {status}")
                jobs.append(wait_job(c, body["job_id"]))
                times.append(time.perf_counter() - t0)
                if c.call("GET", "/jobs/active")[2] is not None:
                    raise AssertionError("/jobs/active is not null after the job")
                jobs[-1]["chunks"] = c.call("GET", "/stats")[2]["chunks"]
            # the push follows the job by up to one 0.4 s poll of its watcher
            want = {(j["job_id"], "completed") for j in jobs}
            deadline = time.perf_counter() + 30
            while not want <= {(e["params"]["data"]["job_id"], e["params"]["data"]["status"]) for e in events}:
                if time.perf_counter() > deadline:
                    raise AssertionError(f"no completion pushed for {want} in {len(events)} events")
                time.sleep(0.05)
            status, _, _ = c.call("DELETE", "/mcp", headers={"Mcp-Session-Id": sid})
            reader.join(timeout=30)
            if status != 200 or reader.is_alive():
                raise AssertionError("the MCP session's stream did not end on DELETE")
            pushed = {(e["params"]["data"]["job_id"], e["params"]["data"]["status"]) for e in events}
            with open(os.path.join(os.environ["LOG_DIR"], "progress_tracking.log")) as f:
                lines = f.read().splitlines()
            done = {j["job_id"]: [ln for ln in lines if f"job={j['job_id']} " in ln and " event=done " in ln]
                    for j in jobs}
            for j in jobs:
                if j["status"] != "completed" or j["error"] or not j["progress"] == j["total"] == len(pdfs) + 2:
                    raise AssertionError(f"reindex job {j}")
                if (j["job_id"], "completed") not in pushed or len(done[j["job_id"]]) != 1:
                    raise AssertionError(f"job {j['job_id']}: no completion pushed or logged")
            if not (jobs[0]["chunks"] > chunks0 and jobs[1]["chunks"] == jobs[0]["chunks"]):
                raise AssertionError(f"reindex: chunks {chunks0} -> {jobs[0]['chunks']} -> {jobs[1]['chunks']}")
            if "skipped=5 embedded=0" not in done[jobs[1]["job_id"]][0]:
                raise AssertionError(f"the second reindex did not hash-skip: {done[jobs[1]['job_id']][0]}")
            rx = {"reindex_s": times, "documents": jobs[0]["total"], "chunks_before": chunks0,
                  "chunks_after": [j["chunks"] for j in jobs], "pushed_notifications": len(events),
                  "progress_lines": sum(f"job={j['job_id']} " in ln for j in jobs for ln in lines),
                  "first_done": done[jobs[0]["job_id"]][0].split(" event=done ")[1]}
            log({**rx, "card": card})
            out["reindex"] = rx

        client = BurstClient(server.port, max(HTTP_BURSTS))
        with phase("http_check", card, seconds):
            near: list = []
            worst = {"rr": 0.0, "logprob": 0.0}
            # the encoder pads a batch to its longest query, so a query's
            # bf16 embedding depends on the batch the batcher formed: the
            # in-process burst reuses the rows the HTTP burst computed
            q_rows = {}
            prep = ctx.engine._prep_queries
            encoder = ctx.engine.embedding_service._model.encoder
            judge = ctx.engine.reranker._model
            forwards = {"encoder": 0, "judge": 0}

            def recording_prep(queries, nq_pad):
                out = prep(queries, nq_pad)
                q_rows.update(zip(queries, out))
                return out

            def replay_prep(queries, nq_pad):
                out = torch.zeros((nq_pad, DIM), dtype=torch.float32, device=ctx.engine.device)
                for i, q in enumerate(queries):
                    out[i] = q_rows[q]
                return out

            def zero_launches() -> None:
                score_segmax.launches = fused_attention.launches = 0
                forwards.update(encoder=0, judge=0)

            def read_launches(what: str, judged: bool) -> dict:
                """The launches since zero_launches, all of them from the
                HTTP requests just answered: the masked kernel above 0, and
                every attention launch one of a judge (4 layers) or query
                encoder (6 layers) forward, judge forwards only where the
                lane reranks."""
                got = {"score_segmax_masked": score_segmax.launches, "fused_attention": fused_attention.launches,
                       "judge_forwards": forwards["judge"], "query_encoder_forwards": forwards["encoder"]}
                want = judge.cfg.depth * forwards["judge"] + encoder.cfg.depth * forwards["encoder"]
                if (got["score_segmax_masked"] <= 0 or got["fused_attention"] <= 0
                        or got["fused_attention"] != want or (forwards["judge"] > 0) != judged):
                    raise AssertionError(f"http_check {what}: launches {got}, want {want} attention launches "
                                         f"and judge forwards {'above' if judged else 'at'} 0")
                return got

            http_launches = {}
            encoder.forward = counting(encoder.forward, forwards, "encoder")
            judge.model.forward_last_logits = counting(judge.model.forward_last_logits, forwards, "judge")
            try:
                for lane in HTTP_LANES:
                    qs = queries_for(rng, 16, probs)
                    ctx.engine._prep_queries = recording_prep
                    zero_launches()
                    _, got = client.burst(lane, qs)
                    http_launches[lane] = read_launches(lane, lane in ("judged", "object"))
                    ctx.engine._prep_queries = replay_prep
                    _, want = batcher_burst(ctx.batcher, lane, qs)
                    del ctx.engine._prep_queries
                    compare_http(lane, got, want, qs, near, worst, f"http_check {lane}")
                    log({"http_check": lane, "queries": len(qs), "rows": sum(map(len, got)),
                         "rejected": sum(not a for a in got), "launches": http_launches[lane]})
                q = queries_for(rng, 1, probs)[0]
                headers, init = mcp_call(c, "initialize")
                sid = headers["mcp-session-id"]
                tools = mcp_call(c, "tools/list", sid=sid)[1]["tools"]
                zero_launches()
                text = mcp_call(c, "tools/call", {"name": "search_documents", "arguments": {
                    "query": q, "top_k": TOP_K, "diversity_factor": 0, "use_reranker": False}}, sid)[1]["content"][0][
                    "text"]
                http_launches["mcp_search_documents"] = read_launches("MCP search_documents", False)
                zero_launches()
                cal_text = mcp_call(c, "tools/call", {"name": "calibrate_reranker", "arguments": {
                    "query": q, "sample_size": 5}}, sid)[1]["content"][0]["text"]
                http_launches["mcp_calibrate_reranker"] = read_launches("MCP calibrate_reranker", True)
            finally:
                del encoder.forward, judge.model.forward_last_logits
            stats_text = mcp_call(c, "tools/call", {"name": "get_stats"}, sid)[1]["content"][0]["text"]
            job_text = mcp_call(c, "tools/call", {"name": "get_job_status", "arguments": {
                "job_id": jobs[0]["job_id"]}}, sid)[1]["content"][0]["text"]
            res = ctx.batcher.search(q, TOP_K, 0.0, None, use_reranker=False)
            if text != f"Found {len(res)} results for '{q}':\n\n{format_search_results(res)}" or not res:
                raise AssertionError("MCP search_documents differs from format_search_results of the batcher's answer")
            if (init["protocolVersion"] != "2025-03-26" or len(tools) != 6 or "RAG System Stats" not in stats_text
                    or '"status": "completed"' not in job_text or "Reranker Calibration Results" not in cal_text):
                raise AssertionError("MCP initialize / tools/list / get_stats / get_job_status / calibrate_reranker")
            bad = [c.call("POST", "/search", b)[0] for b in BAD_SEARCH]
            if set(bad) != {400}:
                raise AssertionError(f"bad /search bodies answered {bad}")
            launches = {k: sum(x[k] for x in http_launches.values())
                        for k in ("score_segmax_masked", "fused_attention")}
            log({"http_launches": http_launches, "near_tolerance_cases": near, "count": len(near),
                 "judge_max_diff_http_vs_inprocess": worst, "bad_inputs_400": len(bad), "card": card})
            check_fallbacks(ctx.engine, ctx.batcher, "http_check")
            out["launches"] = launches
            # the serializer against json.dumps of to_dict, one 16-query hot batch
            qs = queries_for(rng, 16, probs)
            col = ctx.engine.fetch_columnar(ctx.engine.dispatch_search(qs, TOP_K))
            ser = ctx.batcher._serializer()
            planes = (col.slots[:16], col.vals[:16], col.emb[:16], col.lex[:16])
            objs = [ctx.engine.results_from_columnar(col, qi) for qi in range(16)]
            for body, res in zip(ser.serialize_batch(*planes, floor=col.floor), objs):
                key = lambda r: (r["chunk_id"], r["score"], r["embedding_score"], r["lexical_score"])  # noqa: E731
                same_topk([key(r) for r in json.loads(body)["results"]], [key(r.to_dict()) for r in res],
                          SERVER_TOL, "serializer vs to_dict")
            out["serializer"] = {
                "batch16_serialize_ms": timed_ms(lambda: ser.serialize_batch(*planes, floor=col.floor)),
                "batch16_json_dumps_ms": timed_ms(
                    lambda: [json.dumps({"results": [r.to_dict() for r in res]}).encode() for res in objs]),
                "batch16_objects_ms": timed_ms(lambda: [ctx.engine.results_from_columnar(col, qi) for qi in range(16)]),
                "build_s": built["serializer"].seconds,
            }
            log({**out["serializer"], "card": card})

        with phase("http_latency", card, seconds):
            # what the batcher saw of each burst: the batch sizes it formed
            # and the spread of the requests' arrivals
            sizes, arrivals = [], []
            dispatch, submit = ctx.engine.dispatch_search, ctx.batcher.submit

            def recording_dispatch(queries, *a, **kw):
                sizes.append(len(queries))
                return dispatch(queries, *a, **kw)

            def recording_submit(*a, **kw):
                arrivals.append(time.perf_counter())
                return submit(*a, **kw)

            def seen():
                out = (list(sizes), (max(arrivals) - min(arrivals)) * 1e3)
                sizes.clear()
                arrivals.clear()
                return out

            ctx.engine.dispatch_search, ctx.batcher.submit = recording_dispatch, recording_submit
            rows = []
            try:
                for lane in ("hot", "judged"):
                    for b in HTTP_BURSTS:
                        h, p, hb, pb, hs = [], [], [], [], []
                        for rep in range(6):  # HTTP and in process in turns; the first pair is a warm-up
                            ms_h, _ = client.burst(lane, queries_for(rng, b, probs))
                            batches_h, spread_h = seen()
                            ms_p, _ = batcher_burst(ctx.batcher, lane, queries_for(rng, b, probs))
                            batches_p, _ = seen()
                            if rep:
                                h.append(ms_h)
                                p.append(ms_p)
                                hb.append(batches_h)
                                pb.append(batches_p)
                                hs.append(spread_h)
                        row = {"http_burst": b, "lane": lane, "top_k": TOP_K, "http_median_ms": statistics.median(h),
                               "inprocess_median_ms": statistics.median(p),
                               "diff_ms": statistics.median(h) - statistics.median(p), "http_ms": h, "inprocess_ms": p,
                               "http_batches": hb, "inprocess_batches": pb, "http_arrival_spread_ms": hs}
                        log({**row, "card": card})
                        rows.append(row)
            finally:
                del ctx.engine.dispatch_search, ctx.batcher.submit
            check_fallbacks(ctx.engine, ctx.batcher, "http_latency")
            out["latency"] = rows
        c.close()
    finally:
        if client is not None:
            client.close()
        if server is not None:
            stop_runtime(ctx, server, thread)

    with phase("gate_check", card, seconds):
        out["gate"] = gate_check(card, tmp)
    for k in env_keys:
        os.environ.pop(k, None)
    return out


def gate_check(card: str, tmp: str) -> dict:
    """ROADMAP C2: the eval corpus (31 authored documents + 45 distractors)
    reindexed by a second runtime over HTTP; the 168 dev queries sent one at
    a time with baseline.yaml's parameters, twice: through the judged lane
    (diversity 0 named in the body), and with the eval harness's own body
    (no diversity_factor: the object lane with MMR at the server's default
    0.3). Then the 15 rejection queries and the first 33 retrieval queries
    of each pass are replayed in process on the card, which must decide as
    the HTTP answers did, and on a CPU copy under the rerank_check rules
    (a gate decision may differ only where the plain side's best judged
    yes-probability lies within RR_TOL of the judge-rescue term)."""
    docs = os.path.join(tmp, "gate_docs")
    names = generate_corpus(docs, with_distractors=True)
    ctx = build_runtime(os.path.join(tmp, "gate_data"), docs, device="cuda")
    prepare(ctx)
    server, thread = serve_runtime(ctx)
    try:
        c = Http(server.port)
        t0 = time.perf_counter()
        job = wait_job(c, c.call("POST", "/reindex")[2]["job_id"])
        reindex_s = time.perf_counter() - t0
        stats = c.call("GET", "/stats")[2]
        if job["status"] != "completed" or job["error"] or stats["documents"] != len(names):
            raise AssertionError(f"gate_check reindex: {job} {stats}")
        with open(os.path.join(ROOT, GATE_QUERIES)) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        answers = {lane: {} for lane in GATE_BODIES}
        http_s = {}
        for lane, params in GATE_BODIES.items():
            t0 = time.perf_counter()
            for r in rows:
                status, _, body = c.call("POST", "/search", {"query": r["query"], "top_k": GATE_TOP_K, **params})
                if status != 200:
                    raise AssertionError(f"gate_check {lane} {r['query_id']}: {status}")
                answers[lane][r["query_id"]] = body["results"]
            http_s[lane] = time.perf_counter() - t0
        c.close()
        rej = [r for r in rows if r["is_rejection"]]
        ret = [r for r in rows if not r["is_rejection"]]
        # the replay: one query a batch, as the requests were served
        replay = rej[:GATE_REPLAY[0]] + ret[:GATE_REPLAY[1]]
        engine = ctx.engine
        div, weights, kw = lane_args(GATE_BODIES["harness"])
        q_embs = {}
        best_yes = {}  # query -> the CPU copy's best judged yes-probability over its pool
        prep = engine._prep_queries

        def recording_prep(queries, nq_pad):
            q_embs[tuple(queries)] = out = prep(queries, nq_pad)
            return out

        engine._prep_queries = recording_prep
        try:
            card_recs, card_obj = [], []
            for r in replay:
                pre, jc = judged_pass(engine, [r["query"]], GATE_TOP_K)
                card_recs.append({"queries": [r["query"]], "pre_slots": pre, "jc": jc})
                card_obj.append(ctx.batcher.search(r["query"], GATE_TOP_K, div, weights, **kw))
        finally:
            del engine._prep_queries
        for r, rec, res in zip(replay, card_recs, card_obj):
            _, rejected = judged_rows(rec["jc"], rec["pre_slots"], 0)
            if rejected != (not answers["judged"][r["query_id"]]) or (not res) != (
                    not answers["harness"][r["query_id"]]):
                raise AssertionError(f"gate_check {r['query_id']}: in process (judged {rejected}, harness "
                                     f"{not res}), over HTTP the opposite")
        os.environ["RAG_TPU_FUSED_ATTN"] = "1"
        cpu = cpu_copy(engine, tmp)
        cpu._prep_queries = lambda queries, nq_pad: q_embs[tuple(queries)].cpu()
        rerank = cpu._rerank_flat

        def recording_rerank(queries, flat_inputs, nq):
            """The object lane's judge over each query's pool, recording
            the best yes-probability, which the judge-rescue term reads."""
            out = rerank(queries, flat_inputs, nq)
            for q, judged in zip(queries, out):
                best_yes[q] = max((x.relevance for x in judged), default=float("-inf"))
            return out

        cpu._rerank_flat = recording_rerank
        near: list = []
        worst = {"rr": 0.0, "logprob": 0.0}
        judge_t = JUDGED_GATE["rejection_unseen_judge"]
        for r, rec, res in zip(replay, card_recs, card_obj):
            pre, jc = judged_pass(cpu, rec["queries"], GATE_TOP_K)
            compare_judged(rec, pre, jc, False, near, worst, f"gate_check {r['query_id']}, CPU copy")
            what = f"gate_check harness {r['query_id']}, CPU copy"
            plain = cpu.search_with_diversity_batch([r["query"]], GATE_TOP_K, div, weights, **kw)[0]
            if bool(res) != bool(plain):
                best = best_yes[r["query"]]
                if abs(best - judge_t) > RR_TOL:
                    raise AssertionError(f"{what}: gate {not res} vs {not plain}, plain best yes-p {best}")
                near.append({"lane": "harness", "check": what, "query": r["query"], "kind": "gate",
                             "plain_value": best, "threshold": judge_t})
                continue
            compare_object([res], [plain], [r["query"]], False, near, worst, what)
        check_fallbacks(engine, ctx.batcher, "gate_check")
        gate = {"documents": stats["documents"], "chunks": stats["chunks"], "reindex_s": reindex_s,
                "queries": len(rows), "rejection_queries": len(rej), "retrieval_queries": len(ret),
                "replayed": len(replay), "replay_near_cases": near, "replay_worst": worst}
        for lane in GATE_BODIES:
            got = answers[lane]
            fired = sum(not got[r["query_id"]] for r in rows)
            gate[lane] = {"body": GATE_BODIES[lane], "http_s": http_s[lane],
                          "rejection_queries_empty": sum(not got[r["query_id"]] for r in rej),
                          "retrieval_queries_empty": sum(not got[r["query_id"]] for r in ret),
                          "fired": fired, "c2": "closed" if fired else "open"}
        log({**gate, "card": card})
        return gate
    finally:
        stop_runtime(ctx, server, thread)


# ------------------------- SRX, PDF tiers, trace, quality, the benches ----


# tests/test_srx_engine.py's _MINI ruleset: "Mr. " guarded, any [.!?] + space a break
SRX_MINI = """<?xml version="1.0" encoding="UTF-8"?>
<srx xmlns="http://www.lisa.org/srx20" version="2.0">
<header segmentsubflows="yes" cascade="yes"></header>
<body>
<languagerules>
<languagerule languagerulename="Guard">
<rule break="no"><beforebreak>\\bMr\\.\\s</beforebreak><afterbreak></afterbreak></rule>
</languagerule>
<languagerule languagerulename="Breaker">
<rule break="yes"><beforebreak>[\\.!?]\\s</beforebreak><afterbreak></afterbreak></rule>
</languagerule>
<languagerule languagerulename="FrenchOnly">
<rule break="no"><beforebreak>\\bM\\.\\s</beforebreak><afterbreak></afterbreak></rule>
</languagerule>
</languagerules>
<maprules>
<languagemap languagepattern=".*" languagerulename="Guard"></languagemap>
<languagemap languagepattern="(FR|fr).*" languagerulename="FrenchOnly"></languagemap>
<languagemap languagepattern=".*" languagerulename="Breaker"></languagemap>
</maprules>
</body>
</srx>
"""
SRX_TEXT = ("Prof. Smith arrived at 3 p.m. today. Mr. Jones left early. She stayed! Why not? M. Dupont signed "
            "the contract.\n\nValues rose by 3.5 percent. The file is config.yaml here. We tried e.g. apples. "
            "Dr. Who came back. It trailed off... and resumed.")
TRACE_BURSTS = 5  # 16-query hot-lane bursts in the trace window, then one judged burst
BENCH_STEPS = 4  # bench's chained steps in the smoke (the program's default is 16)
BENCH_DOCS = 60  # bench's full-pipeline documents in the smoke (default 300)
BENCH_SERVER_N = 2 * N_SLAB  # bench_server's chunks in the smoke (the slab runs the masked kernel)
BENCH_SERVER_CLIENTS = (16, 64)
BENCH_SERVER_SECONDS = 4.0


def run_srx(card: str, tmp: str) -> dict:
    """Which splitter RAG_TPU_SRX_FILE gives on this host (the ruleset needs
    the `regex` module), and chunk_text under it against that splitter."""
    from rust_local_rag_tpu_torch.ingest import chunking, srx

    path = os.path.join(tmp, "mini.srx")
    with open(path, "w", encoding="utf-8") as f:
        f.write(SRX_MINI)
    builtin = chunking.split_sentences(SRX_TEXT)
    builtin_chunks = [c.text for c in chunking.chunk_text(SRX_TEXT, 12)]
    with env_set("RAG_TPU_SRX_FILE", path):
        seg = srx.load_segmenter()
        got = chunking.split_sentences(SRX_TEXT)
        chunks = [c.text for c in chunking.chunk_text(SRX_TEXT, 12)]
    if srx._HAVE_REGEX:
        if seg is None or len(seg) != 2:
            raise AssertionError(f"srx: the ruleset did not load ({seg})")
        want = [x for x in (p.strip() for p in seg.split(SRX_TEXT)) if x]
        real_split = chunking.split_sentences
        chunking.split_sentences = lambda t: [x for x in (p.strip() for p in seg.split(t)) if x]
        try:
            want_chunks = [c.text for c in chunking.chunk_text(SRX_TEXT, 12)]
        finally:
            chunking.split_sentences = real_split
        splitter = "srx ruleset"
        if got == builtin:
            raise AssertionError("srx: the ruleset gave the built-in splitter's sentences")
    else:
        if seg is not None:
            raise AssertionError("srx: a segmenter loaded without the regex module")
        want, want_chunks, splitter = builtin, builtin_chunks, "built-in (no regex module on this host)"
    if got != want or chunks != want_chunks:
        raise AssertionError(f"srx: {got} != {want} or {chunks} != {want_chunks}")
    out = {"srx_splitter": splitter, "regex_module": srx._HAVE_REGEX, "sentences": len(got),
           "builtin_sentences": len(builtin), "chunks": len(chunks), "first_sentences": got[:3], "card": card}
    log(out)
    return out


def run_pdf_tiers(card: str, pdfs: dict, built: dict) -> dict:
    """The native tier (csrc/pdftext.cpp) against the built-in one, byte for
    byte, on the smoke's PDFs and the eval corpus's (authored and
    distractors); ms a document for each tier; pdftotext's presence."""
    from eval_harness.corpus import DOCS, _ascii, _make_pdf, load_distractors
    from rust_local_rag_tpu_torch.ingest import pdf as pdf_tiers

    docs = list(pdfs.values()) + [_make_pdf([_ascii(p) for p in d["pages"]]) for d in DOCS + load_distractors()]
    for i, data in enumerate(docs):
        nat, py = pdf_tiers._native_extract(data), pdf_tiers._builtin_extract(data)
        if nat is None or nat != py:
            raise AssertionError(f"pdf_tiers: document {i}: the native tier's text differs from the built-in's")
    times = {}
    for name, fn in (("native", pdf_tiers._native_extract), ("builtin", pdf_tiers._builtin_extract)):
        t0 = time.perf_counter()
        for data in docs:
            fn(data)
        times[f"{name}_ms_per_document"] = (time.perf_counter() - t0) * 1e3 / len(docs)
    which = shutil.which("pdftotext")
    if which:
        t0 = time.perf_counter()
        for data in pdfs.values():
            pdf_tiers._pdftotext_extract(data)
        times["pdftotext_ms_per_document"] = (time.perf_counter() - t0) * 1e3 / len(pdfs)
    res = built["pdftext"]
    out = {"pdftext_build": {"library": res.path.split("/")[-1], "seconds": res.seconds,
                             "compiler_output": res.log.strip()[-500:]},
           "documents": len(docs), "smoke_pdfs": len(pdfs), "byte_identical": True, **times,
           "pdftotext_on_path": which, "card": card}
    log(out)
    return out


def run_trace(engine, batcher, card: str, tmp: str, rng, probs, capture: dict) -> dict:
    """One device_trace window over TRACE_BURSTS 16-query hot-lane bursts
    and one judged burst through the batcher on the served index, in the
    default configuration (RAG_TPU_FUSED_ATTN unset): the device's busy and
    idle share of each lane's span and of the window, the device
    operations that took the most time, and the longest idle gaps with the
    host operation over each. Then the entry point's POST /capture."""
    from torch.profiler import record_function

    from rust_local_rag_tpu_torch.utils.profiling import device_trace, summarize

    if os.environ.get("RAG_TPU_FUSED_ATTN"):
        raise AssertionError("trace: RAG_TPU_FUSED_ATTN is set; the window is the default configuration")
    for lane in ("hot", "judged"):  # each lane warm before the window
        batcher_burst(batcher, lane, queries_for(rng, 16, probs))
    torch.cuda.synchronize()
    # the lanes' host stages, annotated in the trace for the window only,
    # so that each idle gap names the stage the batcher's thread was in
    judge = engine.reranker._model
    stages = [(engine, "_prep_queries", "query encoder"), (engine, "_prep_lexical", "BM25"),
              (engine, "_unseen_gate", "unseen gate"), (engine, "_dispatch", "first stage"),
              (engine, "fetch_columnar", "fetch"), (engine, "judge_columnar", "judge prompts"),
              (judge, "encode", "head/tail tokenising"), (judge, "dispatch_prompts", "judge forward"),
              (engine, "fetch_judged", "judge fetch + gate"), (batcher, "_payloads", "serialize"),
              (batcher, "_answer", "answer futures")]

    def annotated(fn, label):
        def wrapped(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapped

    score_segmax.launches = fused_attention.launches = 0
    for obj, attr, label in stages:
        setattr(obj, attr, annotated(getattr(obj, attr), label))
    try:
        with device_trace(os.path.join(tmp, "traces")) as trace:
            with record_function("smoke_hot_bursts"):
                for _ in range(TRACE_BURSTS):
                    batcher_burst(batcher, "hot", queries_for(rng, 16, probs))
            with record_function("smoke_judged_burst"):
                batcher_burst(batcher, "judged", queries_for(rng, 16, probs))
            torch.cuda.synchronize()
    finally:
        for obj, attr, _ in stages:
            delattr(obj, attr)
    launches = {"score_segmax_masked": score_segmax.launches, "fused_attention": fused_attention.launches}
    spans = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in trace.events
             if e.get("cat") == "user_annotation" and e.get("name", "").startswith("smoke_")}
    if set(spans) != {"smoke_hot_bursts", "smoke_judged_burst"}:
        raise AssertionError(f"trace: the lanes' spans are not in the trace ({sorted(spans)})")
    whole = summarize(trace.events, ignore=tuple(spans))
    lanes = {"hot": summarize(trace.events, window=spans["smoke_hot_bursts"], ignore=tuple(spans)),
             "judged": summarize(trace.events, window=spans["smoke_judged_burst"], ignore=tuple(spans))}
    # the host stages' time on the batcher's threads, summed over the window
    stage_ms = {}
    for e in trace.events:
        if e.get("cat") == "user_annotation" and e.get("name") in {label for _, _, label in stages}:
            stage_ms[e["name"]] = stage_ms.get(e["name"], 0.0) + float(e["dur"]) / 1e3
    if whole["device_ops"] == 0 or launches["score_segmax_masked"] <= 0:
        raise AssertionError(f"trace: {whole['device_ops']} device operations, launches {launches}")
    out = {"trace_file_bytes": os.path.getsize(trace.path), "trace_events": len(trace.events), "launches": launches,
           "window": whole, **{f"{lane}_lane": v for lane, v in lanes.items()},
           "lane_idle_share": {lane: v["device_idle_share"] for lane, v in lanes.items()},
           "host_stage_ms": stage_ms,
           "entry_point_capture": capture, "card": card}
    log(out)
    return out


def run_quality(card: str, tmp: str, seconds: dict) -> dict:
    """evaluation.quality --heldout against the port's server on the card,
    default configuration: each config's summary and the queries whose
    hit_rate or mrr differ from the JAX package's round-5 report; then,
    while that server still serves, phase eval_cli (eval_cli_check)."""
    from rust_local_rag_tpu_torch.evaluation import quality

    if os.environ.get("RAG_TPU_FUSED_ATTN"):
        raise AssertionError("quality: RAG_TPU_FUSED_ATTN is set; the reports ran without it")

    def after(base: str, gt: str, results: dict) -> None:
        with phase("eval_cli", card, seconds):
            eval_cli_check(base, gt, results, tmp, card)

    res = quality.run_quality(os.path.join(tmp, "quality_reports"), heldout=True, device="cuda", log=log,
                              after=after)
    want = {"baseline": 153, "embedding_only": 153, "bm25_only": 153, "baseline_heldout": 157}
    for name, n in want.items():
        summ = res["configs"][name]["summary"]
        if summ["n_queries"] != n or not 0.0 <= summ["hit_rate_mean"] <= 1.0:
            raise AssertionError(f"quality {name}: {summ}")
    out = {"quality_table": {name: {"lane": r["lane"], **{k: r["summary"][k] for k in (
        "hit_rate_mean", "mrr_mean", "rejection_success_rate")}, "jax_round5": {k: r["jax_summary"][k] for k in (
            "hit_rate_mean", "mrr_mean", "rejection_success_rate")}, "differing_queries": len(r["diffs"])}
        for name, r in res["configs"].items()}, "server": {k: res[k] for k in ("ready_s", "reindex_s", "stats")},
        "card": card}
    log(out)
    return out


def run_bench(card: str) -> tuple:
    """python -m rust_local_rag_tpu_torch.bench at bench.py's N with
    BENCH_STEPS chained steps: every line's last step within SCORE_TOL of
    torch.topk over the plain plane. -> (its JSON line, launches)."""
    from rust_local_rag_tpu_torch import bench

    score_segmax.launches = fused_score_segmax.launches = 0
    res = bench.run(n=N_BENCH, steps=BENCH_STEPS, device="cuda", ingest_docs=BENCH_DOCS)
    launches = {"score_segmax_masked": score_segmax.launches, "fused_score_segmax": fused_score_segmax.launches}
    for shape, rows in res["lines"].items():
        for name, row in rows.items():
            if not row["max_abs_err"] <= SCORE_TOL or row["same_index_share"] < 0.99:
                raise AssertionError(f"bench {shape} {name}: {row}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"bench launched {launches}")
    print(json.dumps({"bench": res, "launches": launches, "card": card}), flush=True)
    return res, launches


def run_bench_server(card: str) -> tuple:
    """python -m rust_local_rag_tpu_torch.bench_server at BENCH_SERVER_N
    chunks for BENCH_SERVER_SECONDS a point. -> (its JSON line, launches)."""
    from rust_local_rag_tpu_torch import bench_server

    score_segmax.launches = fused_attention.launches = 0
    res = bench_server.measure_server_qps(n_chunks=BENCH_SERVER_N, clients=BENCH_SERVER_CLIENTS,
                                          seconds=BENCH_SERVER_SECONDS, device="cuda", pipelined=(128, 512),
                                          quiet=True)
    launches = {"score_segmax_masked": score_segmax.launches, "fused_attention": fused_attention.launches}
    for lane in [*res["client_sweep"].values(), res["judged_http"]]:
        if lane["non_200"] or lane["requests"] <= 0:
            raise AssertionError(f"bench_server lane {lane}")
    if launches["score_segmax_masked"] <= 0:
        raise AssertionError(f"bench_server launched {launches}")
    # scripts/bench_server.py's engine lines: the masked kernel in each
    lines = {k: (res[k], res["engine_launches"][k]) for k in BENCH_SERVER_ENGINE_LINES}
    log({"bench_server_engine_lines": {k: {"qps": q, "launches": n} for k, (q, n) in lines.items()},
         "slab_rows": res["slab_rows"], "corpus_dtype": res["corpus_dtype"], "card": card})
    bad = {k: n for k, (q, n) in lines.items() if not (q > 0 and n["score_segmax_masked"] > 0)}
    if bad:
        raise AssertionError(f"bench_server engine lines without a masked-kernel launch: {bad}")
    print(json.dumps({"bench_server": res, "launches": launches, "card": card}), flush=True)
    return res, launches


# ------------------------------------------------------- last modules ----

BENCH_SERVER_ENGINE_LINES = ("engine_batch128_top100_qps", "engine_batch512_top100_qps",
                             "engine_mmr_pipelined64_top5_qps", "engine_mmr_pipelined512_top5_qps",
                             "engine_rerank_on_top5_qps")
TUI_TERMS = ("xterm-256color", "xterm", "vt100", "linux")


def run_tok(card: str, tmp: str) -> dict:
    """phase tok: `python -m rust_local_rag_tpu_torch.training.tok` on the
    committed tokenizer's corpus, twice at once: the piece set must be the
    committed tokenizer.json's, the two files byte-identical, and the file
    must load in the port's tokenizers with "yes" and "no" single pieces
    and both tokenizers giving the same ids."""
    corpus = os.path.join(ROOT, TRAIN_CORPUS)  # the committed tokenizer's corpus too
    if not os.path.exists(corpus):
        raise AssertionError(f"tok: {TRAIN_CORPUS} is missing")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    outs = [os.path.join(tmp, f"tokenizer_{i}.json") for i in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "rust_local_rag_tpu_torch.training.tok", "--corpus", corpus,
                               "--out", out], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for out in outs]
    texts = []
    for proc in procs:
        text, _ = proc.communicate(timeout=600)
        texts.append(text)
        if proc.returncode != 0:
            raise AssertionError(f"tok exited {proc.returncode}: {text[-2000:]}")
    train_s = time.perf_counter() - t0

    def pieces(path):
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        return set(d["model"]["vocab"]) | {t["content"] for t in d["added_tokens"]}, d

    got, spec = pieces(outs[0])
    want, _ = pieces(default_asset("tokenizer.json"))
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        identical = a.read() == b.read()
    py, native = WordPieceTokenizer(outs[0]), NativeWordPieceTokenizer(outs[0])
    single = {w: py.tokenize_full(w)[1:-1] for w in ("yes", "no")}
    with open(corpus, encoding="utf-8") as f:
        lines = [ln.strip() for _, ln in zip(range(2000), f)]
    same_ids = all(py.tokenize_full(t) == native.tokenize_full(t) for t in lines)
    out = {"tok": "python -m rust_local_rag_tpu_torch.training.tok", "corpus": TRAIN_CORPUS,
           "paragraphs": int(texts[0].split(" on ")[1].split()[0]), "train_s_two_at_once": train_s,
           "pieces": len(got), "committed_pieces": len(want), "symmetric_difference": len(got ^ want),
           "added_tokens": [t for t in spec["added_tokens"] if not t["special"]], "byte_identical": identical,
           "file_bytes": os.path.getsize(outs[0]), "yes_no_ids": single, "native_equals_python_on": len(lines),
           "card": card}
    log(out)
    if got != want or not identical or not all(len(v) == 1 for v in single.values()) or not same_ids:
        raise AssertionError(f"tok: {out}")
    return out


class RecordingScreen:
    """curses' stdscr surface as tui.ui.draw uses it, every call recorded."""

    def __init__(self, h: int = 30, w: int = 100):
        self.h, self.w, self.calls = h, w, []

    def getmaxyx(self):
        return self.h, self.w

    def __getattr__(self, name):
        return lambda *a: self.calls.append((name, *a))


def pump(ctl, state, done, timeout: float = 120.0) -> float:
    """Tick the TUI's Controller and apply its messages, as tui.main.run's
    loop does, until done() holds; -> seconds."""
    t0 = time.perf_counter()
    while not done():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"tui: the controller did not finish in {timeout} s ({state.status_line!r})")
        ctl.tick()
        while not ctl.msgs.empty():
            state.update(ctl.msgs.get_nowait())
        time.sleep(0.02)
    return time.perf_counter() - t0


def has_terminfo(term: str) -> bool:
    return subprocess.run([sys.executable, "-c", "import curses, sys; curses.setupterm(sys.argv[1], 1)", term],
                          capture_output=True, timeout=60).returncode == 0


def read_until(fd: int, needle: bytes, timeout: float) -> bytes:
    out = b""
    deadline = time.monotonic() + timeout
    while needle not in out and time.monotonic() < deadline:
        if select.select([fd], [], [], 0.2)[0]:
            try:
                out += os.read(fd, 65536)
            except OSError:
                break
    return out


def tui_terminal(url: str, tmp: str, query: str, doc: str) -> dict:
    """`python -m rust_local_rag_tpu_torch.tui` in a pseudo-terminal: the
    header draws, the typed query's first result shows, Esc quits with 0."""
    term = next((t for t in TUI_TERMS if has_terminfo(t)), None)
    if term is None:
        raise AssertionError(f"tui: no terminfo entry for any of {TUI_TERMS}")
    master, slave = pty.openpty()
    env = dict(os.environ, TERM=term, LINES="30", COLUMNS="100", RAG_TUI_SERVER_URL=url,
               RAG_TUI_ENV_PATH=os.path.join(tmp, "tui_terminal.env"),
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "rust_local_rag_tpu_torch.tui"], stdin=slave, stdout=slave,
                            stderr=slave, env=env, cwd=tmp, close_fds=True)
    os.close(slave)
    screen, code = b"", None
    try:
        screen += read_until(master, b"rag-tui", 60)
        drawn_s = time.perf_counter() - t0
        os.write(master, query.encode())
        screen += read_until(master, doc.encode(), 120)
        found_s = time.perf_counter() - t0
        os.write(master, b"\x1b")
        code = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        os.close(master)
    out = {"term": term, "drawn_s": drawn_s, "result_shown_s": found_s, "exit_code": code,
           "screen_bytes": len(screen)}
    if b"rag-tui" not in screen or doc.encode() not in screen or code != 0:
        raise AssertionError(f"tui terminal: {out}; screen tail {screen[-800:]!r}")
    return out


def tui_frames(tui_app, tui_ui, tui_theme, state, settings) -> list:
    """One frame of every mode on a recording screen: -> [(mode, calls)]."""
    Msg = tui_app.Msg
    frames = []

    def draw(mode):
        scr = RecordingScreen()
        tui_ui.draw(scr, state, settings, tui_theme.get_theme(state.theme_name))
        frames.append((mode, scr.calls))

    draw("normal")
    state.update(Msg("enter_detail"))
    draw("detail")
    state.update(Msg("back"))
    state.update(Msg("help"))
    draw("help")
    state.update(Msg("settings"))
    draw("settings")
    state.settings_editing, state.settings_edit_buffer, state.settings_cursor = True, "0.5", 1
    draw("settings_editing")
    state.settings_editing = False
    state.update(Msg("back"))
    return frames


def tui_check(port: int, card: str, tmp: str, query: str, n_chunks: int) -> dict:
    """phase tui: the port's terminal client against the entry point's
    server (`python -m rust_local_rag_tpu_torch` on the card). Headless,
    the Controller types `query` and its debounced search must equal
    /search's answer to the same body; stats and health answer; a reindex
    started from the Controller is pushed over watch_jobs to `completed`;
    ui.draw renders one frame of each mode onto a recording screen; then
    `python -m rust_local_rag_tpu_torch.tui` in a pseudo-terminal. The
    TUI runs no model: no kernel launch in this process."""
    from rust_local_rag_tpu_torch.tui import api as tui_api
    from rust_local_rag_tpu_torch.tui import app as tui_app
    from rust_local_rag_tpu_torch.tui import main as tui_main
    from rust_local_rag_tpu_torch.tui import settings as tui_settings
    from rust_local_rag_tpu_torch.tui import theme as tui_theme
    from rust_local_rag_tpu_torch.tui import ui as tui_ui

    counters = (fused_attention, score_segmax, fused_score_segmax)
    before = [c.launches for c in counters]
    url = f"http://127.0.0.1:{port}"
    client = tui_api.ApiClient(url)
    stats = client.stats()
    if not client.health() or stats.chunks != n_chunks:
        raise AssertionError(f"tui: health {client.health()}, stats {stats} (want {n_chunks} chunks)")
    events, stop = [], threading.Event()
    threading.Thread(target=client.watch_jobs, args=(events.append, stop.is_set), daemon=True).start()
    state = tui_app.AppState()
    settings = tui_settings.Settings.load(os.path.join(tmp, "tui.env"))
    ctl = tui_main.Controller(tui_api.ApiClient(url), state, settings)
    try:
        for ch in query:
            state.update(tui_app.Msg("char", ch))
            ctl.schedule_search()
        search_s = pump(ctl, state, lambda: bool(state.results) and not state.searching and state.stats is not None)
        status, _, body = Http(port).call("POST", "/search", {"query": query, "top_k": 10, "diversity_factor": 0.3})
        want = [tui_api.TuiSearchResult.from_json(r) for r in body["results"]]
        if status != 200 or [r.chunk_id for r in state.results] != [r.chunk_id for r in want]:
            raise AssertionError(f"tui: the search differs from /search ({status})")
        worst = max(abs(a.score - b.score) for a, b in zip(state.results, want))
        if worst > SERVER_TOL:
            raise AssertionError(f"tui: scores differ from /search's by {worst}")
        frames = tui_frames(tui_app, tui_ui, tui_theme, state, settings)
        # a new session may first be told of the last job: wait for another
        old = state.job.job_id if state.job is not None else None
        ctl.start_reindex()
        reindex_s = pump(ctl, state, lambda: state.job is not None and state.job.job_id != old
                         and state.job.status == "completed")
        job_id = state.job.job_id
        t0 = time.perf_counter()
        while not any(e.job_id == job_id and e.status == "completed" for e in events):
            if time.perf_counter() - t0 > 60:
                raise AssertionError(f"tui: no completion of {job_id} pushed over watch_jobs ({events})")
            time.sleep(0.05)
    finally:
        stop.set()
        ctl.stop()
    terminal = tui_terminal(url, tmp, query, want[0].document)
    launches = [c.launches - b for c, b in zip(counters, before)]
    texts = {mode: " ".join(str(c[3]) for c in calls if c[0] == "addnstr") for mode, calls in frames}
    out = {"tui": "Controller + ApiClient against the entry point", "results": len(state.results),
           "search_s": search_s, "max_score_diff": worst, "stats": vars(stats), "reindex_s": reindex_s,
           "pushed": [[e.status, e.progress, e.total] for e in events if e.job_id == job_id],
           "status_line": state.status_line, "frames": {m: len(c) for m, c in frames}, "terminal": terminal,
           "launches_in_process": dict(zip(("fused_attention", "score_segmax_masked", "fused_score_segmax"),
                                           launches)), "card": card}
    log(out)
    if any(launches) or state.status_line != "reindex completed" or not all(
            ("rag-tui" in t) for t in texts.values()) or want[0].document not in texts["normal"]:
        raise AssertionError(f"tui: {out}")
    return out


def eval_cli_check(base: str, gt: str, results: dict, tmp: str, card: str) -> dict:
    """phase eval_cli: `python -m rust_local_rag_tpu_torch.evaluation.run`
    list-configs, check and evaluate (bm25_only) against the quality
    phase's server: list-configs names every config, check exits 0 with
    the server ready and the ground truth's counts, and evaluate's report
    equals the quality phase's bm25_only report of the same server."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    cfg = os.path.join(tmp, "eval_cli.yaml")
    with open(cfg, "w") as f:
        f.write(f'name: "eval_cli"\nrag_endpoint: "{base}"\nground_truth_path: "{gt}"\n')
    out_dir = os.path.join(tmp, "eval_cli_reports")

    def cli(*argv):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "rust_local_rag_tpu_torch.evaluation.run", *argv], cwd=ROOT,
                           env=env, capture_output=True, text=True, timeout=600)
        return p.returncode, p.stdout, time.perf_counter() - t0

    listed = cli("list-configs")
    checked = cli("check", "--config", cfg)
    evaluated = cli("evaluate", "--config", os.path.join(ROOT, "eval_harness", "configs", "bm25_only.yaml"),
                    "--endpoint", base, "--ground-truth", gt, "--out", out_dir)
    reports = [p for p in os.listdir(out_dir) if p.endswith(".json")] if os.path.isdir(out_dir) else []
    summary = {}
    if len(reports) == 1:
        with open(os.path.join(out_dir, reports[0])) as f:
            summary = json.load(f)["summary"]
    want = results["bm25_only"]["summary"]
    same = all(summary.get(k) == want[k] for k in ("n_queries", "hit_rate_mean", "mrr_mean", "passed"))
    out = {"eval_cli": "python -m rust_local_rag_tpu_torch.evaluation.run",
           "list_configs": [listed[0], len(listed[1].splitlines()), listed[2]],
           "check": [checked[0], checked[1].splitlines()[:1] + checked[1].splitlines()[-1:], checked[2]],
           "evaluate_bm25_only": [evaluated[0], {k: summary.get(k) for k in ("n_queries", "hit_rate_mean",
                                                                            "mrr_mean", "passed")}, evaluated[2]],
           "equals_quality_phase": same, "card": card}
    log(out)
    n_cfg = len([p for p in os.listdir(os.path.join(ROOT, "eval_harness", "configs")) if p.endswith(".yaml")])
    if (listed[0] != 0 or len(listed[1].splitlines()) != n_cfg or checked[0] != 0
            or not checked[1].startswith("server ready: True") or "ground truth: 168 queries" not in checked[1]
            or evaluated[0] != (0 if want["passed"] else 1) or not same):
        raise AssertionError(f"eval_cli: {out}")
    return out


# ----------------------------------------------------------------- main ----


# ------------------------------------------------------- experiments ----


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max())


def experiments_check(seed: int, dev, card: str) -> dict:
    """K1-K4 (csrc/segmax.cu, csrc/stream_probe.cu) against their plain
    versions at the experiments' shape, N 1,245,184, D 768, Q 128 bf16, and
    the split pipeline and split2.stream_fused against torch.topk over the
    same scores. -> {kernel: max_abs_err}."""
    n, d, q = N_BENCH, exp_common.D, exp_common.Q
    corpus = exp_common.normal_bf16((n, d), seed + 20, dev)
    qs = exp_common.normal_bf16((q, d), seed + 21, dev)
    st = exp_common.gemm_scores(qs, corpus)
    errs = {"segmax": 0.0, "stream_segmax": 0.0, "read_probe": 0.0, "resident_dot_segmax": 0.0}
    # K1: max is exact in any order
    for seg, blkc, slots in ((128, 32768, 2), (64, 16384, 4), (128, 65536, 1)):
        got, want = segmax(st, seg, blkc, slots), segmax_plain(st, seg)
        if not torch.equal(got, want):
            raise AssertionError(f"segmax seg={seg} blkc={blkc}: differs from the plain amax")
        log({"kernel_check": "segmax", "seg": seg, "blkc": blkc, "slots": slots, "Q": q, "N": n, "exact": True,
             "card": card})
    # K2: scores within EXP_REL_TOL of the plain f32 product; the segment
    # maxima exactly the max of the kernel's own scores
    p_scores, p_sm = stream_segmax_plain(qs, corpus, 128, "qn")
    p_sm64 = p_scores.view(q, n // 64, 64).amax(dim=2).T
    ref = {}
    for layout, natural, seg, slots in (("qn", False, 128, 2), ("nq", True, 128, 2), ("nq", True, 64, 2),
                                        ("qn", True, 64, 4), ("none", False, 128, 2), ("none", False, 128, 4),
                                        ("none", True, 128, 2)):
        s, m = stream_segmax(qs, corpus, seg, layout, natural, slots)
        want_sm = p_sm if seg == 128 else p_sm64
        row = {"kernel_check": "stream_segmax", "layout": layout, "natural": natural, "seg": seg, "slots": slots,
               "Q": q, "N": n, "D": d, "segmax_rel_err": rel_err(m, want_sm), "tol": EXP_REL_TOL, "card": card}
        if s is not None:
            s_qn = s if layout == "qn" else s.T.contiguous()
            row["scores_rel_err"] = rel_err(s_qn, p_scores)
            row["max_abs_err"] = float((s_qn - p_scores).abs().max())
            errs["stream_segmax"] = max(errs["stream_segmax"], row["max_abs_err"])
            if not torch.equal(m, s_qn.view(q, n // seg, seg).amax(dim=2).T):
                raise AssertionError(f"stream_segmax {layout}: maxima are not those of its own scores")
            ref[(natural, seg)] = m
            del s_qn
        elif (natural, seg) in ref and not torch.equal(m, ref[(natural, seg)]):
            raise AssertionError(f"stream_segmax none natural={natural}: maxima differ from the scored run's")
        log(row)
        if max(row["segmax_rel_err"], row.get("scores_rel_err", 0.0)) > EXP_REL_TOL:
            raise AssertionError(f"stream_segmax {row}: beyond tolerance")
        del s, m
    del p_scores, p_sm64, ref
    # K4: block 0's maxima for every chunk, identical down the output
    small = [(exp_common.normal_bf16((nq, dd), seed + 23, dev), blk, natural, 2,
              exp_common.normal_bf16((nn, dd), seed + 22, dev)) for nq, nn, dd, blk, natural in RESIDENT_SMALL]
    for qq, blk, natural, slots, c in [(qs[:nq], blk, nat, sl, corpus) for nq, blk, nat, sl in RESIDENT_CASES] + small:
        (nq, dd), qq = qq.shape, qq.contiguous()
        got = resident_dot_segmax(qq, c, blk, natural, slots)
        want = resident_dot_plain(qq, c, blk)
        per, nn = blk // 128, c.shape[0]
        same = torch.equal(got, got[:per].repeat(nn // blk, 1))
        err = rel_err(got, want)
        errs["resident_dot_segmax"] = max(errs["resident_dot_segmax"], float((got - want).abs().max()))
        log({"kernel_check": "resident_dot_segmax", "Q": nq, "N": nn, "D": dd, "blk": blk, "natural": natural,
             "slots": slots, "rel_err": err, "chunks_identical": same, "tol": EXP_REL_TOL, "card": card})
        if not same or err > EXP_REL_TOL:
            raise AssertionError(f"resident_dot_segmax Q={nq} N={nn} D={dd} blk={blk} natural={natural} "
                                 f"slots={slots}: {err}, identical {same}")
    del small
    # K3: a copy and integer sums, exact
    for blk, slots, static in ((2048, 2, False), (8192, 2, True), (2048, 16, True), (16384, 4, True)):
        heads, sums = read_probe(corpus, blk, 128, slots, static)
        wh, ws = read_probe_plain(corpus, blk, 128)
        if not (torch.equal(heads, wh) and torch.equal(sums, ws)):
            raise AssertionError(f"read_probe blk={blk} slots={slots} static={static}: differs from the plain read")
        log({"kernel_check": "read_probe", "blk": blk, "slots": slots, "static": static, "exact": True, "card": card})
    # split2.stream_fused (the unmasked kernel's tensor-core body, bf16
    # queries as they are): scores within EXP_REL_TOL of the GEMM's, its
    # selection the exact top-100 of its own scores
    fs, fsm = split2.stream_fused(qs, corpus)
    err = rel_err(fs, st)
    fv, fi = torch.topk(fs, exp_common.K, dim=1)
    okv, oki, ties = exp_common.same_topk(*split2.select(fs, fsm.T), fv, fi)
    log({"kernel_check": "split2.stream_fused", "body": "tensor cores, one bf16 term", "scores_rel_err": err,
         "tol": EXP_REL_TOL, "values_exact": okv, "indices_exact": oki, "boundary_ties": ties, "card": card})
    if not (okv and oki) or not err <= EXP_REL_TOL:
        raise AssertionError(f"split2.stream_fused: rel err {err}, exact {okv} {oki}")
    del fs, fsm, fv, fi
    # the split pipeline: exact top-100 of the same scores
    wv, wi = torch.topk(st, exp_common.K, dim=1)
    gv, gi = split_pipeline.pipeline_qn(128, 32768, 128)(qs, corpus)
    okv, oki, ties = exp_common.same_topk(gv, gi, wv, wi)
    log({"kernel_check": "split_pipeline", "values_exact": okv, "indices_exact": oki, "boundary_ties": ties,
         "card": card})
    if not (okv and oki):
        raise AssertionError("split pipeline: not the exact top-100 of its scores")
    del corpus, qs, st, wv, wi, gv, gi
    torch.cuda.empty_cache()
    return errs


EXP_COUNTERS = {"segmax": segmax, "stream_segmax": stream_segmax, "read_probe": read_probe,
                "resident_dot_segmax": resident_dot_segmax, "fused_score_segmax": fused_score_segmax}


def run_experiments(dev) -> dict:
    """Every sweep of every experiment module's main, with the launch counts
    set to 0 just before and read just after (and each module's share
    printed). -> {kernel: launches}."""
    for fn in EXP_COUNTERS.values():
        fn.launches = 0
    for mod in EXPERIMENTS:
        log(f"-- python -m {mod.__name__}")
        before = {name: fn.launches for name, fn in EXP_COUNTERS.items()}
        mod.main(device=dev)
        log({"launches": {name: fn.launches - before[name] for name, fn in EXP_COUNTERS.items()},
             "module": mod.__name__})
    launches = {name: fn.launches for name, fn in EXP_COUNTERS.items()}
    log({"launches": launches, "path": "experiments"})
    if min(launches.values()) <= 0:
        raise AssertionError(f"the experiments launched a kernel no time: {launches}")
    return launches


def exp_bound(nbytes: float, ops: float = 0.0):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def resident_library(qs, corpus, blk: int, n: int):
    """K4's function through cuBLAS: every chunk's product of the queries
    and block 0 as one bmm of the stride-0 expansions to f32 scores
    [N/blk, Q, blk], then each segment's amax, put into [N/128, Q]."""
    q, d = qs.shape
    nch, blk0 = n // blk, corpus[:blk]
    s = torch.bmm(qs.expand(nch, q, d), blk0.mT.expand(nch, d, blk), out_dtype=torch.float32)
    return s.view(nch, q, blk // 128, 128).amax(-1).transpose(1, 2).reshape(n // 128, q)


def resident_times(qs, corpus, row, rows: dict, card: str) -> None:
    """K4 at the experiments' blk 2,048 and 4,096 (natural off and on): its
    bound by the operations of the products it issues (all N Q D of them)
    beside the old reckoning (block 0 read once, the output written, one
    block's product), the library line (whose f32 scores are checked not to
    be a copy of the expansions), the share of the bf16 peak and the bytes
    L2 fed it a second; then the work check: the same call at N/2."""
    q, d = qs.shape
    n = corpus.shape[0]
    sms = torch.cuda.get_device_properties(qs.device).multi_processor_count

    def nbytes(blk):  # block 0 and the queries read once, the maxima written once
        return blk * d * 2 + q * d * 2 + (n // 128) * q * 4

    torch.cuda.reset_peak_memory_stats(qs.device)
    base = torch.cuda.memory_allocated(qs.device)
    lib = resident_library(qs, corpus, 4096, n)
    extra = torch.cuda.max_memory_allocated(qs.device) - base
    want = resident_dot_plain(qs, corpus, 4096)
    log({"library_check": "resident_dot_segmax", "call": "bmm of the stride-0 expansions + amax", "blk": 4096,
         "rel_err": rel_err(lib, want), "peak_extra_bytes": extra, "scores_bytes": q * n * 4,
         "expansions_if_copied_bytes": (n // 4096) * (q + 4096) * d * 2, "card": card})
    if rel_err(lib, want) > EXP_REL_TOL:
        raise AssertionError("resident_dot_segmax's library line disagrees with the plain version")
    del lib, want
    for blk, natural in ((4096, False), (2048, False), (4096, True), (2048, True)):
        name = "resident_dot_segmax" if (blk, natural) == (4096, False) else f"resident_dot_segmax blk {blk}" + (
            " natural" if natural else "")
        row(name, f"blk {blk}, natural {natural}, slots 2",
            lambda: resident_dot_segmax(qs, corpus, blk, natural), lambda: resident_dot_plain(qs, corpus, blk),
            lambda: resident_library(qs, corpus, blk, n), exp_bound(nbytes(blk), 2 * q * n * d))
        r = rows[name]
        r["output_bound_ms"] = exp_bound(nbytes(blk), 2 * q * blk * d)[0]
        r["bf16_peak_share"] = 2 * q * n * d / H100_BF16_FLOPS * 1e3 / r["ms"]
        r["l2_feed_bytes"] = resident_dot_feed_bytes(q, n, d, blk, sms)
        r["l2_feed_TBps"] = r["l2_feed_bytes"] / r["ms"] * 1e-9
        log({"kernel_time_extra": name, **{k: r[k] for k in ("output_bound_ms", "bf16_peak_share", "l2_feed_bytes",
                                                             "l2_feed_TBps")}, "card": card})
    for nq in RESIDENT_SMALL_Q:  # a block's 64-query half, whatever part of it Q fills
        qq = qs[:nq].contiguous()
        name = f"resident_dot_segmax Q {nq}"
        row(name, f"Q {nq}, blk 2048, natural False, slots 2", lambda: resident_dot_segmax(qq, corpus, 2048),
            lambda: resident_dot_plain(qq, corpus, 2048), lambda: resident_library(qq, corpus, 2048, n),
            exp_bound(2048 * d * 2 + nq * d * 2 + (n // 128) * nq * 4, 2 * nq * n * d), nq)
        r = rows[name]
        r["bf16_peak_share"] = 2 * nq * n * d / H100_BF16_FLOPS * 1e3 / r["ms"]
        log({"kernel_time_extra": name, "bf16_peak_share": r["bf16_peak_share"], "card": card})
    full = rows["resident_dot_segmax"]["ms"]
    half = cuda_ms(lambda: resident_dot_segmax(qs, corpus[:n // 2], 4096), reps=5, calls=5)
    log({"work_check": "resident_dot_segmax", "blk": 4096, "Q": q, "N": n, "ms": full, "N_half": n // 2,
         "half_ms": half, "ratio": full / half, "limit": RESIDENT_WORK_RATIO, "card": card})
    if full / half < RESIDENT_WORK_RATIO:
        raise AssertionError(f"resident_dot_segmax: {full} ms at N {n} against {half} at N {n // 2}: "
                             f"a ratio under {RESIDENT_WORK_RATIO}")


def experiments_times(seed: int, dev, card: str) -> dict:
    """Each new kernel at the experiments' main setting beside its plain
    version, a library call where one computes the same function, and its
    bound; and the fused row (split2.stream_fused: the unmasked kernel's
    tensor-core body at Q 128, bf16 queries on the bf16 slab). -> {name: row}."""
    n, d, q = N_BENCH, exp_common.D, exp_common.Q
    corpus = exp_common.normal_bf16((n, d), seed + 20, dev)
    qs = exp_common.normal_bf16((q, d), seed + 21, dev)
    st = exp_common.gemm_scores(qs, corpus)
    slab = n * d * 2
    rows = {}

    def row(name, setting, kernel, plain, library, bound, nq=q):
        b_ms, b_by = bound
        r = {"kernel_time": name, "setting": setting, "Q": nq, "N": n, "D": d, "ms": cuda_ms(kernel, reps=5, calls=5),
             "plain_ms": cuda_ms(plain, reps=3, calls=2),
             "library_ms": None if library is None else cuda_ms(library, reps=5, calls=5),
             "bound_ms": b_ms, "bound_by": b_by, "card": card}
        log(r)
        rows[name] = r

    row("segmax", "seg 128, blkc 32768, slots 2", lambda: segmax(st, 128, 32768, 2), lambda: segmax_plain(st, 128),
        lambda: st.view(q, n // 128, 128).amax(dim=2), exp_bound(q * n * 4 + q * (n // 128) * 4))
    del st
    torch.cuda.empty_cache()
    row("stream_segmax", "[Q, N] scores, seg 128, slots 2", lambda: stream_segmax(qs, corpus, 128, "qn"),
        lambda: stream_segmax_plain(qs, corpus, 128, "qn"),
        lambda: exp_common.gemm_scores(qs, corpus).view(q, n // 128, 128).amax(dim=2),
        exp_bound(slab + q * d * 2 + q * n * 4 + (n // 128) * q * 4, 2 * q * n * d))
    # the same function as stream_segmax, with no scores written: its
    # library call is stream_segmax's (the GEMM writes its scores anyway)
    row("stream_segmax_none", "no scores (isolate both), seg 128, slots 2",
        lambda: stream_segmax(qs, corpus, 128, "none"), lambda: stream_segmax_plain(qs, corpus, 128, "none"),
        lambda: exp_common.gemm_scores(qs, corpus).view(q, n // 128, 128).amax(dim=2),
        exp_bound(slab + q * d * 2 + (n // 128) * q * 4, 2 * q * n * d))
    row("read_probe", "blk 8192, slots 2, static", lambda: read_probe(corpus, 8192, 128, 2, True),
        lambda: read_probe_plain(corpus, 8192, 128), None, exp_bound(slab + (n // 8192) * (128 * 4 + 8)))
    resident_times(qs, corpus, row, rows, card)
    row("stream_fused", "split2.stream_fused: the unmasked kernel's tensor-core body, bf16 queries and slab",
        lambda: split2.stream_fused(qs, corpus), lambda: fused_score_segmax_plain(qs, corpus),
        lambda: exp_common.gemm_scores(qs, corpus).view(q, n // 128, 128).amax(dim=2),
        exp_bound(slab + q * d * 2 + q * n * 4 + q * (n // 128) * 4, 2 * q * n * d))
    log({"slab_read": "bfloat16", "N": n, "D": d, "sum_ms": cuda_ms(lambda: corpus.view(-1).sum(), reps=5, calls=5),
         "bytes": slab, "card": card})
    del corpus, qs
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- sharded ----

SHARD_N = 80 * 16384  # 1,310,720 rows: 4 shards of 327,680 and 8 of 163,840 both take the kernel's branch
SHARD_Q = (1, 16, 64)
SHARD_TOP_K = (10, 30)
SHARD_FREED = 0.01
# name: (mesh sizes, axis names, corpus_axis, data_axis), every position the one card
SHARD_MESHES = {
    "corpus4": ((4,), ("corpus",), "corpus", None),
    "slice2x4": ((2, 4), ("slice", "corpus"), ("slice", "corpus"), None),
    "data2x4": ((2, 4), ("data", "corpus"), "corpus", "data"),
}
# the sharded engines' slab: 4 shards of 65,536 rows take the kernel's
# branch, 8 shards of 32,768 (the sliced engine) the matmul's
SHARD_CAPACITY = 4 * 65536
SHARD_BURSTS = (16, 64)
# engine: (environment, stand-in devices, kernel launches a first-stage call)
SHARD_ENGINES = {
    "corpus4": ({"RAG_TPU_SHARD_CORPUS": "4"}, 4, 4),
    "data2x4": ({"RAG_TPU_SHARD_CORPUS": "4", "RAG_TPU_DATA_PARALLEL": "2"}, 8, 8),
    "slice2x4": ({"RAG_TPU_SHARD_CORPUS": "8", "RAG_TPU_SLICES": "2"}, 8, 0),
    "int8_corpus4": ({"RAG_TPU_SHARD_CORPUS": "4", "RAG_TPU_INT8_CORPUS": "1"}, 4, 0),
}
SHARD_LANES = {"off": (0.0, False), "on": (0.0, True), "mmr": (DIVERSITY, False)}


def topk_rows(vals, idx, emb=None, lex=None, nq=None) -> list:
    """[Q, k] planes -> per query [(slot, value, emb, lex)] of the valid rows."""
    planes = [x.cpu().numpy() for x in (vals, idx)]
    extra = [x.cpu().numpy() for x in (emb, lex) if x is not None]
    out = []
    for qi in range(nq if nq is not None else planes[0].shape[0]):
        out.append([(int(planes[1][qi, j]), float(planes[0][qi, j]), *(float(e[qi, j]) for e in extra))
                    for j in range(planes[0].shape[1])
                    if planes[1][qi, j] >= 0 and np.isfinite(planes[0][qi, j])])
    return out


def same_rows(got: list, want: list, what: str) -> int:
    for qi, (a, b) in enumerate(zip(got, want)):
        same_topk(a, b, SCORE_TOL, f"{what} query {qi}")
    return len(got)


def sharded_functions(seed: int, dev, card: str) -> dict:
    """The sharded functions on meshes that stand 4 or 8 shards on the
    card, each call held against the unsharded function on the same card
    and inputs; the masked kernel's launches counted around each sharded
    call (one a shard a data block on f32 and bf16 slabs, none on int8)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    corpus = torch.empty((SHARD_N, DIM), device=dev)
    for r0 in range(0, SHARD_N, INT8_BLOCK):
        corpus[r0:r0 + INT8_BLOCK] = unit_rows(gen, min(INT8_BLOCK, SHARD_N - r0), DIM, dev)
    src = torch.randint(0, SHARD_N, (max(SHARD_Q),), generator=gen, device=dev)
    mask = torch.rand(SHARD_N, generator=gen, device=dev) >= SHARD_FREED
    mask[(src + 1) % SHARD_N] = False  # freed slots next to the top hits
    mask[src] = True
    live = torch.nonzero(mask)[:, 0]
    qs_all = corpus[src] + 0.05 * unit_rows(gen, len(src), DIM, dev)
    qs_all = (qs_all / torch.linalg.vector_norm(qs_all, dim=1, keepdim=True)).contiguous()
    ls_all, lv_all = lexical_hits(live, len(src), gen)
    ls_all[:, 0] = src.to(torch.int32)  # a hit on each query's own row: the dense side's duplicate
    slabs = {"f32": corpus, "bf16": corpus.to(torch.bfloat16)}
    int8 = quantize_corpus(corpus)
    l1 = int8.scales[:, 0] * int8.values.abs().sum(dim=1, dtype=torch.int32).float()
    w_e, w_l = (torch.tensor(w, device=dev) for w in (0.7, 0.3))
    meshes = {name: (build_mesh(sizes, names, devices=[dev] * int(np.prod(sizes))), caxis, daxis)
              for name, (sizes, names, caxis, daxis) in SHARD_MESHES.items()}
    out = {"launches": 0, "calls": 0, "checked_queries": 0, "max_sims_diff": 0.0, "int8_certified": [0, 0]}

    def inputs(q: int, dp: int):
        """Q queries padded to a multiple of the data blocks with zero
        rows and no hits, as the engine pads them."""
        qp = -(-q // dp) * dp
        qs = torch.zeros((qp, DIM), device=dev)
        qs[:q] = qs_all[:q]
        ls = torch.full((qp, ls_all.shape[1]), -1, dtype=torch.int32, device=dev)
        lv = torch.zeros((qp, ls_all.shape[1]), device=dev)
        ls[:q], lv[:q] = ls_all[:q], lv_all[:q]
        return qs, ls, lv

    def counted(fn, want: int, what: str):
        score_segmax.launches = 0
        res = fn()
        torch.cuda.synchronize()
        n = score_segmax.launches
        if n != want:
            raise AssertionError(f"{what}: {n} masked-kernel launches, want {want}")
        out["launches"] += n
        out["calls"] += 1
        return res

    for dtype, slab in slabs.items():
        for q in SHARD_Q:
            for k in SHARD_TOP_K:
                qs, ls, lv = inputs(q, 2)
                ref = hybrid_topk(qs, slab, mask, ls, lv, w_e, w_l, k, with_sims=True)
                want = topk_rows(ref[0], ref[3], ref[1], ref[2], nq=q)
                for name, (mesh, caxis, daxis) in meshes.items():
                    dp = mesh.shape[daxis] if daxis else 1
                    placed = shard_corpus(slab, mesh, caxis), shard_corpus(mask, mesh, caxis)
                    qd, lsd, lvd = inputs(q, dp)
                    for sims in (False, True):
                        what = f"sharded_hybrid_topk {name} {dtype} Q{q} k{k}{' sims' if sims else ''}"
                        # every position runs its shard of its data block
                        res = counted(lambda: sharded_hybrid_topk(qd, *placed, lsd, lvd, w_e, w_l, k, mesh,
                                                                  corpus_axis=caxis, with_sims=sims,
                                                                  data_axis=daxis), mesh.size, what)
                        out["checked_queries"] += same_rows(topk_rows(res[0], res[3], res[1], res[2], nq=q), want,
                                                            what)
                        if sims:
                            rows = (res[3][:q] == ref[3][:q]).all(dim=1)
                            if rows.any():
                                d = float((res[4][:q][rows] - ref[4][:q][rows]).abs().max())
                                out["max_sims_diff"] = max(out["max_sims_diff"], d)
                                if d > SCORE_TOL:
                                    raise AssertionError(f"{what}: similarities differ by {d}")
    del slabs["bf16"]
    # the exact top-k (sharded_topk, multislice_topk): the padded tail masked
    n_valid = SHARD_N - 1000
    ms_mesh = build_mesh((2, 4), ("slice", "ici"), devices=[dev] * 8)
    mesh4 = meshes["corpus4"][0]
    for q in SHARD_Q:
        scores = torch.matmul(qs_all[:q], corpus.T)
        scores[:, n_valid:] = float("-inf")
        for k in SHARD_TOP_K:
            rv, ri = torch.topk(scores, k, dim=1)
            want = topk_rows(rv, ri)
            for what, fn, shards in (
                    ("sharded_topk", lambda: sharded_topk(qs_all[:q], shard_corpus(corpus, mesh4), k, mesh4,
                                                          valid_count=n_valid), 4),
                    ("multislice_topk", lambda: multislice_topk(qs_all[:q], corpus, k, ms_mesh,
                                                                valid_count=n_valid), 8)):
                v, i = counted(fn, shards, f"{what} Q{q} k{k}")
                out["checked_queries"] += same_rows(topk_rows(v, i), want, f"{what} Q{q} k{k}")
        del scores
    # int8: certified rows and the escalation lane against the unsharded
    # escalation lane (exact over the dequantised rows)
    for q in SHARD_Q:
        for k in SHARD_TOP_K:
            qs, ls, lv = inputs(q, 2)
            ref = hybrid_topk_dequant_full(qs, int8.values, int8.scales, mask, ls, lv, w_e, w_l, k)
            want = topk_rows(ref[0], ref[3], ref[1], ref[2], nq=q)
            for name, (mesh, caxis, daxis) in meshes.items():
                dp = mesh.shape[daxis] if daxis else 1
                qd, lsd, lvd = inputs(q, dp)
                args = (shard_corpus(int8.values, mesh, caxis), shard_corpus(int8.scales, mesh, caxis))
                placed_mask = shard_corpus(mask, mesh, caxis)
                what = f"sharded int8 {name} Q{q} k{k}"
                res = counted(lambda: sharded_hybrid_topk_quantized(
                    qd, *args, shard_corpus(l1, mesh, caxis), placed_mask, lsd, lvd, w_e, w_l, k, mesh,
                    corpus_axis=caxis, data_axis=daxis), 0, what)
                full = counted(lambda: sharded_hybrid_topk_dequant_full(
                    qd, *args, placed_mask, lsd, lvd, w_e, w_l, k, mesh, corpus_axis=caxis, data_axis=daxis),
                    0, what + " dequant_full")
                out["checked_queries"] += same_rows(topk_rows(full[0], full[3], full[1], full[2], nq=q), want,
                                                    what + " dequant_full")
                cert = res[4][:q].cpu().numpy()
                got = topk_rows(res[0], res[3], res[1], res[2], nq=q)
                same_rows([g for g, c in zip(got, cert) if c], [w for w, c in zip(want, cert) if c], what)
                out["int8_certified"][0] += int(cert.sum())
                out["int8_certified"][1] += q
    # times: the sharded first stage (4 shards on the card) against the
    # unsharded one, f32, and the merge alone on candidate planes of the
    # call's shapes
    times = []
    mesh, caxis, _ = meshes["corpus4"]
    placed = shard_corpus(corpus, mesh, caxis), shard_corpus(mask, mesh, caxis)
    lay = sharded_search._Layout(mesh, caxis, None, SHARD_N, "{n} {s}")
    kb = _bucket_k(TOP_K)  # the engine's k for top_k 10
    for q in (16, 64):
        qs, ls, lv = inputs(q, 1)
        sharded_call = lambda: sharded_hybrid_topk(qs, *placed, ls, lv, w_e, w_l, kb, mesh)  # noqa: E731
        plain_call = lambda: hybrid_topk(qs, corpus, mask, ls, lv, w_e, w_l, kb)  # noqa: E731
        planes = [(torch.rand((q, kb), device=dev), torch.rand((q, kb), device=dev), torch.rand((q, kb), device=dev),
                   torch.randint(0, SHARD_N, (q, kb), device=dev, dtype=torch.int32)) for _ in range(4)]
        merge_call = lambda: sharded_search._pad_k(*lay.merge(planes, kb), kb)  # noqa: E731
        _, peak_sharded = peak_above(sharded_call)
        _, peak_plain = peak_above(plain_call)
        row = {"Q": q, "k": kb, "N": SHARD_N, "shards": 4, "sharded_ms": cuda_ms(sharded_call),
               "unsharded_ms": cuda_ms(plain_call), "merge_ms": cuda_ms(merge_call),
               "peak_above_slab_bytes": peak_sharded, "unsharded_peak_above_slab_bytes": peak_plain}
        row["merge_share"] = row["merge_ms"] / row["sharded_ms"]
        times.append(row)
    log({"sharded_times": times, "stand_in": "4 shards on 1 card", "card": card})
    out["times"] = times
    return out


@contextmanager
def stand_in(dev, shards: int):
    """parallel/mesh.available_devices answers `shards` times the one card:
    the engine's one seam for standing several shards on it."""
    real = mesh_module.available_devices
    mesh_module.available_devices = lambda device: [torch.device(dev)] * shards
    try:
        yield
    finally:
        mesh_module.available_devices = real


def compare_rerank_pools(eng, other_eng, got, other, queries, near: list, worst: dict, what: str) -> None:
    """The object lane with the judge: each query's judged pool (the first
    stage's 3 x top_k rows) of both engines must agree as same_topk says;
    where the two pools hold the same rows, the answers must agree as
    compare_object says; where a first-stage tie at the pool's edge put
    another row in one pool, the rows both judged must get the same
    judge outputs (recorded in `near`)."""
    pools = [e.search_batch(queries, 3 * TOP_K, use_reranker=False) for e in (eng, other_eng)]
    for q, a, b, pa, pb in zip(queries, got, other, *pools):
        same_topk(rows_of(pa, eng.store), rows_of(pb, eng.store), SCORE_TOL, f"{what} {q!r} pool")
        if {r.chunk_id for r in pa} == {r.chunk_id for r in pb}:
            compare_object([a], [b], [q], False, near, worst, what)
            continue
        gb = {r.chunk_id: r for r in b}
        for r in a:
            if r.chunk_id in gb:
                x = gb[r.chunk_id]
                compare_judge((r.reranker_score, r.yes_logprob, r.no_logprob),
                              (x.reranker_score, x.yes_logprob, x.no_logprob), f"{what} {q!r} {r.chunk_id}", worst)
        near.append({"lane": "sharded_object", "check": what, "query": q, "kind": "pool_edge_tie",
                     "only_here": sorted({r.chunk_id for r in pa} - {r.chunk_id for r in pb}),
                     "only_there": sorted({r.chunk_id for r in pb} - {r.chunk_id for r in pa})})


def sharded_engines(engine, dev, card: str, tmp: str, rng, probs) -> dict:
    """Engines over the main engine's chunks (its lexical index shared,
    the slots being the same) with RAG_TPU_SHARD_CORPUS and friends: the
    warn path on the one card, then each configuration of SHARD_ENGINES
    with its shards standing on the card, driven through SearchBatcher in
    each lane and held against the unsharded engine on the card and a CPU
    copy of the same sharded engine (the CPU mesh; the card's encoder and
    judge). Every request must take the object lane."""
    emb, metas = engine.store.snapshot_host()
    if engine.store.high_water != len(engine.store):
        raise AssertionError("sharded: the main engine's slots have holes; its lexical index cannot be shared")

    def sub(name: str, env: dict, device, shards: int = 0, reranker=None):
        with ExitStack() as stack:
            for k, v in env.items():
                stack.enter_context(env_set(k, v))
            if shards:
                stack.enter_context(stand_in(dev, shards))
            eng = RagEngine(os.path.join(tmp, "sharded", name), engine.embedding_service, reranker, device=device)
        eng.store = ChunkStore(DIM, torch.float32, SHARD_CAPACITY, device=device, quantized=eng.store.quantized,
                               mesh=eng._mesh, corpus_axis=eng._corpus_axes)
        if eng.store.add_chunks(metas, emb) != list(range(len(metas))):
            raise AssertionError(f"sharded {name}: slots differ from the main engine's")
        eng.lexical_index = engine.lexical_index
        return eng

    def answer(eng, queries, lane: str):
        div, rr = SHARD_LANES[lane]
        return eng.search_with_diversity_batch(queries, TOP_K, div, use_reranker=rr)

    out = {"launches": 0}
    # warn path: no stand-in, so the one card cannot hold 4 shards
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    eng_log = logging.getLogger(RagEngine.__module__)
    eng_log.addHandler(handler)
    try:
        warned = sub("warn", {"RAG_TPU_SHARD_CORPUS": "4"}, dev)
    finally:
        eng_log.removeHandler(handler)
    msgs = [r.getMessage() for r in records]
    want_msg = f"RAG_TPU_SHARD_CORPUS=4 but only {torch.cuda.device_count()} devices; running unsharded"
    if torch.cuda.device_count() < 4 and (warned._mesh is not None or want_msg not in msgs):
        raise AssertionError(f"sharded warn path: mesh {warned._mesh}, log {msgs}")
    plain = sub("plain", {}, dev, reranker=engine.reranker)
    qs = queries_for(rng, 16, probs)
    same_rows([rows_of(r, plain.store) for r in answer(warned, qs, "off")],
              [rows_of(r, plain.store) for r in answer(plain, qs, "off")], "warn path vs unsharded")
    log({"sharded_warn_path": want_msg, "logged": want_msg in msgs, "mesh": None, "checked": len(qs), "card": card})
    del warned
    plain8 = sub("plain_int8", {"RAG_TPU_INT8_CORPUS": "1"}, dev, reranker=engine.reranker)
    rows_cpu = {False: plain.store.corpus().cpu(),
                True: plain8.store.corpus().cpu().float() * plain8.store.scales().cpu()}
    near, worst = [], {"rr": 0.0, "logprob": 0.0}
    for name, (env, shards, per_call) in SHARD_ENGINES.items():
        t0 = time.perf_counter()
        eng = sub(name, env, dev, shards, engine.reranker)
        cpu = sub(name + "_cpu", env, "cpu", reranker=engine.reranker)
        ref = plain8 if eng.store.quantized else plain
        calls = {"object": 0, "columnar": 0, "first_stage": 0}
        burst_first_stages = 0
        real_object, real_dispatch = eng.search_with_diversity_batch, eng._dispatch

        def object_lane(*a, **kw):
            calls["object"] += 1
            return real_object(*a, **kw)

        def first_stage(*a, **kw):
            calls["first_stage"] += 1
            return real_dispatch(*a, **kw)

        def columnar(*a, **kw):
            calls["columnar"] += 1
            raise AssertionError("a sharded engine took a columnar lane")

        eng.search_with_diversity_batch, eng._dispatch = object_lane, first_stage
        eng.dispatch_search = eng.dispatch_search_mmr = eng.judge_columnar = columnar
        batcher = SearchBatcher(eng, RwLock())
        checked = {"unsharded": 0, "cpu_copy": 0}
        launches = 0
        try:
            for lane, (div, use_rr) in SHARD_LANES.items():
                for b in SHARD_BURSTS:
                    qs = queries_for(rng, b, probs)
                    before = calls["first_stage"]
                    score_segmax.launches = 0
                    futs = [batcher.submit(q, TOP_K, div, None, use_reranker=use_rr) for q in qs]
                    got = [f.result(timeout=300) for f in futs]
                    n, stages = score_segmax.launches, calls["first_stage"] - before
                    if n != per_call * stages:
                        raise AssertionError(f"sharded {name} {lane} {b}: {n} launches for {stages} first stages")
                    launches += n
                    burst_first_stages += stages
                    for side, other_eng in (("unsharded", ref), ("cpu_copy", cpu)):
                        other = answer(other_eng, qs, lane)
                        what = f"sharded {name} {lane} {b} vs {side}"
                        if lane == "on":
                            compare_rerank_pools(eng, other_eng, got, other, qs, near, worst, what)
                        elif lane == "mmr":
                            for i, (a, w) in enumerate(zip(got, other)):
                                compare_mmr(rows_of(a, eng.store), rows_of(w, eng.store),
                                            rows_cpu[eng.store.quantized], DIVERSITY, near, f"{what} {i}")
                        else:
                            same_rows([rows_of(r, eng.store) for r in got], [rows_of(r, eng.store) for r in other],
                                      what)
                        checked[side] += len(qs)
        finally:
            batcher.stop()
        if calls["columnar"] or calls["object"] == 0:
            raise AssertionError(f"sharded {name}: lanes {calls}")
        out["launches"] += launches
        line = {"sharded_lanes": name, "stand_in": f"{shards} shards on 1 card", "env": env,
                "mesh": eng._mesh.shape, "rows_a_shard": eng.store.corpus().rows, "lanes": list(SHARD_LANES),
                "bursts": list(SHARD_BURSTS), "object_lane_batches": calls["object"],
                "first_stage_calls": burst_first_stages, "columnar_calls": calls["columnar"],
                "score_segmax_masked_launches": launches, "checked": checked,
                "int8_escalations": eng.int8_escalations}
        if name == "corpus4":
            # a save and reload: the saved file is the unsharded format
            eng.save_to_disk()
            with env_set("RAG_TPU_SHARD_CORPUS", "4"), stand_in(dev, 4):
                again = RagEngine(eng.data_dir, engine.embedding_service, device=dev)
            qs = queries_for(rng, 16, probs)
            if len(again.store) != len(eng.store) or again._mesh is None:
                raise AssertionError(f"sharded reload: {len(again.store)} chunks, mesh {again._mesh}")
            same_rows([rows_of(r, again.store) for r in answer(again, qs, "off")],
                      [rows_of(r, plain.store) for r in answer(plain, qs, "off")], "sharded reload vs unsharded")
            line["reload_checked"] = len(qs)
            del again
        log({**line, "seconds": time.perf_counter() - t0, "card": card})
        del eng, cpu
    log({"sharded_near_ties": near[:10], "count": len(near), "judge_max_diff_vs_unsharded": worst, "card": card})
    return out


def run_sharded(engine, dev, card: str, tmp: str, seed: int, rng, probs) -> dict:
    fn = sharded_functions(seed, dev, card)
    log({"sharded_functions": {k: v for k, v in fn.items() if k != "times"}, "card": card})
    torch.cuda.empty_cache()
    eng = sharded_engines(engine, dev, card, tmp, rng, probs)
    torch.cuda.empty_cache()
    return {"launches": fn["launches"] + eng["launches"], "functions": fn, "engines": eng}


# ------------------------------------------------------------- training ----

# the train phase: the trainers at the committed assets' widths on a cut
# corpus (the JAX defaults: the whole harvested corpus, 8,000 / 6,000 steps,
# eval bank 1,024, wheel READMEs mixed into the judge's corpus)
TRAIN_CORPUS = os.path.join(".cache", "train_corpus.txt")
TRAIN_LINES = 20000
TRAIN_PAIRS = 64  # train_step_check's batch
ENCODER_ARGS = ["--hard-negatives", "--batch", "256", "--steps", "64", "--scan", "16", "--warmup", "16",
                "--eval-every", "32", "--eval-bank", "512"]
RERANKER_ARGS = ["--steps", "32", "--scan", "16", "--batch", "128", "--warmup", "8", "--eval-every", "32",
                 "--readme-corpus", "0"]
TRAIN_CUTS = {"corpus_lines": [TRAIN_LINES, "all of the harvest (182,518 paragraphs for the committed encoder)"],
              "encoder_steps": [64, 8000], "encoder_eval_bank": [512, 1024], "encoder_eval_every": [32, 1600],
              "encoder_warmup": [16, 400], "reranker_steps": [32, 6000], "reranker_batch": [128, 256],
              "reranker_warmup": [8, 400], "reranker_eval_every": [32, 1600], "reranker_readme_corpus": [0, 1]}
# one loss-and-gradient step on the card against a CPU copy, both with bf16
# activations: the encoder tests hold bf16 embeddings to 2e-2 and cosine
# 0.999 (tests/test_torch_encoder.py); the loss is a mean of log-softmaxes
# of those embeddings over temperature 0.05, the gradients sums of their
# products. Each parameter's gradient: cosine 0.99 (a bf16 product
# carries 2^-8 relative error; summed over a batch it keeps the direction)
TRAIN_LOSS_TOL = 2e-2
TRAIN_GRAD_COS = 0.999
TRAIN_PARAM_COS = 0.99
F16_REL = 2.0 ** -11  # round to nearest f16: half an ulp, relative
# train_sharded: the (2, 2) step of a seeded encoder against its (1, 1)
# step, both on the card (the same arithmetic in another grouping): loss
# within 5e-3, global gradient cosine >= 0.9995, and each parameter's
# gradient cosine >= TRAIN_PARAM_COS
SHARDED_VOCAB = 8192
SHARDED_LOSS_TOL = 5e-3
SHARDED_GRAD_COS = 0.9995


def grad_agreement(got: dict, want: dict) -> dict:
    """{global cosine, worst parameter cosine and its name, worst norm ratio}
    of two {name: gradient} maps (CPU float64 arithmetic)."""
    dot = na = nb = 0.0
    worst, worst_name, ratio = 1.0, "", 1.0
    for name, g in got.items():
        a, b = g.double().cpu().flatten(), want[name].double().cpu().flatten()
        d, x, y = float(a @ b), float(a @ a), float(b @ b)
        dot, na, nb = dot + d, na + x, nb + y
        cos = d / max((x * y) ** 0.5, 1e-300) if x > 0 or y > 0 else 1.0
        if cos < worst:
            worst, worst_name = cos, name
        if y > 0:
            ratio = max(ratio, abs((x / y) ** 0.5 - 1.0) + 1.0)
    return {"global_cos": dot / max((na * nb) ** 0.5, 1e-300), "worst_param_cos": worst,
            "worst_param": worst_name, "worst_norm_ratio": ratio}


def check_grads(what: str, loss_got: float, loss_want: float, agree: dict) -> None:
    if not (np.isfinite(loss_got) and abs(loss_got - loss_want) <= TRAIN_LOSS_TOL):
        raise AssertionError(f"{what}: loss {loss_got} against {loss_want} (tol {TRAIN_LOSS_TOL})")
    if agree["global_cos"] < TRAIN_GRAD_COS or agree["worst_param_cos"] < TRAIN_PARAM_COS:
        raise AssertionError(f"{what}: gradients disagree {agree}")


def encoder_step(model, batch, dev) -> tuple:
    """(loss, {name: grad}) of one hard-negative InfoNCE step of `model`
    (an Encoder, or ShardedParams with a placed batch) on `dev`."""
    if isinstance(model, Encoder):
        model.zero_grad(set_to_none=True)
        loss = info_nce_loss_hn(model, *[torch.from_numpy(x).to(dev) for x in batch])
        loss.backward()
        return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}
    model.zero_grad()
    loss = info_nce_loss_hn(model, *batch)
    loss.backward()
    loss = loss.detach()
    grads = {}
    for name, blocks in model.blocks.items():
        gs = [b.grad for b in blocks]
        grads[name] = gs[0] if len(gs) == 1 else torch.cat(gs, dim=model.specs[name].index("model"))
    return float(loss), grads


def run_trainer(module: str, args: list, env: dict, tmp: str, name: str) -> dict:
    """`python -m rust_local_rag_tpu_torch.training.<module>` with `args`;
    -> its train_summary line, every line of its output logged."""
    out_path = os.path.join(tmp, f"{name}.log")
    t0 = time.perf_counter()
    with open(out_path, "w") as out_f:
        proc = subprocess.run([sys.executable, "-m", f"rust_local_rag_tpu_torch.training.{module}", *args],
                              cwd=ROOT, env=env, stdout=out_f, stderr=subprocess.STDOUT, timeout=900)
    seconds = time.perf_counter() - t0
    with open(out_path) as f:
        lines = f.read().splitlines()
    for line in lines:
        log(f"{name}| {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}")
    summary = next(json.loads(ln)["train_summary"] for ln in reversed(lines) if ln.startswith('{"train_summary"'))
    losses = summary["losses"]
    if not (losses and all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{module}: losses {losses} are not finite and falling")
    if summary["fused_attention_launches"] != 0 or not summary["written"]:
        raise AssertionError(f"{module}: {summary['fused_attention_launches']} attention launches, "
                             f"written {summary['written']}")
    summary["process_s"] = seconds
    return summary


def check_f16_reload(delta: float, state: dict, what: str) -> float:
    """The trainer's reload |delta| against half an f16 ulp of the largest
    weight; -> that bound."""
    top = max(float(v.abs().max()) for v in state.values())
    if not delta <= F16_REL * top:
        raise AssertionError(f"{what}: reload max |delta| {delta} above f16 rounding ({F16_REL} x {top})")
    return F16_REL * top


def train_sharded(enc_cpu, batch, loss_dev: float, grads_dev: dict, unk: int, seed: int, dev, card: str) -> dict:
    """train_sharded: the committed checkpoint's step on a (1, 1) mesh, as
    the trainer runs it, against the plain module's (loss_dev, grads_dev);
    then a seeded encoder at the committed widths with a vocabulary of
    SHARDED_VOCAB rows (8,193 does not divide over a model axis of 2: the
    port refuses it as JAX does) on a (2, 2) mesh standing on the card
    against its (1, 1) mesh."""
    mesh = build_mesh((1, 1), ("data", "model"), devices=[dev])
    params = shard_params(copy.deepcopy(enc_cpu), mesh)
    loss_11, grads_11 = encoder_step(params, place_batch(batch, mesh), dev)
    del params
    check_grads("(1, 1) step against the plain module", loss_11, loss_dev, grad_agreement(grads_11, grads_dev))
    del grads_11
    seeded = Encoder(dataclasses.replace(enc_cpu.cfg, vocab_size=SHARDED_VOCAB), torch.Generator().manual_seed(seed))
    # ids past the seeded vocabulary ("yes" at 8,192) become [UNK]; masks are 0/1
    seeded_batch = [np.where(x >= SHARDED_VOCAB, unk, x).astype(x.dtype) for x in batch]
    steps = {}
    for shape in ((1, 1), (2, 2)):
        mesh = build_mesh(shape, ("data", "model"), devices=[dev] * (shape[0] * shape[1]))
        params = shard_params(copy.deepcopy(seeded), mesh)
        steps[shape] = encoder_step(params, place_batch(seeded_batch, mesh), dev)
        del params
    agree = grad_agreement(steps[(2, 2)][1], steps[(1, 1)][1])
    log({"train_sharded": "(2, 2) on one card against (1, 1)", "stand_in": "4 mesh positions on 1 card",
         "model": f"seeded {seeded.cfg.depth} x {seeded.cfg.dim}, vocab {SHARDED_VOCAB}",
         "unk_ids": int(sum((x >= SHARDED_VOCAB).sum() for x in batch[0::2])), "loss": steps[(2, 2)][0],
         "loss_1x1": steps[(1, 1)][0], "committed_loss_1x1": loss_11, "encoder_loss": loss_dev, **agree,
         "loss_tol": SHARDED_LOSS_TOL, "grad_cos_min": SHARDED_GRAD_COS, "param_cos_min": TRAIN_PARAM_COS,
         "card": card})
    if not (np.isfinite(steps[(2, 2)][0]) and abs(steps[(2, 2)][0] - steps[(1, 1)][0]) <= SHARDED_LOSS_TOL
            and agree["global_cos"] >= SHARDED_GRAD_COS and agree["worst_param_cos"] >= TRAIN_PARAM_COS):
        raise AssertionError(f"sharded step: loss {steps[(2, 2)][0]} against {steps[(1, 1)][0]}, {agree}")
    return {"loss": steps[(2, 2)][0], "loss_1x1": steps[(1, 1)][0], "committed_loss_1x1": loss_11, **agree}


def run_train(seed: int, dev, card: str, tmp: str) -> dict:
    """The training slice at the committed assets' widths (phase train)."""
    log({"train_cuts": TRAIN_CUTS, "card": card})
    home = os.path.join(tmp, "home")  # the premine caches of this run
    os.makedirs(home)
    corpus = os.path.join(tmp, f"train_corpus_{TRAIN_LINES}.txt")
    with open(os.path.join(ROOT, TRAIN_CORPUS), encoding="utf-8") as src, open(corpus, "w", encoding="utf-8") as dst:
        for i, line in enumerate(src):
            if i >= TRAIN_LINES:
                break
            dst.write(line)
    tok_path = default_asset("tokenizer.json")
    tok = load_tokenizer(tok_path)
    out: dict = {}

    # train_step_check: one hard-negative InfoNCE step of the committed
    # encoder on 64 pairs of the trainer's own batcher (the same train split
    # and seed, so the trainer below finds this premine in the cache)
    with env_set("HOME", home):
        t0 = time.perf_counter()
        paragraphs, _ = load_training_paragraphs(corpus, True)
        train_pars, _ = split_holdout(paragraphs, 0, 2048)
        batcher = PairBatcher(train_pars, tok, seed=seed, query_prefix="search_query: ",
                              doc_prefix="search_document: ")
        batcher.premine_hard_negatives()
        premine_s = time.perf_counter() - t0
    batch = batcher.mixed_hn_batch(TRAIN_PAIRS)
    enc_cpu, _ = load_encoder_checkpoint(default_asset("encoder.safetensors"))
    enc_dev = copy.deepcopy(enc_cpu).to(dev)
    t0 = time.perf_counter()
    loss_dev, grads_dev = encoder_step(enc_dev, batch, dev)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_cpu, grads_cpu = encoder_step(enc_cpu, batch, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    agree = grad_agreement(grads_dev, grads_cpu)
    log({"train_step_check": "encoder", "pairs": TRAIN_PAIRS, "shapes": [list(x.shape) for x in batch],
         "loss": loss_dev, "cpu_loss": loss_cpu, "loss_tol": TRAIN_LOSS_TOL, **agree, "grad_cos_min": TRAIN_GRAD_COS,
         "param_cos_min": TRAIN_PARAM_COS, "premine_s": premine_s, "card_s": dev_s, "cpu_s": cpu_s, "card": card})
    check_grads("encoder step", loss_dev, loss_cpu, agree)
    out["encoder_step"] = {"loss": loss_dev, "cpu_loss": loss_cpu, **agree}

    # the judge: one pairwise + calibration loss step on 64 prompt pairs
    rr_cpu, rr_meta = load_reranker_checkpoint(default_asset("reranker.safetensors"))
    with env_set("HOME", home):
        prompts = PromptPairBatcher(train_pars[:4096], tok, DEFAULT_PROMPT_TEMPLATE,
                                    seq_len=int(rr_meta.get("train_seq_len", "192")), seed=seed + 1)
    pi, pm, ni, nm = prompts.batch(TRAIN_PAIRS)
    yes_id, no_id = decision_ids(tok, prompts.cls_id, prompts.sep_id)
    rr_dev = copy.deepcopy(rr_cpu).to(dev)
    found = {}
    for name, model, d in (("card", rr_dev, dev), ("cpu", rr_cpu, torch.device("cpu"))):
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss = pair_loss(model, *[torch.from_numpy(x).to(d) for x in (pi, pm, ni, nm)], yes_id, no_id)
        loss.backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
        found[name] = (float(loss.detach()), {k: p.grad for k, p in model.named_parameters()},
                       time.perf_counter() - t0)
    agree = grad_agreement(found["card"][1], found["cpu"][1])
    log({"train_step_check": "reranker", "pairs": TRAIN_PAIRS, "seq_len": pi.shape[1], "loss": found["card"][0],
         "cpu_loss": found["cpu"][0], "loss_tol": TRAIN_LOSS_TOL, **agree, "card_s": found["card"][2],
         "cpu_s": found["cpu"][2], "card": card})
    check_grads("reranker step", found["card"][0], found["cpu"][0], agree)
    out["reranker_step"] = {"loss": found["card"][0], "cpu_loss": found["cpu"][0], **agree}
    del rr_dev, rr_cpu, found

    out["sharded"] = train_sharded(enc_cpu, batch, loss_dev, grads_dev, tok.token_to_id("[UNK]"), seed, dev, card)
    del enc_dev, grads_dev, grads_cpu
    torch.cuda.empty_cache()

    # the trainers themselves, as a user runs them, with the attention
    # kernel switched on in their environment (training must not take it)
    env = dict(os.environ, HOME=home, RAG_TPU_FUSED_ATTN="1",
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    common = ["--corpus", corpus, "--tokenizer", tok_path]
    enc_out = os.path.join(tmp, "encoder", "encoder.safetensors")
    summary = run_trainer("train_encoder", common + ENCODER_ARGS + ["--out", enc_out], env, tmp, "train_encoder")
    enc, meta = load_encoder_checkpoint(enc_out)
    bound = check_f16_reload(summary["reload_max_abs_delta"], enc.state_dict(), "train_encoder")
    served = encoder_module.TransformerEncoderModel(enc, tok, query_prefix=meta.get("query_prefix", ""),
                                                   document_prefix=meta.get("document_prefix", ""), device=dev)
    embs = served.encode(train_pars[:8])
    if not (np.isfinite(embs).all() and embs.shape == (8, 768)
            and np.allclose(np.linalg.norm(embs, axis=1), 1.0, atol=1e-3)):
        raise AssertionError("the trained encoder does not serve finite unit [8, 768] embeddings")
    log({"train_encoder": summary, "f16_bound": bound, "served": list(embs.shape), "card": card})
    out["train_encoder"] = summary
    del served, enc

    rr_out = os.path.join(tmp, "reranker", "reranker.safetensors")
    summary = run_trainer("train_reranker", common + RERANKER_ARGS + ["--out", rr_out], env, tmp, "train_reranker")
    rr, meta = load_reranker_checkpoint(rr_out)
    bound = check_f16_reload(summary["reload_max_abs_delta"], rr.state_dict(), "train_reranker")
    judge = TransformerReranker(rr, tok, int(meta["train_seq_len"]), device=dev)
    scored = judge.score_prompts([DEFAULT_PROMPT_TEMPLATE.format(query=p[:60], document="a.pdf", page="1",
                                                                 section="N/A", text=p) for p in train_pars[:8]])
    if not (len(scored) == 8 and all(np.isfinite(x).all() and 0.0 <= x[0] <= 1.0 for x in scored)):
        raise AssertionError(f"the trained reranker does not serve finite scores: {scored}")
    log({"train_reranker": summary, "f16_bound": bound, "served": len(scored), "card": card})
    out["train_reranker"] = summary
    out["checkpoints"] = {"encoder": enc_out, "reranker": rr_out, "tokenizer": tok_path}
    del judge, rr
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------- the model-update loop ----

MODEL_PATH_TOL = 1e-6  # the same weights through the same kernels on one card
CALIBRATION_POINTS = "0.0,0.06"  # sweep_rejection's two points in the smoke
SCALE_N = 100_000  # scale_check's rows (tools/scale_check.py's default)
SOAK_SECONDS = 20.0
SOAK_DOCS = 6  # the eval corpus's first authored documents under the soak


@contextmanager
def model_logs():
    """The INFO records of the port's model loaders inside the block."""
    records: list = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    logger = logging.getLogger("rust_local_rag_tpu_torch.models")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield records
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def run_model_paths(ckpt: dict, dev, card: str, tmp: str) -> dict:
    """ROADMAP C13 on the card (phase model_paths, after train): the
    services built with ENCODER_WEIGHTS / RERANKER_WEIGHTS naming the
    checkpoints train wrote must give the embeddings and yes-p of the same
    checkpoints loaded by explicit path (and not the committed models'); a
    named file that does not exist must give the seeded random init with
    its log line."""
    from rust_local_rag_tpu_torch.models.embedding_service import build_default_service
    from rust_local_rag_tpu_torch.models.reranker_service import build_default_reranker

    texts = ["How do I replace the pump seal?", "Torque the flange bolts to 45 Nm in a star pattern.",
             "The starter should double in size before the dough is mixed."]
    prompts = [DEFAULT_PROMPT_TEMPLATE.format(query=texts[0], document="m.pdf", page="1", section="N/A", text=t)
               for t in texts]
    explicit_enc = encoder_module.TransformerEncoderModel.from_assets(weights_path=ckpt["encoder"], device=dev)
    explicit_rr = TransformerReranker.from_assets(weights_path=ckpt["reranker"], device=dev)
    committed_enc = encoder_module.TransformerEncoderModel.from_assets(device=dev)
    want_emb, want_rr = explicit_enc.encode(texts), np.asarray(explicit_rr.score_prompts(prompts))
    committed_emb = committed_enc.encode(texts)
    del explicit_enc, explicit_rr, committed_enc
    score_segmax.launches = fused_attention.launches = 0
    with ExitStack() as stack:
        for k, v in (("ENCODER_WEIGHTS", ckpt["encoder"]), ("RERANKER_WEIGHTS", ckpt["reranker"]),
                     ("RAG_TPU_RERANK_MODEL", "tpu-reranker")):
            stack.enter_context(env_set(k, v))
        svc, rr = build_default_service(dev), build_default_reranker(dev)
        got_emb, got_rr = svc.embed_texts(texts), np.asarray(rr.score_prompts(prompts))
    launches = {"score_segmax_masked": score_segmax.launches, "fused_attention": fused_attention.launches}
    emb_err, rr_err = float(np.abs(got_emb - want_emb).max()), float(np.abs(got_rr - want_rr).max())
    if emb_err > MODEL_PATH_TOL or rr_err > MODEL_PATH_TOL:
        raise AssertionError(f"model_paths: the named checkpoints serve other outputs ({emb_err}, {rr_err})")
    committed_gap = float(np.abs(got_emb - committed_emb).max())
    if committed_gap < 1e-2:
        raise AssertionError(f"model_paths: ENCODER_WEIGHTS served the committed encoder (gap {committed_gap})")
    missing = os.path.join(tmp, "missing.safetensors")
    with model_logs() as records, env_set("ENCODER_WEIGHTS", missing), env_set("RERANKER_WEIGHTS", missing):
        rand_enc = encoder_module.TransformerEncoderModel.from_assets(device=dev)
        rand_rr = TransformerReranker.from_assets(device=dev)
        rand_emb, rand_scores = rand_enc.encode(texts), rand_rr.score_prompts(prompts)
    lines = [r.getMessage() for r in records if "random init" in r.getMessage()]
    if lines != ["Encoder running with seeded random init (no weights file)",
                 "Reranker running with seeded random init"]:
        raise AssertionError(f"model_paths: the missing file's log lines are {lines}")
    if not (rand_emb.shape == (3, 768) and np.isfinite(rand_emb).all() and rand_enc.cfg.depth == 12
            and rand_rr.judge_seq_len == 192 and np.isfinite(np.asarray(rand_scores)).all()):
        raise AssertionError("model_paths: the random inits do not serve")
    del rand_enc, rand_rr, svc, rr
    torch.cuda.empty_cache()
    out = {"model_paths": {"emb_max_abs_err": emb_err, "yes_p_max_abs_err": rr_err, "tol": MODEL_PATH_TOL,
                           "gap_to_committed_encoder": committed_gap, "random_init_lines": lines,
                           "launches": launches}, "card": card}
    log(out)
    return out["model_paths"]


def run_calibration(dev, card: str, tmp: str) -> dict:
    """The offline calibration studies on the card (phase calibration):
    tools.judge_dev builds the dev heads over the eval corpus with the
    committed encoder (cache in the smoke's directory: nothing read from an
    earlier run), then judge_dev's and gate_grid's mains with the attention
    kernel on (RAG_TPU_FUSED_ATTN=1; launches counted, > 0); then, beside
    the path, every candidate's yes-p with the kernel within RR_TOL of the
    same fused path with the kernel's plain twin (attention_plain) in its
    place, the gap to the plain path (RAG_TPU_FUSED_ATTN unset: f32 q.k)
    recorded, and the gate table's headline numbers."""
    from rust_local_rag_tpu_torch.tools import blend_offline, common, gate_grid, judge_dev

    judge_dev.CACHE = os.path.join(tmp, "calibration", "torch_dev_heads.pkl")
    if os.path.exists(judge_dev.CACHE):
        raise AssertionError("calibration: a heads cache exists before the phase")
    t0 = time.perf_counter()
    heads = judge_dev._heads(dev)
    heads_s = time.perf_counter() - t0
    if len(heads) != 168 or sum(h[1] for h in heads) != 15 or any(len(h[3]) != 15 for h in heads):
        raise AssertionError(f"calibration: {len(heads)} heads")
    score_segmax.launches = fused_attention.launches = 0
    with env_set("RAG_TPU_FUSED_ATTN", "1"):
        t0 = time.perf_counter()
        judge_dev.main([])
        gate_grid.main([])
        mains_s = time.perf_counter() - t0
    launches = {"score_segmax_masked": score_segmax.launches, "fused_attention": fused_attention.launches}
    if launches["fused_attention"] == 0:
        raise AssertionError("calibration: the judge forward launched no attention kernel")
    rr = common.default_judge(dev)
    with env_set("RAG_TPU_FUSED_ATTN", "1"):
        yes_on = np.asarray(common.score_heads(heads, rr))
        # the same fused path (q and k rounded to bf16, as JAX's fused
        # branch rounds them) with the kernel's plain twin in its place
        encoder_module.fused_attention = attention_plain
        try:
            yes_twin = np.asarray(common.score_heads(heads, rr))
        finally:
            encoder_module.fused_attention = fused_attention
    if os.environ.get("RAG_TPU_FUSED_ATTN"):
        raise AssertionError("calibration: RAG_TPU_FUSED_ATTN is set outside the kernel's pass")
    yes_off = np.asarray(common.score_heads(heads, rr))
    err = float(np.abs(yes_on - yes_twin).max())
    if not (np.isfinite(yes_on).all() and ((yes_on >= 0) & (yes_on <= 1)).all()) or err > RR_TOL:
        raise AssertionError(f"calibration: yes-p kernel / plain twin differ by {err} (tol {RR_TOL})")
    # the fused path against the plain one (f32 q.k): recorded, not bounded
    # here: the two round q and k differently (PERF.md §6, §7)
    on_off = np.abs(yes_on - yes_off)
    grid = gate_grid.table(heads, yes_on)
    grid_off = gate_grid.table(heads, yes_off)
    jd = judge_dev.table(heads, yes_on)
    blend = blend_offline.table([h for h in heads if not h[1]], yes_on[np.repeat([not h[1] for h in heads], 15)])
    out = {"calibration": {"heads": len(heads), "prompts": len(yes_on), "heads_s": heads_s, "mains_s": mains_s,
                           "launches": launches, "yes_p_kernel_vs_plain_twin_max_abs_err": err,
                           "tol": RR_TOL, "yes_p_fused_vs_plain_path": {
                               "max": float(on_off.max()), "p99": float(np.percentile(on_off, 99)),
                               "above_tol": int((on_off > RR_TOL).sum()),
                               "gate_passing_plain_path": grid_off["n_passing"],
                               "gate_best_plain_path": grid_off["passing"][:1]},
                           "judge_dev": {k: jd[k] for k in ("gold_max", "gold_best_gold", "junk_max")},
                           "gate_passing": grid["n_passing"], "gate_best": grid["passing"][:1],
                           "pareto": grid["pareto"][:6], "blend": blend}, "card": card}
    log(out)
    return out["calibration"]


def run_sweep(quality: dict, card: str) -> dict:
    """tools.sweep_rejection with two points against the port's server on
    the card over the eval corpus (phase sweep, after quality): each point's
    hit, mrr and rejection in [0, 1], and the threshold-0 point (baseline.yaml
    itself) equal to the quality phase's baseline. The server is a process
    of its own, so this process counts no launch."""
    from rust_local_rag_tpu_torch.tools import sweep_rejection

    if os.environ.get("RAG_TPU_FUSED_ATTN"):
        raise AssertionError("sweep: RAG_TPU_FUSED_ATTN is set; quality ran without it")
    score_segmax.launches = fused_attention.launches = 0
    res = sweep_rejection.sweep(CALIBRATION_POINTS, "cuda")
    launches = {"score_segmax_masked": score_segmax.launches, "fused_attention": fused_attention.launches}
    base = quality["quality_table"]["baseline"]
    want = {"hit": round(base["hit_rate_mean"], 3), "mrr": round(base["mrr_mean"], 3),
            "rej": round(base["rejection_success_rate"], 3)}
    if sorted(res) != ["0.0", "0.06"] or any(not 0.0 <= v <= 1.0 for r in res.values() for v in r.values()):
        raise AssertionError(f"sweep: {res}")
    if res["0.0"] != want:
        raise AssertionError(f"sweep: the threshold-0 point {res['0.0']} is not quality's baseline {want}")
    out = {"sweep": res, "quality_baseline": want, "launches_in_this_process": launches, "card": card}
    log(out)
    return out


def run_scale_check(dev, card: str) -> dict:
    """tools.scale_check at SCALE_N 100,000 (phase scale_check): the oracle
    must pass, the store reach capacity 131,072 and the masked kernel
    launch (counted) in the engine's searches."""
    from rust_local_rag_tpu_torch.tools import scale_check

    score_segmax.launches = fused_attention.launches = 0
    res = scale_check.run(SCALE_N, dev, log=log)
    launches = {"score_segmax_masked": score_segmax.launches, "fused_attention": fused_attention.launches}
    if not res["oracle"] or res["capacity"] != 131072 or launches["score_segmax_masked"] == 0:
        raise AssertionError(f"scale_check: {res}, launches {launches}")
    out = {"scale_check": res, "launches": launches, "card": card}
    log(out)
    return out


def run_soak(card: str, tmp: str) -> dict:
    """tools.soak for SOAK_SECONDS against `python -m
    rust_local_rag_tpu_torch` on the card (committed models,
    RAG_TPU_FUSED_ATTN=1) over SOAK_DOCS documents of the eval corpus: zero
    errors, every invariant held, the final revision served."""
    from eval_harness import corpus

    from rust_local_rag_tpu_torch.evaluation.quality import corpus_server
    from rust_local_rag_tpu_torch.tools import soak

    work = os.path.join(tmp, "soak")
    docs, data, logs, every = (os.path.join(work, d) for d in ("documents", "data", "logs", "all"))
    for d in (docs, data, logs):
        os.makedirs(d)
    for name in sorted(corpus.generate_corpus(every, with_distractors=False))[:SOAK_DOCS]:
        os.replace(os.path.join(every, name), os.path.join(docs, name))
    with corpus_server(docs, data, logs, "cuda", env={"RAG_TPU_FUSED_ATTN": "1"}, log=log) as (base, _, started):
        res = soak.soak(base, SOAK_SECONDS, documents=docs)
    c = res["counts"]
    if res["errors"] or not res["final_revision"] or c["search"] == 0 or c["reindex"] < 2:
        raise AssertionError(f"soak: {res['counts']}, errors {res['errors'][:10]}")
    out = {"soak": {**res, "seconds": SOAK_SECONDS, "documents": SOAK_DOCS, "server": started}, "card": card}
    log(out)
    return out


# ---------------------------------------------- the last scripts of A ----

TOPK_PROFILES = (profile_topk, qscale, qscale2, blockn)
XLA_STUDIES = (rw_segmax, xla_blocked, xla_segmax, partialreduce)
ENGINE_PROFILE_N = BENCH_SERVER_N  # bench_server's smoke size: its slab runs the masked kernel
DISPATCH_QB = 512  # tools/dispatch_profile's default batch
# the host ceilings at a few seconds a point, each `python -m` in a session
# of its own: (module, argv)
CEILINGS = (("stack_ceiling", ["null", "64", "3"]),
            ("stack_ceiling", ["bm25", "64", "3", str(BENCH_SERVER_N)]),
            ("http_ceiling", ["--seconds", "2"]),
            ("proto_ceiling", ["--seconds", "2"]),
            ("reuseport", ["--seconds", "2"]))


def jsonable(obj):
    """obj with tuple dict keys joined by '_' (json.dumps refuses them)."""
    if isinstance(obj, dict):
        return {("_".join(map(str, k)) if isinstance(k, tuple) else k): jsonable(v) for k, v in obj.items()}
    return obj


def run_modules(mods, dev, what: str) -> dict:
    """Each module's main at its own (the bench shard's) shape, the
    unmasked kernel's launches set to 0 just before and read just after.
    -> {"results": {module: main()}, "launches": n}."""
    fused_score_segmax.launches = 0
    results = {}
    for mod in mods:
        log(f"-- python -m {mod.__name__}")
        before = fused_score_segmax.launches
        results[mod.__name__.rsplit(".", 1)[1]] = jsonable(mod.main(device=dev))
        log({"launches": {"fused_score_segmax": fused_score_segmax.launches - before}, "module": mod.__name__})
    launches = fused_score_segmax.launches
    if launches <= 0:
        raise AssertionError(f"{what} never launched the unmasked kernel")
    return {"results": results, "launches": launches}


def run_topk_profiles(seed: int, dev, card: str) -> dict:
    """experiments.profile_topk, qscale, qscale2 and blockn at the bench
    shard (qscale's and qscale2's mains raise on a top-k that is not exact
    at Q 512 and 1,024), then profile_topk's whole pipeline held to
    torch.topk over the kernel's own scores (values and indices) and to the
    plain plane (EXP_REL_TOL, over the largest score)."""
    out = run_modules(TOPK_PROFILES, dev, "topk_profiles")
    corpus = exp_common.normal_bf16((N_BENCH, DIM), seed, dev)
    qs = exp_common.normal_bf16((exp_common.Q, DIM), seed + 1, dev)
    v, i = profile_topk.pipeline(qs, corpus, 128)
    wv, wi = torch.topk(fused_score_segmax(qs, corpus)[0], exp_common.K, dim=1)
    okv, oki, ties = exp_common.same_topk(v, i, wv, wi)
    plain = exp_common.check_topk(v, i, qs, corpus, EXP_REL_TOL)
    out["pipeline_check"] = {"values": okv, "indices": oki, "boundary_ties": ties, **plain, "rel_tol": EXP_REL_TOL}
    del corpus, qs, v, i, wv, wi
    exp_common.release(dev)
    log({"topk_profiles": out, "card": card})
    if not (okv and oki) or plain["max_rel_err"] > EXP_REL_TOL or plain["outside_top_k"]:
        raise AssertionError(f"profile_topk's pipeline is not the exact top-k: {out['pipeline_check']}")
    return out


def run_xla_studies(dev, card: str) -> dict:
    """experiments.rw_segmax, xla_blocked, xla_segmax and partialreduce at
    the bench shard, each raising on a failed exactness or equality check,
    with row 2's kernel timed beside each."""
    out = run_modules(XLA_STUDIES, dev, "xla_studies")
    log({"xla_studies": out, "card": card})
    return out


def run_engine_profiles(dev, card: str) -> dict:
    """tools.server_profile and tools.dispatch_profile (QB 512) on one
    engine of ENGINE_PROFILE_N chunks built as server_profile builds it
    (f32 slab), the masked kernel's launches counted over both."""
    from rust_local_rag_tpu_torch import bench_server
    from rust_local_rag_tpu_torch.tools import dispatch_profile, server_profile

    with tempfile.TemporaryDirectory(prefix="rag_port_smoke_prof_") as tmp:
        t0 = time.perf_counter()
        eng = server_profile.build(ENGINE_PROFILE_N, tmp, dev, log)
        try:
            build_s = time.perf_counter() - t0
            log(f"snapshots: {eng.lexical_index.compile_all()}")
            score_segmax.launches = fused_attention.launches = 0
            sp = server_profile.profile(eng, server_profile.queries(), log=log)
            dp = dispatch_profile.decompose(eng, bench_server.zipf_queries(DISPATCH_QB), log=log)
            launches = {"score_segmax_masked": score_segmax.launches, "fused_attention": fused_attention.launches}
            capacity = eng.store.capacity
        finally:
            eng.embedding_service.close()
    out = {"chunks": ENGINE_PROFILE_N, "slab_rows": capacity, "build_s": build_s, "server_profile": sp,
           "dispatch_profile": dp, "launches": launches}
    log({"engine_profiles": out, "card": card})
    if sp["results_per_query"] != [100] * len(sp["results_per_query"]) or launches["score_segmax_masked"] <= 0:
        raise AssertionError(f"engine_profiles: {sp['results_per_query'][:4]}..., launches {launches}")
    return out


def run_ceilings(card: str) -> dict:
    """The four host ceilings (CEILINGS), each `python -m` in a session of
    its own: exit 0, 0 errors, no child left in its session and its port
    free. -> {"module argv": its JSON line}."""
    from rust_local_rag_tpu_torch.tools import ceiling_common as cc

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    out = {}
    for name, argv in CEILINGS:
        proc = subprocess.Popen([sys.executable, "-m", f"rust_local_rag_tpu_torch.tools.{name}", *argv], cwd=ROOT,
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        left = cc.in_session(proc.pid)
        if left:
            os.killpg(proc.pid, signal.SIGKILL)
        if proc.returncode != 0:
            raise AssertionError(f"{name} {argv} exited {proc.returncode}: {stderr[-2000:]}")
        res = json.loads(stdout.strip().splitlines()[-1])[name]
        key = " ".join([name, *argv])
        out[key] = res
        log({"ceiling": key, **res, "left_in_session": left, "card": card})
        if res["errors"] or res["children_left"] or left or not cc.port_free(res["port"]):
            raise AssertionError(f"{key}: errors {res['errors']}, children {res['children_left']}, left {left}")
    return out


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
        built = build.build_all()
        for res in built.values():
            host = res.name in build.HOST_LIBRARIES
            log({"build": res.name, "seconds": res.seconds, "library": res.path.split("/")[-1],
                 "compiler": "g++" if host else "nvcc", **({} if host else {"ptxas": ptxas_summary(res.log)})})
            for line in res.log.splitlines():
                if line.strip():
                    log(f"{'g++' if res.name in build.HOST_LIBRARIES else 'ptxas'}| {line}")

    max_err = max_err_unmasked = max_err_attn = 0.0
    with phase("kernel_vs_plain", card, seconds):
        for dtype in (torch.float32, torch.bfloat16):
            for q in (1, 16, 128):
                queries, corpus, mask = kernel_case(args.seed, q, dtype, dev)
                err = check_kernel(queries, corpus, mask)
                max_err = max(max_err, err)
                log({"kernel_check": "score_segmax_masked", "dtype": str(dtype), "Q": q,
                     "N": N_SLAB, "D": DIM, "max_abs_err": err, "tol": SCORE_TOL, "card": card})
                err = check_unmasked(queries, corpus)
                max_err_unmasked = max(max_err_unmasked, err)
                log({"kernel_check": "fused_score_segmax", "dtype": str(dtype), "Q": q,
                     "N": N_SLAB, "D": DIM, "max_abs_err": err, "tol": SCORE_TOL, "card": card})
        # the stream's edges, each Q on its own data; one line per shape
        for dtype in (torch.float32, torch.bfloat16):
            for n, d in EDGE_SHAPES:
                errs = {"score_segmax_masked": [], "fused_score_segmax": [], "all_freed": []}
                for q in EDGE_Q:
                    queries, corpus, mask = kernel_case(args.seed + q, q, dtype, dev, n, d, freed="segment")
                    errs["score_segmax_masked"].append(check_kernel(queries, corpus, mask))
                    errs["fused_score_segmax"].append(check_unmasked(queries, corpus))
                    queries, corpus, mask = kernel_case(args.seed + q, q, dtype, dev, n, d, freed="all")
                    errs["all_freed"].append(check_kernel(queries, corpus, mask))
                    del queries, corpus, mask
                max_err = max(max_err, *errs["score_segmax_masked"], *errs["all_freed"])
                max_err_unmasked = max(max_err_unmasked, *errs["fused_score_segmax"])
                log({"kernel_edges": str(dtype), "N": n, "D": d, "Q": list(EDGE_Q), "max_abs_err": errs,
                     "tol": SCORE_TOL, "card": card})
        # past the stream: the tensor-core body on bf16 slabs with f32
        # queries and bf16 queries at any Q, and the f32 FMA body on f32
        # slabs, each Q on its own data
        for slab, qdt, q_list, shapes in ((torch.bfloat16, torch.float32, WIDE_Q, EDGE_SHAPES),
                                          (torch.bfloat16, torch.bfloat16, BF16_QUERY_Q, EDGE_SHAPES),
                                          (torch.float32, torch.float32, WIDE_Q, EDGE_SHAPES),
                                          (torch.bfloat16, torch.float32, WIDEST_Q, WIDEST_SHAPES),
                                          (torch.bfloat16, torch.bfloat16, WIDEST_Q, WIDEST_SHAPES)):
            for n, d in shapes:
                errs = {"score_segmax_masked": [], "fused_score_segmax": [], "all_freed": []}
                for q in q_list:
                    queries, corpus, mask = kernel_case(args.seed + q, q, slab, dev, n, d, freed="segment")
                    queries = queries.to(qdt)
                    errs["score_segmax_masked"].append(check_kernel(queries, corpus, mask))
                    errs["fused_score_segmax"].append(check_unmasked(queries, corpus))
                    queries, corpus, mask = kernel_case(args.seed + q, q, slab, dev, n, d, freed="all")
                    errs["all_freed"].append(check_kernel(queries.to(qdt), corpus, mask))
                    del queries, corpus, mask
                max_err = max(max_err, *errs["score_segmax_masked"], *errs["all_freed"])
                max_err_unmasked = max(max_err_unmasked, *errs["fused_score_segmax"])
                log({"kernel_wide": str(slab), "queries": str(qdt), "N": n, "D": d, "Q": list(q_list),
                     "max_abs_err": errs, "tol": SCORE_TOL, "card": card})
        # an f32 slab of more segments than a grid's y could hold (the
        # first version refused it at Q > 16), freed afterwards
        queries, corpus, mask = big_case(args.seed, BIG_Q, N_BIG, DIM, dev)
        errs = [check_kernel(queries, corpus, mask), check_unmasked(queries, corpus)]
        max_err = max(max_err, errs[0])
        max_err_unmasked = max(max_err_unmasked, errs[1])
        log({"kernel_check": "past_grid_limit", "dtype": str(corpus.dtype), "Q": BIG_Q, "N": N_BIG, "D": DIM,
             "segments": N_BIG // SEG, "max_abs_err": errs, "tol": SCORE_TOL, "card": card})
        del queries, corpus, mask
        torch.cuda.empty_cache()
        cases = ([(shape, False) for shape in ATTN_SHAPES + ATTN_EDGE]
                 + [(shape, True) for shape in ATTN_SCATTERED])
        for i, ((b, h, l, causal), scattered) in enumerate(cases):
            err = check_attention(*attention_case(args.seed + i, b, h, l, dev, scattered), causal)
            max_err_attn = max(max_err_attn, err)
            log({"kernel_check": "fused_attention", "B": b, "H": h, "L": l, "Dh": 64, "causal": causal,
                 "masks": "scattered" if scattered else "prefix", "body": attention_ops.body_for(l),
                 "max_abs_err": err, "tol": ATTN_TOL, "card": card})
        # where both bodies take a path shape's length (L <= 192) the
        # attention table times both: the one not picked there is held too
        for i, (b, h, l, causal) in enumerate(ATTN_SHAPES):
            for n, name in attention_ops.bodies_for(l).items():
                if name != attention_ops.body_for(l):
                    err = check_attention(*attention_case(args.seed + i, b, h, l, dev), causal, attention_launcher(n))
                    max_err_attn = max(max_err_attn, err)
                    log({"kernel_check": "fused_attention", "B": b, "H": h, "L": l, "Dh": 64, "causal": causal,
                         "masks": "prefix", "body": name, "max_abs_err": err, "tol": ATTN_TOL, "card": card})
        torch.cuda.synchronize()

    tmp = tempfile.mkdtemp(prefix="rag_port_smoke_")
    try:
        result = run_slice(args, dev, card, seconds, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    with phase("segmented_topk", card, seconds):
        # bench.py's exact top-k (pallas_segmented_topk there): the unmasked
        # kernel, then the segmented selection, against torch.topk over
        # the full plain scores
        fused_score_segmax.launches = 0
        topk_cases = ((1, torch.float32), (16, torch.float32), (128, torch.float32), (128, torch.bfloat16))
        for q, dtype in topk_cases:
            queries, corpus, _ = kernel_case(args.seed + 1, q, dtype, dev)
            vals, idx = segmented_topk(queries, corpus, TOP_K)
            fv, fi = torch.topk(fused_score_segmax_plain(queries, corpus)[0], TOP_K, dim=1)
            torch.cuda.synchronize()
            for r in range(q):
                got = [(int(i), float(v)) for i, v in zip(idx[r].tolist(), vals[r].tolist())]
                want = [(int(i), float(v)) for i, v in zip(fi[r].tolist(), fv[r].tolist())]
                same_topk(got, want, SCORE_TOL, f"segmented_topk Q{q} {dtype} row {r}")
        topk_launches = fused_score_segmax.launches
        log({"launches": {"fused_score_segmax": topk_launches},
             "segmented_topk_checked": [[q, str(dtype)] for q, dtype in topk_cases]})
        if topk_launches != len(topk_cases):
            raise AssertionError(f"segmented_topk launched the unmasked kernel {topk_launches} times, "
                                 f"want {len(topk_cases)}")

    with phase("experiments_check", card, seconds):
        exp_errs = experiments_check(args.seed, dev, card)
    with phase("experiments", card, seconds):
        exp_launches = run_experiments(dev)
    with phase("experiments_times", card, seconds):
        exp_times = experiments_times(args.seed, dev, card)
    with phase("topk_profiles", card, seconds):
        topk_prof = run_topk_profiles(args.seed, dev, card)
    with phase("xla_studies", card, seconds):
        xla_out = run_xla_studies(dev, card)

    with phase("times", card, seconds):
        main_path = None
        for dtype in (torch.float32, torch.bfloat16):
            for q in sorted({*TIME_Q, result["main_q"]}):
                qs, corpus, mask = kernel_case(args.seed, q, dtype, dev)
                masked, unmasked = score_segmax_times(qs, corpus, mask, card)
                if dtype == torch.float32 and q == result["main_q"]:
                    main_path = masked
                if dtype == torch.float32 and q == 16:
                    unmasked_main = unmasked
            flat = corpus.view(-1)  # the rate of a plain read of the same slab
            log({"slab_read": str(dtype), "N": N_SLAB, "D": DIM, "sum_ms": cuda_ms(lambda: flat.sum()),
                 "bytes": flat.numel() * flat.element_size(), "card": card})
            del qs, corpus, mask, flat
        wide_rows = wide_times(args.seed, dev, card)
        log({"wide_table": [{"entry": k[0], "Q": k[1], "N": k[2], "slab": k[3], "queries": k[4],
                             **{f: r[f] for f in ("ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
                                                  "library_split_ms") if f in r}} for k, r in wide_rows.items()],
             "card": card})
        # bench.py's shard at the serving path's widest batch: checked, then timed
        for dtype in (torch.float32, torch.bfloat16):
            qs, corpus, mask = kernel_case(args.seed, 16, dtype, dev, N_BENCH)
            errs = [check_kernel(qs, corpus, mask), check_unmasked(qs, corpus)]
            log({"kernel_check": "bench_shard", "dtype": str(dtype), "Q": 16, "N": N_BENCH, "D": DIM,
                 "max_abs_err": errs, "tol": SCORE_TOL, "card": card})
            score_segmax_times(qs, corpus, mask, card, reps=5, calls=3)
            flat = corpus.view(-1)
            log({"slab_read": str(dtype), "N": N_BENCH, "D": DIM, "sum_ms": cuda_ms(lambda: flat.sum(), reps=5, calls=3),
                 "bytes": flat.numel() * flat.element_size(), "card": card})
            del qs, corpus, mask, flat
            torch.cuda.empty_cache()
        attn_table = []
        for i, (b, h, l, causal) in enumerate(ATTN_SHAPES):
            q_, k_, v_, m_ = attention_case(args.seed + i, b, h, l, dev)
            bias = attention_bias(m_, causal).to(torch.bfloat16)
            kernel = lambda: fused_attention(q_, k_, v_, m_, causal)  # noqa: E731
            library = lambda: torch.nn.functional.scaled_dot_product_attention(q_, k_, v_, attn_mask=bias)  # noqa: E731
            ms = cuda_ms(kernel)
            # each body that takes this length, on the same inputs
            bodies_ms = {name: cuda_ms(lambda n=n: attention_ops.launch_body(q_, k_, v_, m_, causal, n))
                         for n, name in attention_ops.bodies_for(l).items()}
            plain_ms = cuda_ms(lambda: attention_plain(q_, k_, v_, m_, causal))
            library_ms = cuda_ms(library)
            b_ms, b_by = attention_bound(b, h, l)
            row = {"kernel_time": "fused_attention", "B": b, "H": h, "L": l, "Dh": 64, "causal": causal,
                   "body": attention_ops.body_for(l), "ms": ms, "bodies_ms": bodies_ms, "call_ms": call_ms(kernel),
                   "plain_ms": plain_ms, "library_ms": library_ms, "library_call_ms": call_ms(library),
                   "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
                   "exp_floor_ms": attention_exp_floor(b, h, l), "card": card}
            log(row)
            attn_table.append({k: row[k] for k in ("B", "H", "L", "causal", "body", "ms", "bodies_ms", "call_ms",
                                                   "bound_ms", "share_of_bound", "exp_floor_ms", "plain_ms",
                                                   "library_ms", "library_call_ms")})
            if (b, h, l, causal) == ATTN_MAIN:
                attn_main = row
            del q_, k_, v_, m_, bias
        log({"attention_table": attn_table, "card": card})
        for burst, lat in result["latency"].items():
            log({"search_burst": burst, "top_k": TOP_K, "median_ms": statistics.median(lat),
                 "min_ms": min(lat), "max_ms": max(lat), "reps": len(lat), "card": card})
        log({**result["ingest"], "card": card})
        rr = result["rerank"]
        for lane, bursts in rr["latency"].items():
            for burst, lat in bursts.items():
                log({"rerank_burst": burst, "lane": lane, "top_k": TOP_K, "median_ms": statistics.median(lat),
                     "min_ms": min(lat), "max_ms": max(lat), "reps": len(lat), "card": card})
        log({"rerank_launches": rr["launches"], "card": card})
        for size, lat in result["mmr"]["latency"].items():
            log({"mmr_burst": size, "diversity": DIVERSITY, "median_ms": statistics.median(lat), "min_ms": min(lat),
                 "max_ms": max(lat), "reps": len(lat), "card": card})
    with phase("int8_scale", card, seconds):
        run_int8_scale(args.seed, dev, card)
    late = tempfile.mkdtemp(prefix="rag_port_smoke_late_")
    try:
        with phase("srx", card, seconds):
            run_srx(card, late)
        with phase("pdf_tiers", card, seconds):
            run_pdf_tiers(card, result["pdfs"], built)
        with phase("quality", card, seconds):
            quality_out = run_quality(card, late, seconds)
        with phase("sweep", card, seconds):
            run_sweep(quality_out, card)
        with phase("bench", card, seconds):
            _, bench_launches = run_bench(card)
        with phase("bench_server", card, seconds):
            _, server_launches = run_bench_server(card)
    finally:
        shutil.rmtree(late, ignore_errors=True)
    train_tmp = tempfile.mkdtemp(prefix="rag_port_smoke_train_")
    try:
        with phase("train", card, seconds):
            trained = run_train(args.seed, dev, card, train_tmp)
        with phase("model_paths", card, seconds):
            paths_out = run_model_paths(trained["checkpoints"], dev, card, train_tmp)
        with phase("tok", card, seconds):
            run_tok(card, train_tmp)
    finally:
        shutil.rmtree(train_tmp, ignore_errors=True)
    loop_tmp = tempfile.mkdtemp(prefix="rag_port_smoke_loop_")
    try:
        with phase("calibration", card, seconds), env_set("RAG_TPU_RERANK_MODEL", "tpu-reranker"):
            calib_out = run_calibration(dev, card, loop_tmp)
        with phase("scale_check", card, seconds):
            scale_out = run_scale_check(dev, card)
        with phase("soak", card, seconds):
            run_soak(card, loop_tmp)
    finally:
        shutil.rmtree(loop_tmp, ignore_errors=True)
    with phase("engine_profiles", card, seconds):
        prof_out = run_engine_profiles(dev, card)
    with phase("ceilings", card, seconds):
        run_ceilings(card)
    log({"phase_seconds": seconds, "phase_total_s": sum(seconds.values()), "card": card})
    srv = result["server"]
    masked_by_path = {"hot": result["launches"], "bf16_wide": result["bf16_wide"]["launches"],
                      "f32_wide": result["f32_wide"]["launches"], "int8": result["int8"]["hot"]["score_segmax_masked"],
                      "mmr": result["mmr"]["launches"],
                      **{lane: x["score_segmax_masked"] for lane, x in rr["launches"].items()},
                      "http": srv["launches"]["score_segmax_masked"],
                      "trace": result["trace"]["launches"]["score_segmax_masked"],
                      "bench": bench_launches["score_segmax_masked"],
                      "bench_server": server_launches["score_segmax_masked"],
                      "sharded": result["sharded"]["launches"],
                      "scale_check": scale_out["launches"]["score_segmax_masked"],
                      "model_paths": paths_out["launches"]["score_segmax_masked"],
                      "engine_profiles": prof_out["launches"]["score_segmax_masked"]}
    log({"score_segmax_masked_launches_by_path": masked_by_path, "card": card})
    log({"new_path_launches": {"trace": result["trace"]["launches"], "bench": bench_launches,
                               "bench_server": server_launches, "model_paths": paths_out["launches"],
                               "calibration": calib_out["launches"], "scale_check": scale_out["launches"],
                               "engine_profiles": prof_out["launches"],
                               "topk_profiles": {"fused_score_segmax": topk_prof["launches"]},
                               "xla_studies": {"fused_score_segmax": xla_out["launches"]}},
         "card": card})
    bd, lx, tk = result["breakdown"], result["lexical"], result["tokenizer"]
    log({"host_libs": [{
        "name": "lexical",
        "source": LEXICAL_SOURCE,
        "copy_of": "native/lexical.cpp",
        "build_s": built["lexical"].seconds,
        "batch16_prep_lexical_ms": bd["batch16_bm25_ms"],
        "python_batch16_prep_lexical_ms": bd["batch16_bm25_python_ms"],
        "ms_per_query": lx["native_ms_per_query"],
        "python_ms_per_query": lx["python_ms_per_query"],
        "max_rel_score_diff": lx["max_rel_score_diff"],
        "threads_equal_sequential": lx["threads_equal_sequential"],
    }, {
        "name": "wordpiece",
        "source": WORDPIECE_SOURCE,
        "copy_of": "native/wordpiece.cpp",
        "build_s": built["wordpiece"].seconds,
        "chunks_s": tk["chunks_native_s"],
        "python_chunks_s": tk["chunks_python_s"],
        "texts": tk["tokenizer_check_texts"],
        "routed_texts": tk["routed_texts"],
    }, {
        "name": "serializer",
        "source": SERIALIZER_SOURCE,
        "copy_of": "native/serializer.cpp",
        "build_s": built["serializer"].seconds,
        **{k: v for k, v in srv["serializer"].items() if k != "build_s"},
    }], "card": card})

    log({"kernels": [{
        "name": "score_segmax_masked",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": sum(masked_by_path.values()),
        "max_abs_err": max_err,
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": main_path["library_ms"],
    }, {
        "name": "fused_attention",
        "route": "cuda",
        "source": ATTN_SOURCE,
        "replaces": ATTN_REPLACES,
        "launches": (sum(x["fused_attention"] for x in rr["launches"].values()) + srv["launches"]["fused_attention"]
                     + result["int8"]["rerank"]["fused_attention"] + result["trace"]["launches"]["fused_attention"]
                     + server_launches["fused_attention"] + calib_out["launches"]["fused_attention"]
                     + paths_out["launches"]["fused_attention"] + prof_out["launches"]["fused_attention"]),
        "max_abs_err": max_err_attn,
        "ms": attn_main["ms"],
        "plain_ms": attn_main["plain_ms"],
        "bound_ms": attn_main["bound_ms"],
        "bound_by": attn_main["bound_by"],
        "library_ms": attn_main["library_ms"],
    }, {
        "name": "fused_score_segmax",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": UNMASKED_REPLACES,
        "launches": (topk_launches + exp_launches["fused_score_segmax"] + bench_launches["fused_score_segmax"]
                     + topk_prof["launches"] + xla_out["launches"]),
        "max_abs_err": max_err_unmasked,
        "ms": unmasked_main["ms"],
        "plain_ms": unmasked_main["plain_ms"],
        "bound_ms": unmasked_main["bound_ms"],
        "bound_by": unmasked_main["bound_by"],
        "library_ms": unmasked_main["library_ms"],
    }, *[{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": exp_launches[name],
        "max_abs_err": exp_errs[name],
        **{k: exp_times[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    } for name, source, replaces in (
        ("segmax", SEGMAX_SOURCE, SEGMAX_REPLACES),
        ("stream_segmax", STREAM_SOURCE, STREAM_REPLACES),
        ("read_probe", STREAM_SOURCE, PROBE_REPLACES),
        ("resident_dot_segmax", RESIDENT_SOURCE, RESIDENT_REPLACES),
    )]]})
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
        reranker = RerankerService(TransformerReranker.from_assets(device=dev))
        t_reranker = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine = RagEngine.create(tmp, device=dev, reranker=reranker)
        t_create = time.perf_counter() - t0
        n_pdf = 0
        pdfs = documents(rng, probs)
        for name, data in pdfs.items():
            n = engine.add_document(name, data)
            if n <= 0:
                raise AssertionError(f"add_document({name}) indexed no chunks")
            n_pdf += n
        if not isinstance(engine.lexical_index, NativeLexicalIndex):
            raise AssertionError(f"the engine's BM25 index is {type(engine.lexical_index).__name__}")
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
        t0 = time.perf_counter()
        engine.warmup()
        t_warmup = time.perf_counter() - t0
        live = len(engine.store)
        if not (live > N_SLAB // 2 and engine.store.capacity == N_SLAB and uses_score_segmax(N_SLAB)):
            raise AssertionError(f"{live} live chunks, capacity {engine.store.capacity}")
        if not np.isfinite(embs).all() or embs.shape != (args.extra_chunks, DIM):
            raise AssertionError("embeddings are not finite [n, 768]")
        ingest = {"ingest_chunks": len(texts), "pdf_chunks": n_pdf, "live_chunks": live,
                  "reranker_load_s": t_reranker, "create_s": t_create, "embed_s": t_embed, "embed_chunks_per_s": len(texts) / t_embed,
                  "store_and_bm25_s": t_add, "save_s": t_save,
                  "save_bytes": os.path.getsize(persistence.get_index_path(engine.data_dir, engine.embedding_model())),
                  "warmup_s": t_warmup,
                  "ingest_chunks_per_s": len(texts) / (t_embed + t_add)}
        log(ingest)

    # the phases added after the rerank lanes draw from their own stream,
    # so every earlier phase keeps the queries it had
    rng_host = np.random.default_rng([args.seed, 9])
    with phase("lexical_check", card, seconds):
        py_index, lex_stats = lexical_check(engine, rng_host, probs)
        log({**lex_stats, "card": card})

    with phase("tokenizer_check", card, seconds):
        tok_stats = tokenizer_check(engine, texts, judged_prompts(engine, rng_host, probs))
        log({**tok_stats, "card": card})

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
            t0 = time.perf_counter()
            engine2.warmup()
            log({"reload_warmup_s": time.perf_counter() - t0})
            qs = bursts[16]
            for q, a, b in zip(qs, engine.search_batch(qs, TOP_K, use_reranker=False),
                               engine2.search_batch(qs, TOP_K, use_reranker=False)):
                ka = [(r.chunk_id, r.score, r.embedding_score, r.lexical_score) for r in a]
                kb = [(r.chunk_id, r.score, r.embedding_score, r.lexical_score) for r in b]
                same_topk(ka, kb, SCORE_TOL, f"reload {q!r}")
            log({"reload_checked": len(qs)})
            del engine2

        with phase("bf16_wide", card, seconds):
            wide = wide_batch(engine, dev, card, np.random.default_rng([args.seed, 11]), probs, "bf16")
        with phase("f32_wide", card, seconds):
            f32_wide = wide_batch(engine, dev, card, np.random.default_rng([args.seed, 12]), probs, "f32")
        int8 = run_int8(engine, batcher, dev, card, seconds, tmp, probs, args.seed)

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
            breakdown = stage_breakdown(engine, py_index, rng, probs)
            log({**breakdown, "card": card})
        del py_index

        rerank = run_rerank(engine, batcher, dev, card, seconds, rng, probs, tmp)

        with phase("add_duplicates", card, seconds):
            # the first N_DUPLICATES chunks once more: the same texts and
            # rows (add_chunks normalises the same encoder output again)
            dup = [ChunkMeta(id=str(uuid.UUID(int=int(rng_host.integers(2**63)) << 64 | i)),
                             document_name="duplicates", text=t, chunk_index=i)
                   for i, t in enumerate(texts[:N_DUPLICATES])]
            slots = engine.add_chunks(dup, embs[:N_DUPLICATES])
            corpus = engine.store.corpus()
            src = [engine.store.slot_for_id(m.id) for m in metas[:N_DUPLICATES]]
            if not torch.equal(corpus[slots], corpus[src]):
                raise AssertionError("add_duplicates: the duplicated rows differ from their sources")
            engine.warmup()
            log({"duplicates_added": len(slots), "live_chunks": len(engine.store)})
        mmr = run_mmr(engine, batcher, card, seconds, rng_host, probs, tmp, texts[:N_DUPLICATES])
        server = run_server(engine, card, seconds, tmp, pdfs, np.random.default_rng([args.seed, 10]), probs)
        with phase("trace", card, seconds):
            trace = run_trace(engine, batcher, card, tmp, np.random.default_rng([args.seed, 13]), probs,
                              server["entry_point"]["entry_capture"])
        with phase("sharded", card, seconds):
            sharded = run_sharded(engine, dev, card, tmp, args.seed, np.random.default_rng([args.seed, 14]), probs)
    finally:
        batcher.stop()
        engine.embedding_service.close()
    # the query batch the kernel saw most often on the main path
    padded = [p.out.shape[0] for _, p in recorded]
    return {"launches": launches, "latency": latency, "ingest": ingest, "breakdown": breakdown,
            "main_q": max(set(padded), key=padded.count), "rerank": rerank, "mmr": mmr,
            "lexical": lex_stats, "tokenizer": tok_stats, "server": server, "bf16_wide": wide,
            "f32_wide": f32_wide, "int8": int8, "pdfs": pdfs, "trace": trace, "sharded": sharded}


if __name__ == "__main__":
    sys.exit(main())
