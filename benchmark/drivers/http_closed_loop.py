"""Served search under closed-loop keep-alive HTTP clients.

Set-up: the configuration's corpus (texts by Zipf, rows drawn on the
device) through RagEngine.add_chunks, the server on a free loopback port,
every batch size the batcher can form (powers of two up to its maximum)
run once through the lane the body takes, then the clients' own warm-up
requests. The window: `clients` connections of the load generator (a
process pinned to a quarter of the cores), each sending the next distinct
query as soon as its answer arrives. After the window the program is
freed and the reference judges a sample of the answers, drawn from the
seed among every request the window sent, with the longest query among
them.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

from harness import gen, program, trace as tracing
from harness.probes import Probes
from harness.record import Record, device_info
from harness.runner import ROOT, asset
from reference import models
from reference.bm25 import Bm25
from reference.search import Corpus, Reference, lane_for
from reference.tokenizer import WordPieceTokenizer

CLIENT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "harness", "client.py")
CHUNK_BLOCK = 65536


def core_split():
    """(server cores, client cores): a quarter of the cores (at least one)
    for the load generator, the rest for the server."""
    cores = sorted(os.sched_getaffinity(0))
    n_client = max(1, len(cores) // 4) if len(cores) > 1 else 0
    return cores[:len(cores) - n_client] or cores, cores[len(cores) - n_client:] or cores


def lane_batches(max_batch: int):
    b = 1
    while b <= max_batch:
        yield b
        b *= 2


@dataclass
class Inputs:
    """What a seed makes for a search cell: the corpus (texts, rows, ids,
    documents, pages), the window's queries and the warm-up queries."""

    tok: WordPieceTokenizer
    vocab: gen.Vocabulary
    texts: gen.Texts
    rows: np.ndarray
    ids: list
    documents: list
    pages: list
    queries: gen.Texts
    warm: gen.Texts


def make_inputs(cell, seed: int, seconds: float, device) -> Inputs:
    cfg, traffic = cell.config, cell.traffic
    tok = WordPieceTokenizer(asset("tokenizer.json"))
    vocab = gen.vocabulary(tok, gen.vocabulary_size(cfg))
    n = int(cfg["corpus"]["documents"])
    dim = int(models.load_config(asset("encoder.safetensors"), "encoder_config")["out_dim"])
    rows = gen.rows(n, dim, seed, device).cpu().numpy()
    n_warm = int(cfg["settings"]["RAG_TPU_BATCH_MAX"]) * 2 + 2 * int(traffic["clients"])
    return Inputs(tok, vocab, gen.corpus(vocab, cfg["corpus"], n, seed), rows,
                  [f"{cfg['id_prefix']}{i}" for i in range(n)], [cfg["document_name"].format(i=i) for i in range(n)],
                  [1] * n, gen.queries(vocab, cfg["queries"], int(traffic["max_rate"] * seconds) + 64, seed),
                  gen.queries(vocab, cfg["queries"], n_warm, seed, stream=gen.WARM))


def load_judge(cfg: dict, device):
    """The reference's judge: `load(device)` of the module under
    benchmark/reference/ that the configuration's judge names."""
    name = cfg["judge"]["reference"]
    if not name.isidentifier():
        raise ValueError(f"the judge's reference {name!r} is no module name")
    return importlib.import_module("reference." + name).load(device)


def make_reference(x: Inputs, cfg: dict, device, judge: bool, fp8: bool = False,
                   corpus: Corpus = None) -> Reference:
    corpus = corpus or Corpus(rows=stored_rows(x.rows, cfg, device), bm25=Bm25(x.texts.ids, x.texts.offsets,
                                                                               len(x.vocab)),
                              texts=x.texts.texts, ids=x.ids, documents=x.documents, pages=x.pages)
    return Reference(corpus, models.load(asset("encoder.safetensors"), "encoder_config", device), x.tok,
                     load_judge(cfg, device) if judge else None, template(), fp8=fp8, ties=cfg.get("ties"))


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_process: float,
        fault=None) -> Record:
    server_cores, client_cores = core_split()
    affinity = os.sched_getaffinity(0)
    os.sched_setaffinity(0, server_cores)  # this thread and every thread it starts from here
    try:
        return _run(cell, seed, seconds, trace, device, t_process, fault, client_cores)
    finally:
        os.sched_setaffinity(0, affinity)


def _run(cell, seed, seconds, trace, device, t_process, fault, client_cores) -> Record:
    cfg, traffic = cell.config, cell.traffic
    program.apply_settings(cfg["settings"])
    models.full_precision()
    x = make_inputs(cell, seed, seconds, device)
    n = len(x.ids)
    body = traffic["body"]
    max_batch = int(cfg["settings"]["RAG_TPU_BATCH_MAX"])

    with tempfile.TemporaryDirectory() as data_dir:
        engine = program.build_engine(cfg, data_dir, device)
        for lo in range(0, n, CHUNK_BLOCK):
            hi = min(n, lo + CHUNK_BLOCK)
            program.add_chunks(engine, x.ids[lo:hi], x.documents[lo:hi], x.texts.texts[lo:hi], x.pages[lo:hi],
                               x.rows[lo:hi])
        server = program.serve(engine, data_dir)
        probes = Probes({"engine": engine, "service": engine.embedding_service, "judge": engine.reranker})
        try:
            engine.warmup()
            server.ctx.batcher.preregister_fragments()
            warmed = []
            for b in lane_batches(max_batch):
                program.run_lane(engine, body, x.warm.texts[:b])
                warmed.append(b)
            if engine.reranker is not None:
                probes.add({"kind": "count", "name": "judge_forwards",
                            "targets": ["judge.score_prompts", "judge.dispatch_prompts"],
                            "fn": lambda a, kw: 1 if len(a[0]) else 0})
            if trace:
                for m in cell.per_layer:
                    for spec in getattr(m.module, "PROBES", []):
                        probes.add(spec)
            if fault is not None:
                program.plant_fault(engine, fault)
            out, rec = window_run(server.port, traffic, body, x.queries.texts, x.warm.texts[max_batch:], seconds,
                                  client_cores, probes, engine, server, trace)
            rec.info["device"] = device_info(device, cell.chips)
        finally:
            probes.remove()
            server.stop()
            engine.embedding_service.close()
        live = len(engine.store)
        dim = engine.embedding_service.dim
        has_judge = engine.reranker is not None
        del engine, server
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    rec.setup_s = out["t_start"] - t_process
    keep = sample_indices(x.queries, [r[0] for r in out["records"]], traffic, seed)
    lane = lane_for(body, cfg["weights"], has_judge)
    reference = make_reference(x, cfg, device, lane.use_reranker)
    judge_numbers(rec, reference, lane, x.queries, keep, out["bodies"])
    rec.flops = step_flops(rec, reference, lane, x.vocab, x.queries, live, dim)
    rec.info.update(live_rows=live, dim=dim, warmed=warmed)
    counts = rec.counters
    on_card = device.type == "cuda"
    forwards = probes.counts.get("judge_forwards", 0.0)
    fused = cfg["settings"].get("RAG_TPU_FUSED_ATTN") == "1"
    rec.checks = {
        "score_segmax_launches": counts["score_segmax_launches"] > 0 or not on_card,
        "judge_forwards": forwards > 0 if lane.use_reranker else forwards == 0,
        "attention_launches": (counts["attention_launches"] > 0) == (fused and on_card),
        "judged_fallbacks": counts["judged_fallbacks"] == 0,
        "rerank_fallbacks": counts["rerank_fallbacks"] == 0,
        "queries_left": not out["exhausted"],
    }
    rec.lines["lanes"] = {"counters": counts, "judge_forwards": forwards, "warmed_batches": warmed,
                          "batch_max": max_batch, "clients": traffic["clients"], "checks": rec.checks}
    return rec


def sample_indices(queries, sent, traffic: dict, seed: int) -> list:
    """traffic["sample"] of the requests `sent` (query indices), drawn from
    the seed, with the longest query among them."""
    sent = np.asarray(sorted(sent), dtype=np.int64)
    if not len(sent):
        return []
    g = gen.rng(seed, gen.SAMPLE)
    pick = set(sent[g.choice(len(sent), size=min(int(traffic["sample"]) - 1, len(sent)), replace=False)].tolist())
    pick.add(int(sent[np.argmax(np.diff(queries.offsets)[sent])]))
    return sorted(pick)


def window_run(port, traffic, body, queries, warm, seconds, client_cores, probes, engine, server, trace):
    """Run the clients; -> (the client's output, the Record of the window).
    The client prints the window's start on a line of its own; the counters
    and the probes' window start there, after its warm-up requests."""
    spec = {"port": port, "conns": traffic["clients"], "seconds": seconds, "body": body, "queries": queries,
            "warm": warm}
    proc = subprocess.Popen([sys.executable, CLIENT], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                            preexec_fn=lambda: os.sched_setaffinity(0, client_cores))
    watcher = tracing.SubWindow(probes, trace, traffic.get("profile_seconds", 3.0), seconds)
    try:
        proc.stdin.write(json.dumps(spec))
        proc.stdin.close()
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError("the load generator ended before its window")
        before = program.counters(engine, server)
        watcher.start(json.loads(line)["t_start"])
        watcher.sleep_through()
        raw = proc.stdout.read()
        proc.wait(timeout=seconds + 600)
        after = program.counters(engine, server)
        profiled = watcher.finish()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"the load generator exited {proc.returncode}")
    out = json.loads(raw)
    t0, stop = out["t_start"], out["t_stop"]
    lats, done, failed = [], [], 0
    for i, sent, lat in out["records"]:
        lats.append(float("inf") if lat is None else lat * 1e3)
        failed += lat is None
        if lat is not None and sent + lat <= stop:
            done.append(i)
    rec = Record(window_s=stop - t0, attempted=len(out["records"]), failed=failed, completed=len(done), setup_s=0.0,
                 probes=probes, counters={k: after[k] - before[k] for k in before}, latencies_ms=lats,
                 window_work=len(out["records"]) - failed, trace=profiled, info={"done_idx": done})
    if profiled is not None:
        rec.summary = tracing.summarize(profiled)
    return out, rec


def stored_rows(rows: np.ndarray, cfg: dict, device) -> torch.Tensor:
    """The rows as the slab stores them: normalised, in its dtype."""
    x = torch.from_numpy(rows).to(device).double()
    return (x / x.norm(dim=1, keepdim=True)).to(gen.slab_dtype(cfg))


def template() -> str:
    """The judge's prompt template, the raw file the server reads."""
    with open(os.path.join(ROOT, "prompts", "reranker.txt"), encoding="utf-8") as f:
        return f.read()


def judge_numbers(rec: Record, reference: Reference, lane, queries, keep, bodies: dict) -> None:
    """The worst of each number over the sampled answers; an answer that
    never came, or came without its results, is short."""
    q = reference.embed_queries([queries.texts[i] for i in keep])
    worst = {"score_gap": 0.0, "choice_gap": 0.0, "short_answers": 0.0}
    if lane.use_reranker:
        worst["judge_gap"] = worst["blend_gap"] = 0.0
    for j, i in enumerate(keep):
        raw = bodies.get(str(i))
        try:
            results = json.loads(raw)["results"] if raw is not None else None
        except (ValueError, KeyError, TypeError):
            results = None
        if results is None:
            worst["short_answers"] += 1
            continue
        nums = reference.judge_answer(queries.texts[i], queries.words(i), q[j], lane, results)
        worst["short_answers"] += nums.pop("short")
        where = nums.pop("where")
        if nums["choice_gap"] > worst["choice_gap"]:
            rec.lines["worst_choice"] = {"request": i, "gap": nums["choice_gap"], "where": where,
                                         "served": [r.get("chunk_id") for r in results]}
        for k, v in nums.items():
            if k in worst:
                worst[k] = max(worst[k], v)
    worst["failed_requests"] = float(rec.failed)
    rec.numbers = worst
    rec.info["sampled"] = len(keep)


def step_flops(rec: Record, reference: Reference, lane, vocab, queries, live: int, dim: int) -> float:
    """Model operations of the requests answered within the window: the
    dense scores (2 live dim), the query encoder at each query's
    WordPiece tokens,
    and with the judge 3 * pool prompts at the judged prompts' mean
    length."""
    from harness import work

    enc = reference.encoder
    prefix = len(reference.tok.tokenize(reference.query_prefix)) - 2
    lens = vocab.tokens(queries)
    if lane.use_reranker:
        judged = reference.judged_tokens
        per_prompt = reference.judge_model.prompt_flops(round(sum(judged) / max(len(judged), 1)), work)
    total = 0.0
    for i in rec.info.pop("done_idx"):
        total += 2.0 * live * dim + work.transformer_flops(enc.cfg, int(lens[i]) + 2 + prefix,
                                                          head=int(enc.cfg["out_dim"]))
        if lane.use_reranker:
            total += 3 * lane.pool * per_prompt
    return total
