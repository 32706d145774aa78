"""A reindex from empty: documents of passages, one after another, through
EmbeddingService.embed_in_batches and RagEngine.add_chunks, the back half
of RagEngine.add_document without PDF extraction and without the save to
disk a document (a full save each time would write far more than a run
may).

Set-up: the empty engine, the passage stream, and the encoder run once at
every (batch bucket, length bucket) that the stream's documents form in
embed_in_batches. The window: documents whose sizes cycle through a
fixed multiset (`gen.document_sizes`, in an order drawn from the seed),
each document's passages the next of the stream. Chunks count when their
document has been indexed within the window. After the window, the rows
of a sample of the indexed chunks (drawn from the seed, with the longest
passage) and the lexical index's hits for sampled queries are read from
the program, the program is freed, and the reference judges both.
"""

from __future__ import annotations

import gc
import tempfile
import time

import numpy as np
import torch

from harness import gen, program, trace as tracing
from harness.probes import Probes
from harness.record import Record, device_info
from harness.runner import asset
from harness.work import transformer_flops
from reference import models
from reference.bm25 import Bm25
from reference.ingest import bm25_numbers, embed_documents, row_gap
from reference.tokenizer import WordPieceTokenizer, bucket_batch, bucket_length


class Stream:
    """What a seed makes for an ingest cell: the vocabulary, the sizes of
    a cycle of documents, and enough passages for a window of `seconds`
    at the traffic's max_rate."""

    def __init__(self, cell, seed: int, seconds: float):
        cfg, traffic = cell.config, cell.traffic
        self.tok = WordPieceTokenizer(asset("tokenizer.json"))
        self.vocab = gen.vocabulary(self.tok, gen.vocabulary_size(cfg))
        self.sizes = gen.document_sizes(traffic["passages_per_document"], seed)
        self.n = int(traffic["max_rate"] * seconds) + int(self.sizes.max())
        self.passages = gen.corpus(self.vocab, cfg["corpus"], self.n, seed)
        self.pieces = self.vocab.tokens(self.passages)
        self.prefix = len(self.tok.tokenize(models.metadata(asset("encoder.safetensors")).get(
            "document_prefix", ""))) - 2

    def tokens(self, i) -> np.ndarray:
        """Encoder tokens of passages `i` ([CLS], prefix, text, [SEP]),
        as the tokenizer truncates them."""
        return np.minimum(self.pieces[i] + 2 + self.prefix, self.tok.max_len)

    def text_tokens(self, text: str) -> int:
        """Encoder tokens of a passage's text."""
        return min(self.vocab.text_pieces(text) + 2 + self.prefix, self.tok.max_len)

    def sample(self, indexed: int, rows: int, seed: int) -> list:
        """`rows` passages among the first `indexed`, drawn from the seed,
        with the longest among them."""
        g = gen.rng(seed, gen.SAMPLE)
        pick = set(g.choice(indexed, size=min(rows - 1, indexed), replace=False).tolist())
        return sorted(pick | {int(np.argmax(self.pieces[:indexed]))})

    def shapes(self, batch_size: int) -> list:
        """Every (batch bucket, length bucket) that embed_in_batches forms
        from the stream's documents: a document of up to batch_size texts
        is one batch; a longer one is sorted by the texts' length in
        characters and cut into batches of batch_size."""
        reps = -(-self.n // int(self.sizes.sum())) + 1
        sizes = np.tile(self.sizes, reps)
        ends = np.cumsum(sizes)
        sizes = sizes[ends <= self.n]
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        tokens = self.tokens(np.arange(self.n))
        out = set()
        small = sizes <= batch_size
        longest = np.maximum.reduceat(tokens, starts) if len(starts) else np.zeros(0, np.int64)
        for size, most in set(zip(sizes[small].tolist(), longest[small].tolist())):
            out.add((bucket_batch(size), bucket_length(most)))
        for start, size in zip(starts[~small].tolist(), sizes[~small].tolist()):
            doc = sorted(range(start, start + size), key=lambda i: len(self.passages.texts[i]))
            for lo in range(0, size, batch_size):
                part = doc[lo:lo + batch_size]
                out.add((bucket_batch(len(part)), bucket_length(int(tokens[part].max()))))
        return sorted(out)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t_process: float,
        fault=None) -> Record:
    cfg, traffic = cell.config, cell.traffic
    program.apply_settings(cfg["settings"])
    models.full_precision()
    x = Stream(cell, seed, seconds)
    tok, vocab, sizes, n, passages = x.tok, x.vocab, x.sizes, x.n, x.passages
    enc_meta_path = asset("encoder.safetensors")
    ids = [f"{cfg['id_prefix']}{i}" for i in range(n)]
    documents = [cfg["document_name"].format(i=i) for i in range(n)]

    with tempfile.TemporaryDirectory() as data_dir:
        engine = program.build_engine(cfg, data_dir, device)
        svc = engine.embedding_service
        enc_cfg = models.load_config(enc_meta_path, "encoder_config")
        warmed = warm_encoder(svc, x, seed, program.embed_batch_size())
        probes = Probes({"engine": engine, "service": svc, "encoder_cfg": enc_cfg, "tokens_of": x.text_tokens})
        if trace:
            for m in cell.per_layer:
                for spec in getattr(m.module, "PROBES", []):
                    probes.add(spec)
        if fault is not None:
            program.plant_fault(engine, fault)
        try:
            before = program.counters(engine, None)
            window = tracing.SubWindow(probes, trace, traffic.get("profile_seconds", 3.0), seconds)
            t_start = time.monotonic()
            stop = t_start + seconds
            window.start(t_start)
            done, started, pos, k = 0, 0, 0, 0
            while time.monotonic() < stop:
                window.poll()
                size = int(sizes[k % len(sizes)])
                k += 1
                if pos + size > n:
                    raise RuntimeError("the passage stream ran out; raise max_rate")
                texts = passages.texts[pos:pos + size]
                emb = svc.embed_in_batches(texts)
                program.add_chunks(engine, ids[pos:pos + size], documents[pos:pos + size], texts, [1] * size, emb)
                started += 1
                pos += size
                if time.monotonic() <= stop:
                    done = pos
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            after = program.counters(engine, None)
            profiled = window.finish()
            peak = device_info(device, cell.chips)
            indexed = len(engine.store)
            sample = x.sample(pos, int(traffic["sample_rows"]), seed)
            written = program.slab_rows(engine, [ids[i] for i in sample]).cpu() if indexed else None
            qs = gen.queries(vocab, cfg["queries"], int(traffic["sample_queries"]), seed)
            limit = int(traffic["lexical_limit"])
            index_of = {cid: i for i, cid in enumerate(ids[:pos])}
            hits = [[(index_of[c], s) for c, s in program.lexical_hits(engine, q, limit)] for q in qs.texts]
        finally:
            probes.remove()
            svc.close()
        del engine, svc
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    rec = Record(window_s=seconds, attempted=started, failed=0, completed=done, setup_s=t_start - t_process,
                 probes=probes, counters={k: after[k] - before[k] for k in before}, trace=profiled,
                 info={"device": peak, "ingest": True, "warmed": warmed})
    if profiled is not None:
        rec.summary = tracing.summarize(profiled)
    rec.flops = float(sum(transformer_flops(enc_cfg, int(m), head=int(enc_cfg["out_dim"]))
                          for m in x.tokens(np.arange(done))))
    encoder = models.load(enc_meta_path, "encoder_config", device)
    reference_rows = embed_documents(encoder, tok, [passages.texts[i] for i in sample], device,
                                     gen.slab_dtype(cfg)).cpu()
    index = Bm25(passages.ids[:passages.offsets[pos]], passages.offsets[:pos + 1], len(vocab))
    worst = {"bm25_score_gap": 0.0, "bm25_choice_gap": 0.0, "short_hit_lists": 0.0}
    for j, h in enumerate(hits):
        nums = bm25_numbers(index, qs.words(j), h, limit)
        worst["short_hit_lists"] += nums["short"]
        worst["bm25_score_gap"] = max(worst["bm25_score_gap"], nums["score_gap"])
        worst["bm25_choice_gap"] = max(worst["bm25_choice_gap"], nums["choice_gap"])
    worst["row_gap"] = row_gap(written, reference_rows) if written is not None else float("inf")
    worst["missing_chunks"] = float(pos - indexed)
    rec.numbers = worst
    on_card = device.type == "cuda"
    rec.checks = {
        "attention_launches": rec.counters["attention_launches"] > 0 or not on_card,
        "score_segmax_launches": rec.counters["score_segmax_launches"] == 0,
        "rerank_fallbacks": rec.counters["rerank_fallbacks"] == 0,
    }
    rec.lines = {"lanes": {"counters": rec.counters, "documents": started, "chunks_indexed": indexed,
                           "warmed": warmed, "checks": rec.checks}}
    return rec


def warm_encoder(svc, x: Stream, seed: int, batch_size: int) -> list:
    """embed_texts once at every (batch bucket, length bucket) of the
    stream (Stream.shapes): rows of one-piece words, the longest just
    filling its bucket."""
    g = gen.rng(seed, gen.WARM)
    warmed = []
    for batch, length in x.shapes(batch_size):
        words = length - 2 - x.prefix
        texts = [" ".join(x.vocab.words[g.integers(0, x.vocab.n_whole, words)]) for _ in range(batch)]
        svc.embed_texts(texts)
        warmed.append([batch, length])
    return warmed
