"""Reranker service: prompt building, batch scoring, fallback to initial
scores, latency calibration (port of
rust_local_rag_tpu/models/reranker_service.py).

Contract carried from the reference's RerankerService (reranker.rs:113-771):
  * prompt template from PROMPTS_DIR/reranker.txt when present, else a
    built-in yes/no template with {query} {document} {page} {section}
    {text} placeholders (build_prompt: page 0 renders as "unknown", an
    empty section as "N/A");
  * a failed scoring pass falls back to the candidates' initial scores;
    here failures are batch-granular since scoring is one device pass, and
    each fallback adds one to ``fallbacks``;
  * results sorted by relevance, descending;
  * calibrate_timeout: 2 warm-up passes, then timed samples; nearest-rank
    p95/p99 at index round(p * (N-1)).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from rust_local_rag_tpu_torch.config import get_prompts_dir, get_rerank_model
from rust_local_rag_tpu_torch.device import resolve_device
from rust_local_rag_tpu_torch.models.reranker import FakeReranker, TransformerReranker

logger = logging.getLogger(__name__)

DEFAULT_PROMPT_TEMPLATE = """Query: {query}
Document: {document}
Page: {page}

Chunk:
{text}

Judge relevance by meaning, not keyword overlap alone. Treat the chunk as
relevant when it answers the query directly, supplies definitions or context
the answer depends on, or contains information logically tied to the query.

Does this chunk contain relevant information for the query?
Answer:"""


@dataclass
class RerankerCandidate:
    """Mirror of reranker.rs:8-21."""

    chunk_id: str
    document: str
    text: str
    page_number: int
    section: Optional[str]
    initial_score: float


@dataclass
class RerankedResult:
    """Mirror of reranker.rs:27-39."""

    chunk_id: str
    relevance: float
    yes_logprob: Optional[float] = None
    no_logprob: Optional[float] = None


@dataclass
class CalibrationStats:
    """Mirror of reranker.rs:49-56."""

    mean_ms: float
    median_ms: float
    p95_ms: float
    p99_ms: float
    max_ms: float
    sample_size: int


def load_prompt_template() -> str:
    path = os.path.join(get_prompts_dir(), "reranker.txt")
    try:
        with open(path, "r", encoding="utf-8") as f:
            template = f.read()
        logger.info("Loaded reranker prompt from %s", path)
        return template
    except OSError:
        logger.info("Using default reranker prompt (no external file at %s)", path)
        return DEFAULT_PROMPT_TEMPLATE


class RerankerService:
    def __init__(self, model, prompt_template: Optional[str] = None):
        """`model` provides .score_prompts(prompts) -> [(score, yes_lp,
        no_lp)] and .model_name, and optionally the dispatch_prompts /
        fetch_prompts split (TransformerReranker has it)."""
        self._model = model
        self._template = prompt_template or load_prompt_template()
        self.fallbacks = 0  # rerank() passes answered with initial scores
        self._fallback_lock = threading.Lock()

    @property
    def model_name(self) -> str:
        return self._model.model_name

    def build_prompt(self, query: str, candidate: RerankerCandidate) -> str:
        page = "unknown" if candidate.page_number == 0 else str(candidate.page_number)
        section = (
            candidate.section.strip()
            if candidate.section and candidate.section.strip()
            else "N/A"
        )
        return (
            self._template.replace("{query}", query.strip())
            .replace("{document}", candidate.document)
            .replace("{page}", page)
            .replace("{section}", section)
            .replace("{text}", candidate.text.strip())
        )

    def score_prompts(self, prompts: Sequence[str]):
        """[(score, yes_lp, no_lp)] for many queries' prompts in one pass."""
        return self._model.score_prompts(list(prompts))

    def dispatch_prompts(self, prompts: Sequence[str]):
        """Queue the forward without fetching it; models without the split
        score here and the handle is the finished result."""
        if hasattr(self._model, "dispatch_prompts"):
            return self._model.dispatch_prompts(list(prompts))
        return self._model.score_prompts(list(prompts))

    def fetch_prompts(self, handle):
        if hasattr(self._model, "fetch_prompts"):
            return self._model.fetch_prompts(handle)
        return handle

    def rerank(self, query: str, candidates: Sequence[RerankerCandidate]) -> List[RerankedResult]:
        """Score all candidates in one pass; on failure fall back to their
        initial scores (counted in ``fallbacks``); sort by relevance."""
        if not candidates:
            return []
        t0 = time.perf_counter()
        prompts = [self.build_prompt(query, c) for c in candidates]
        t_build = time.perf_counter()
        try:
            scored = self._model.score_prompts(prompts)
        except Exception as e:  # noqa: BLE001 - the reference's contract: degrade to initial scores
            logger.warning("Reranker scoring failed, falling back to initial scores: %s", e)
            with self._fallback_lock:
                self.fallbacks += 1
            results = [RerankedResult(chunk_id=c.chunk_id, relevance=c.initial_score) for c in candidates]
        else:
            results = [
                RerankedResult(chunk_id=c.chunk_id, relevance=float(s), yes_logprob=y, no_logprob=n)
                for c, (s, y, n) in zip(candidates, scored)
            ]
            logger.debug(
                "rerank phases: build_prompts=%.1fms score=%.1fms (%d candidates)",
                (t_build - t0) * 1000.0, (time.perf_counter() - t_build) * 1000.0, len(candidates),
            )
        results.sort(key=lambda r: -r.relevance)
        return results

    def calibrate_timeout(
        self, query: str, candidates: Sequence[RerankerCandidate], sample_size: int
    ) -> CalibrationStats:
        """Scoring latency distribution (reranker.rs:605-699): each sample
        times a one-candidate batch, as the reference times one candidate."""
        sample_size = min(sample_size, len(candidates))
        if sample_size == 0:
            raise ValueError("No candidates provided for calibration")
        for c in candidates[: min(2, len(candidates))]:
            try:
                self._model.score_prompts([self.build_prompt(query, c)])
            except Exception:  # noqa: BLE001 - warm-up failures are retried by the samples
                pass
        durations_ms: List[float] = []
        for c in candidates[:sample_size]:
            start = time.perf_counter()
            try:
                self._model.score_prompts([self.build_prompt(query, c)])
            except Exception as e:  # noqa: BLE001 - a failed sample still counts its time
                logger.warning("Calibration sample failed: %s", e)
            durations_ms.append((time.perf_counter() - start) * 1000.0)
        durations_ms.sort()
        n = len(durations_ms)
        return CalibrationStats(
            mean_ms=sum(durations_ms) / n,
            median_ms=durations_ms[n // 2],
            p95_ms=durations_ms[min(round(0.95 * (n - 1)), n - 1)],
            p99_ms=durations_ms[min(round(0.99 * (n - 1)), n - 1)],
            max_ms=durations_ms[-1],
            sample_size=n,
        )


def build_default_reranker(device: str | torch.device = "cuda") -> Optional[RerankerService]:
    """The configured reranker (named by get_rerank_model()): the judge at
    RERANKER_WEIGHTS or the committed one (TransformerReranker.from_assets),
    or the hash FakeReranker when RAG_TPU_FAKE_RERANKER is set (hermetic
    mode); None when none is configured. The device is resolved before the
    judge is built, so a missing card raises; any other failure to build
    the judge is logged and gives None, as the JAX package catches every
    Exception there: the reference treats reranker start-up failure as
    non-fatal (rag_engine.rs:164-176)."""
    name = get_rerank_model()
    if not name:
        return None
    if os.environ.get("RAG_TPU_FAKE_RERANKER"):
        return RerankerService(FakeReranker(model_name=name))  # needs no device
    dev = resolve_device(device)
    try:
        return RerankerService(TransformerReranker.from_assets(model_name=name, device=dev))
    except Exception as e:  # noqa: BLE001
        logger.warning("Reranker unavailable, falling back to embedding scores only: %s", e)
        return None
