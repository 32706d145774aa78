"""Machine-parsable progress log (port of
rust_local_rag_tpu/jobs/progress_logger.py: the same lines in
progress_tracking.log).

Emits the reference's exact key=value line schema
(progress_logger.rs:132-225): ts, job, event, stage, done/total/success/
failed/skipped/embedded counters, pct, dps, eta_s, URL-encoded last_doc and
note, plus batch-granular events during embedding.
"""

from __future__ import annotations

import os
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


class Stage(str, Enum):
    DISCOVER = "discover"
    EMBEDDING = "embedding"
    FINALIZE = "finalize"


@dataclass
class BatchProgress:
    document_name: str
    batch_index: int
    batch_count: int
    chunks_in_batch: int
    total_chunks: int


@dataclass
class ProgressState:
    job_id: str
    total_docs: int
    stage: Stage = Stage.DISCOVER
    done_docs: int = 0
    success_docs: int = 0
    failed_docs: int = 0
    skipped_docs: int = 0   # hash-match skips
    embedded_docs: int = 0  # actually embedded
    last_doc: Optional[str] = None
    started: float = field(default_factory=time.monotonic)
    current_batch: Optional[int] = None
    total_batches: Optional[int] = None
    current_chunks: Optional[int] = None

    def docs_per_sec(self) -> float:
        elapsed = time.monotonic() - self.started
        if elapsed > 0.0 and self.done_docs > 0:
            return self.done_docs / elapsed
        return 0.0

    def eta_seconds(self) -> int:
        dps = self.docs_per_sec()
        if dps > 0.0:
            return int((self.total_docs - self.done_docs) / dps)
        return 0

    def percent(self) -> int:
        if self.total_docs > 0:
            return (self.done_docs * 100) // self.total_docs
        return 0

    def clone(self) -> "ProgressState":
        return ProgressState(
            job_id=self.job_id,
            total_docs=self.total_docs,
            stage=self.stage,
            done_docs=self.done_docs,
            success_docs=self.success_docs,
            failed_docs=self.failed_docs,
            skipped_docs=self.skipped_docs,
            embedded_docs=self.embedded_docs,
            last_doc=self.last_doc,
            started=self.started,
            current_batch=self.current_batch,
            total_batches=self.total_batches,
            current_chunks=self.current_chunks,
        )


class ProgressLogger:
    """Append-only key=value event log (`progress_tracking.log`)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "progress_tracking.log")
        self._lock = threading.Lock()

    def _write(self, line: str) -> None:
        with self._lock:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line)
                f.flush()

    def emit(
        self, state: ProgressState, event: str, note: Optional[str] = None
    ) -> None:
        """Event types: progress | stage | done | error | batch."""
        ts = int(time.time() * 1000)
        last_doc = urllib.parse.quote(state.last_doc or "")
        note_enc = urllib.parse.quote(note or "")
        batch_info = ""
        if state.current_batch is not None and state.total_batches is not None:
            batch_info = (
                f" current_batch={state.current_batch}"
                f" total_batches={state.total_batches}"
            )
        line = (
            f"ts={ts} job={state.job_id} event={event} stage={state.stage.value} "
            f"done={state.done_docs} total={state.total_docs} "
            f"success={state.success_docs} failed={state.failed_docs} "
            f"skipped={state.skipped_docs} embedded={state.embedded_docs} "
            f"pct={state.percent()} dps={state.docs_per_sec():.2f} "
            f"eta_s={state.eta_seconds()} last_doc={last_doc} "
            f"note={note_enc}{batch_info}\n"
        )
        self._write(line)

    def emit_batch(self, state: ProgressState, batch: BatchProgress) -> None:
        ts = int(time.time() * 1000)
        doc_enc = urllib.parse.quote(batch.document_name)
        batch_pct = (
            (batch.batch_index * 100) // batch.batch_count
            if batch.batch_count > 0
            else 0
        )
        line = (
            f"ts={ts} job={state.job_id} event=batch stage=embedding "
            f"done={state.done_docs} total={state.total_docs} "
            f"success={state.success_docs} failed={state.failed_docs} "
            f"skipped={state.skipped_docs} embedded={state.embedded_docs} "
            f"pct={state.percent()} last_doc={doc_enc} "
            f"current_batch={batch.batch_index} "
            f"total_batches={batch.batch_count} batch_pct={batch_pct} "
            f"total_chunks={batch.total_chunks} "
            f"chunks_in_batch={batch.chunks_in_batch} "
            f"note=batch%20{batch.batch_index}/{batch.batch_count}%20complete\n"
        )
        self._write(line)
