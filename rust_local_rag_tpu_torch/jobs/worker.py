"""Worker supervisor: background reindex jobs with resume and poison-pill
handling (port of rust_local_rag_tpu/jobs/worker.py).

Thread-based equivalent of the reference's Tokio WorkerSupervisor
(worker.rs:116-572):
  * a queue of JobRequests consumed by a supervisor thread;
  * a worker semaphore (1 permit) bounding concurrent reindex jobs;
  * pending/inprogress jobs resumed from SQLite at startup;
  * per-document brief write locks so searches stay live during reindex;
  * poison-pill documents: a failing PDF is logged and skipped, failures are
    summarized into the completed job record (worker.rs:342-344,545-566);
  * batch-granular progress events through ProgressLogger.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from dataclasses import dataclass
from typing import List, Optional

from rust_local_rag_tpu_torch.jobs.job_manager import JobManager, JobStatus
from rust_local_rag_tpu_torch.jobs.progress_logger import (
    BatchProgress,
    ProgressLogger,
    ProgressState,
    Stage,
)
from rust_local_rag_tpu_torch.utils.rwlock import RwLock, timed_write_guard

logger = logging.getLogger(__name__)


@dataclass
class JobRequest:
    """StartReindex (worker.rs:106-112)."""

    job_id: str
    documents_dir: str


_SHUTDOWN = object()


class WorkerSupervisor:
    def __init__(
        self,
        job_manager: JobManager,
        engine,  # RagEngine
        engine_lock: RwLock,
        log_dir: str = "./logs",
        max_workers: int = 1,
    ):
        self.job_manager = job_manager
        self.engine = engine
        self.engine_lock = engine_lock
        self.log_dir = log_dir
        self.queue: "queue.Queue" = queue.Queue(maxsize=100)
        self._permits = threading.Semaphore(max_workers)
        self._threads: List[threading.Thread] = []
        self._supervisor: Optional[threading.Thread] = None
        self._stopping = threading.Event()

    # ----- lifecycle -----

    def start(self) -> None:
        self._resume_jobs()
        self._supervisor = threading.Thread(
            target=self._run, name="worker-supervisor", daemon=True
        )
        self._supervisor.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stopping.set()
        self.queue.put(_SHUTDOWN)
        if self._supervisor:
            self._supervisor.join(timeout)
        for t in list(self._threads):
            t.join(timeout)

    def submit(self, request: JobRequest) -> None:
        self.queue.put(request)

    def is_healthy(self) -> bool:
        """False only when the supervisor thread died UNEXPECTEDLY — the
        server watchdog escalates that to a shutdown (main.rs:183-215).
        An intentional stop() is healthy."""
        if self._stopping.is_set():
            return True
        return self._supervisor is not None and self._supervisor.is_alive()

    def _resume_jobs(self) -> None:
        """worker.rs:141-154"""
        try:
            jobs = self.job_manager.find_resumable_jobs()
        except Exception as e:  # noqa: BLE001
            logger.error("Failed to query resumable jobs: %s", e)
            return
        for job in jobs:
            logger.info(
                "Resuming job %s (status: %s) from restart",
                job.job_id,
                job.status.value,
            )
            if job.payload:
                self.queue.put(JobRequest(job.job_id, job.payload))

    def _run(self) -> None:
        while not self._stopping.is_set():
            request = self.queue.get()
            if request is _SHUTDOWN:
                break
            self._spawn_worker(request)

    def _spawn_worker(self, request: JobRequest) -> None:
        progress_logger: Optional[ProgressLogger]
        try:
            progress_logger = ProgressLogger(self.log_dir)
        except Exception as e:  # noqa: BLE001
            logger.error("Failed to create progress logger: %s", e)
            progress_logger = None

        # Wait for a permit — job stays queued until a worker frees up
        self._permits.acquire()
        t = threading.Thread(
            target=self._worker_main,
            args=(request, progress_logger),
            name=f"reindex-{request.job_id[:8]}",
            daemon=True,
        )
        # reap finished workers so the list doesn't grow unboundedly
        self._threads = [x for x in self._threads if x.is_alive()]
        self._threads.append(t)
        t.start()

    def _worker_main(
        self, request: JobRequest, progress_logger: Optional[ProgressLogger]
    ) -> None:
        job_id = request.job_id
        try:
            logger.info("Starting reindex job %s (acquired worker permit)", job_id)
            self.job_manager.update_status(job_id, JobStatus.IN_PROGRESS)
            self._reindex_documents(
                request.documents_dir, job_id, progress_logger
            )
            # _reindex_documents sets the final status (it may be Completed
            # with a failure summary)
        except Exception as e:  # noqa: BLE001
            logger.error("Job %s failed: %s", job_id, e)
            try:
                self.job_manager.update_status(job_id, JobStatus.FAILED, str(e))
            except Exception as ue:  # noqa: BLE001
                logger.error("Failed to mark job %s as failed: %s", job_id, ue)
        finally:
            self._permits.release()

    # ----- the reindex pipeline (worker.rs:279-572) -----

    def _discover_pdfs(self, documents_dir: str) -> List[str]:
        found: List[str] = []
        for root, _dirs, files in os.walk(documents_dir):
            for name in files:
                if name.lower().endswith(".pdf"):
                    found.append(os.path.join(root, name))
        found.sort()
        return found

    def _reindex_documents(
        self,
        documents_dir: str,
        job_id: str,
        progress_logger: Optional[ProgressLogger],
    ) -> None:
        pdf_paths = self._discover_pdfs(documents_dir)
        total_docs = len(pdf_paths)
        logger.info("Found %d PDF files to process", total_docs)

        self.job_manager.update_total(job_id, total_docs)
        self.job_manager.update_progress(job_id, 0)

        state = ProgressState(job_id=job_id, total_docs=total_docs)
        if progress_logger:
            progress_logger.emit(state, "stage", f"discovered {total_docs} PDFs")

        failed_documents: List[str] = []
        successful = 0

        state.stage = Stage.EMBEDDING
        if progress_logger:
            progress_logger.emit(state, "stage", "starting document embedding")

        for idx, path in enumerate(pdf_paths):
            filename = os.path.basename(path)
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError as e:
                # unreadable file = a failed document, not a silent skip:
                # record it and advance progress so the job can still reach
                # total and the completion summary reflects the failure
                logger.error("Failed to read %s: %s", filename, e)
                failed_documents.append(f"{filename}: {e}")
                state.failed_docs += 1
                state.done_docs = idx + 1
                state.last_doc = filename
                self.job_manager.update_progress(job_id, idx + 1)
                if progress_logger:
                    progress_logger.emit(state, "progress", "failed")
                continue

            logger.info(
                "Processing document %s (%d/%d)", filename, idx + 1, total_docs
            )

            def batch_callback(
                batch_idx: int,
                batch_count: int,
                total_chunks: int,
                chunks_in_batch: int,
                _filename=filename,
                _idx=idx,
            ) -> None:
                if progress_logger is None:
                    return
                snap = state.clone()
                snap.current_batch = batch_idx
                snap.total_batches = batch_count
                snap.current_chunks = total_chunks
                snap.last_doc = _filename
                snap.done_docs = _idx + 1
                progress_logger.emit_batch(
                    snap,
                    BatchProgress(
                        document_name=_filename,
                        batch_index=batch_idx,
                        batch_count=batch_count,
                        chunks_in_batch=chunks_in_batch,
                        total_chunks=total_chunks,
                    ),
                )

            try:
                with timed_write_guard(
                    self.engine_lock, f"add_document:{filename}"
                ):
                    chunk_count = self.engine.add_document(
                        filename, data, batch_callback=batch_callback
                    )
                successful += 1
                state.success_docs += 1
                if chunk_count > 0:
                    state.embedded_docs += 1
                    note = f"{chunk_count} chunks"
                else:
                    state.skipped_docs += 1
                    note = "0 chunks"
            except Exception as e:  # noqa: BLE001 — poison pill: keep going
                failed_documents.append(f"{filename}: {e}")
                state.failed_docs += 1
                note = "failed"
                logger.warning(
                    "Failed to process %s (%d/%d): %s. Continuing with "
                    "remaining documents.",
                    filename,
                    idx + 1,
                    total_docs,
                    e,
                )

            state.done_docs = idx + 1
            state.last_doc = filename
            state.current_batch = None
            state.total_batches = None
            state.current_chunks = None

            self.job_manager.update_progress(job_id, idx + 1)
            if progress_logger:
                progress_logger.emit(state, "progress", note)

        # finalize (worker.rs:509-524)
        state.stage = Stage.FINALIZE
        if progress_logger:
            progress_logger.emit(state, "stage", "finalizing reindex")
        with timed_write_guard(self.engine_lock, "finalize_reindex"):
            self.engine.finalize_reindex()

        # Touch every search lane over the new corpus (BM25 snapshots, first
        # launches) so the first real query pays none of it (read lock:
        # warmup only runs searches).
        try:
            with self.engine_lock.read():
                self.engine.warmup()
        except Exception as e:  # noqa: BLE001
            logger.warning("Post-reindex warmup failed (non-fatal): %s", e)

        if progress_logger:
            completion = (
                f"completed successfully - {total_docs} docs"
                if not failed_documents
                else f"completed with {len(failed_documents)} failures out of {total_docs}"
            )
            progress_logger.emit(state, "done", completion)

        if failed_documents:
            summary = (
                f"Job completed with {len(failed_documents)} failures out of "
                f"{total_docs} documents. Failed documents:\n"
                + "\n".join(failed_documents)
            )
            logger.warning("%s", summary)
            self.job_manager.update_status(job_id, JobStatus.COMPLETED, summary)
            logger.info(
                "Successfully processed %d/%d documents", successful, total_docs
            )
        else:
            self.job_manager.update_status(job_id, JobStatus.COMPLETED, None)
            logger.info("All %d documents processed successfully", total_docs)
