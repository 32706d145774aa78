"""Process entry of the port: `python -m rust_local_rag_tpu_torch` (port of
rust_local_rag_tpu/server/app.py).

The reference's main() (main.rs:140-242): .env, logging (a JSON file layer
and, in development, the console), the data and documents directories, the
log size cap, the engine (start-up fails on a bad encoder, as the reference
exits when Ollama is unreachable), the jobs system, HTTP + MCP, and a
graceful flush on shutdown with a 10 s lock timeout and a 5 s save budget.

In place of the JAX package's compilation cache and device round trip,
main builds every native library of the port (kernels/build.build_all:
the CUDA kernels with nvcc, the host libraries with g++) and runs
engine.warmup() and the serializer's fragment registration before it
binds, so /readyz answers 200 only when a query pays no build. It serves
on the card; RAG_TPU_PLATFORM=cpu is the caller's explicit ask for the
CPU (then only the host libraries are built).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
from typing import Optional

from rust_local_rag_tpu_torch import config

logger = logging.getLogger(__name__)


class JsonFormatter(logging.Formatter):
    """Structured JSON log lines (the reference's tracing-subscriber JSON
    layer, main.rs:80-82)."""

    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "timestamp": self.formatTime(record),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            entry["exception"] = self.formatException(record.exc_info)
        return json.dumps(entry, ensure_ascii=False)


def setup_logging() -> None:
    """main.rs:60-112: the JSON file layer always; the console in dev."""
    log_dir = config.get_log_dir()
    os.makedirs(log_dir, exist_ok=True)
    root = logging.getLogger()
    root.setLevel(getattr(logging, config.get_log_level().upper(), logging.INFO))
    fh = logging.FileHandler(os.path.join(log_dir, "rust-local-rag-tpu.log"))
    fh.setFormatter(JsonFormatter())
    root.addHandler(fh)
    if any(os.environ.get(k) is not None for k in ("DEVELOPMENT", "DEV", "CONSOLE_LOGS")):
        ch = logging.StreamHandler(sys.stdout)
        ch.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s"))
        root.addHandler(ch)
        logger.info("Development mode: logging to console AND file")
    logger.info("Logging initialized")
    logger.info("Log directory: %s", log_dir)


def start_log_cleanup_task(stop_event: threading.Event) -> threading.Thread:
    """Truncate the log file past LOG_MAX_MB, checked every 5 minutes
    (main.rs:114-138)."""
    max_bytes = config.get_log_max_mb() * 1024 * 1024
    log_file = os.path.join(config.get_log_dir(), "rust-local-rag-tpu.log")

    def loop() -> None:
        while not stop_event.wait(300):
            try:
                if os.path.getsize(log_file) > max_bytes:
                    with open(log_file, "w", encoding="utf-8") as f:
                        f.write(f"[LOG TRUNCATED - Size exceeded {config.get_log_max_mb()}MB]\n")
            except OSError:
                pass

    t = threading.Thread(target=loop, name="log-cleanup", daemon=True)
    t.start()
    return t


def build_runtime(data_dir: Optional[str] = None, documents_dir: Optional[str] = None, device="cuda"):
    """The engine (on `device`; raises without a card unless the CPU is
    asked for), its lock, the job manager, the worker supervisor and the
    app context over DATA_DIR and DOCUMENTS_DIR (or the given dirs)."""
    from rust_local_rag_tpu_torch.device import resolve_device
    from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine
    from rust_local_rag_tpu_torch.jobs.job_manager import JobManager
    from rust_local_rag_tpu_torch.jobs.worker import WorkerSupervisor
    from rust_local_rag_tpu_torch.server.http_api import AppContext
    from rust_local_rag_tpu_torch.utils.rwlock import RwLock

    resolve_device(device)  # refuse before touching a directory
    data_dir = data_dir or config.get_data_dir()
    documents_dir = documents_dir or config.get_documents_dir()
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(documents_dir, exist_ok=True)
    engine = RagEngine.create(data_dir, device=device)
    if engine.needs_reindex():
        logger.warning(
            "Embedding model changed to '%s'. Existing embeddings were cleared and a full "
            "reindex will be available via the start_reindex tool.",
            engine.embedding_model(),
        )
    job_db = os.path.join(data_dir, "jobs.db")
    job_manager = JobManager(job_db)
    logger.info("Job manager initialized with database at %s", job_db)
    lock = RwLock()
    supervisor = WorkerSupervisor(job_manager, engine, lock, log_dir=config.get_log_dir())
    return AppContext(engine, lock, job_manager, supervisor, documents_dir)


def graceful_flush(ctx) -> None:
    """Shutdown flush: 10 s lock timeout, 5 s save budget (main.rs:217-241)."""
    logger.info("Initiating graceful shutdown...")
    logger.info("Acquiring lock for flush (10s timeout)...")
    if not ctx.engine_lock.acquire_write(timeout=10.0):
        logger.error("Could not acquire lock within 10s. Exiting without save.")
        return
    try:
        logger.info("Lock acquired. Flushing state to disk (5s timeout)...")
        done = threading.Event()
        err: list = []

        def save() -> None:
            try:
                ctx.engine.save_to_disk()
            except Exception as e:  # noqa: BLE001 - reported below
                err.append(e)
            finally:
                done.set()

        threading.Thread(target=save, daemon=True).start()
        if not done.wait(5.0):
            logger.error("Save operation timed out after 5s")
        elif err:
            logger.error("Failed to save state: %s", err[0])
        else:
            logger.info("RAG state successfully saved to disk")
    finally:
        ctx.engine_lock.release_write()


def prepare(ctx) -> None:
    """What main does between build_runtime and bind: start the worker
    supervisor (resuming unfinished jobs), the profiler's capture listener
    when RAG_TPU_PROFILE_PORT names a port, warm every search lane, and
    register every chunk's response fragment."""
    ctx.supervisor.start()
    logger.info("Worker supervisor started")
    # Profiling hook (the JAX server starts jax.profiler's server here):
    # a loopback listener whose POST /capture takes a device trace of this
    # live server for the asked duration (utils/profiling.CaptureServer)
    profile_port = os.environ.get("RAG_TPU_PROFILE_PORT")
    if profile_port:
        try:
            from rust_local_rag_tpu_torch.utils.profiling import CaptureServer

            ctx.profiler = CaptureServer(int(profile_port), os.path.join(config.get_log_dir(), "traces"))
            logger.info("Profiler capture listener on port %s (POST /capture)", profile_port)
        except Exception as e:  # noqa: BLE001
            logger.warning("Profiler server failed to start: %s", e)
    ctx.engine.warmup()
    n = ctx.batcher.preregister_fragments()
    if n:
        logger.info("Preregistered %d response fragments", n)


def main(argv: Optional[list] = None) -> int:
    _load_dotenv()
    device = "cpu" if os.environ.get("RAG_TPU_PLATFORM") == "cpu" else "cuda"
    setup_logging()
    stop_event = threading.Event()
    start_log_cleanup_task(stop_event)
    logger.info("Started automatic log cleanup task (max: %dMB)", config.get_log_max_mb())

    from rust_local_rag_tpu_torch.device import resolve_device
    from rust_local_rag_tpu_torch.kernels import build

    try:
        resolve_device(device)  # before the build: without a card, say so
        names = tuple(build.SIGNATURES) if device == "cuda" else build.HOST_LIBRARIES
        for res in build.build_all(names).values():
            logger.info("Library %s ready (%.1f s)", res.name, res.seconds)
        ctx = build_runtime(device=device)
        prepare(ctx)
    except Exception as e:  # noqa: BLE001 - fail fast with a non-zero exit
        logger.error("Startup failed: %s", e)
        print(f"Startup failed: {e}", file=sys.stderr)
        stop_event.set()
        return 1
    logger.info("Data directory: %s", config.get_data_dir())
    logger.info("Documents directory: %s", config.get_documents_dir())
    logger.info("Embedding model: %s", ctx.engine.embedding_model())
    logger.info("Use start_reindex tool to begin document indexing")

    from rust_local_rag_tpu_torch.server.fastpath import HttpServer
    from rust_local_rag_tpu_torch.server.http_api import App

    bind = config.get_mcp_http_bind()
    host, _, port = bind.rpartition(":")
    logger.info("Starting MCP streamable HTTP server on http://%s%s", bind, config.get_mcp_http_endpoint())
    logger.info("HTTP evaluation endpoints: POST /search, GET /stats, POST /reindex, "
                "GET /jobs/active, GET /jobs/:id")
    try:
        HttpServer(App(ctx), host or "127.0.0.1", int(port)).run()
    except KeyboardInterrupt:
        pass
    finally:
        stop_event.set()
        if ctx.profiler is not None:
            ctx.profiler.close()
        ctx.supervisor.stop()
        ctx.batcher.stop()
        graceful_flush(ctx)
        logger.info("MCP server shut down gracefully")
    return 0


def _load_dotenv(path: str = ".env") -> None:
    """Minimal dotenv: KEY=VALUE lines, # comments, no overrides."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                key, _, val = line.partition("=")
                key, val = key.strip(), val.strip().strip("\"'")
                if key and key not in os.environ:
                    os.environ[key] = val
    except OSError:
        pass
