"""Write-preferring reader-writer lock with an instrumented write guard
(port of rust_local_rag_tpu/utils/rwlock.py): searches take the read side
together, ingest takes brief write locks. timed_write_guard logs a wait
over 100 ms at debug, warns when the lock is held past WRITE_LOCK_MAX_MS,
and records the longest hold in lock_metrics."""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager

logger = logging.getLogger(__name__)

# the reference's design contract for one write hold (worker.rs:13)
WRITE_LOCK_MAX_MS = 1000


class _LockMetrics:
    """The longest write hold seen, for tests (worker.rs:17-36)."""

    def __init__(self) -> None:
        self._max_held_ms = 0
        self._lock = threading.Lock()

    def reset(self) -> None:
        with self._lock:
            self._max_held_ms = 0

    def max_held_ms(self) -> int:
        with self._lock:
            return self._max_held_ms

    def record_held_ms(self, ms: int) -> None:
        with self._lock:
            if ms > self._max_held_ms:
                self._max_held_ms = ms


lock_metrics = _LockMetrics()


class RwLock:
    """Write-preferring reader-writer lock."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._writer or self._writers_waiting > 0:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            self._readers += 1
            return True

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers > 0:
                    remaining = (
                        None if deadline is None else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        return False
                    self._cond.wait(remaining)
                self._writer = True
                return True
            finally:
                self._writers_waiting -= 1

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    @contextmanager
    def read(self, timeout: float | None = None):
        if not self.acquire_read(timeout):
            raise TimeoutError("read lock timeout")
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self, timeout: float | None = None):
        if not self.acquire_write(timeout):
            raise TimeoutError("write lock timeout")
        try:
            yield
        finally:
            self.release_write()


@contextmanager
def timed_write_guard(lock: RwLock, context: str):
    """Instrumented write acquisition (worker.rs:41-104), with no timeout,
    as the jobs worker takes it."""
    wait_start = time.monotonic()
    lock.acquire_write()
    wait_ms = int((time.monotonic() - wait_start) * 1000)
    if wait_ms > 100:
        logger.debug("Write lock wait time: %d ms (%s)", wait_ms, context)
    held_start = time.monotonic()
    try:
        yield
    finally:
        held_ms = int((time.monotonic() - held_start) * 1000)
        lock_metrics.record_held_ms(held_ms)
        if held_ms > WRITE_LOCK_MAX_MS:
            logger.warning(
                "Write lock held beyond threshold: %d ms > %d ms (%s)",
                held_ms, WRITE_LOCK_MAX_MS, context,
            )
        else:
            logger.debug("Write lock released after %d ms (%s)", held_ms, context)
        lock.release_write()
