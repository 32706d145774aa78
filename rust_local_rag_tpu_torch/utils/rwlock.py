"""Write-preferring reader-writer lock (the RwLock of
rust_local_rag_tpu/utils/rwlock.py): searches take the read side
together, ingest takes the write side."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


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
