"""SQLite-persisted job queue (port of rust_local_rag_tpu/jobs/job_manager.py,
the same schema, so one jobs.db reads the same in both packages).

Contract carried from the reference's JobManager (job_manager.rs:54-241):
  * WAL journal mode, 30 s busy timeout, synchronous=NORMAL;
  * jobs table schema: job_id PK, status, job_type, payload, progress,
    total, error, started_at, updated_at + an index on status;
  * statuses pending/inprogress/completed/failed (lowercase TEXT);
  * create_reindex_job_if_not_active performs check-and-create atomically in
    one BEGIN IMMEDIATE transaction so concurrent callers race safely
    (job_manager.rs:197-241, race-tested at :410-490);
  * find_resumable_jobs returns pending + inprogress for crash resume.
"""

from __future__ import annotations

import sqlite3
import time
import uuid
from dataclasses import dataclass
from enum import Enum
from typing import List, Optional


class JobStatus(str, Enum):
    PENDING = "pending"
    IN_PROGRESS = "inprogress"
    COMPLETED = "completed"
    FAILED = "failed"


class JobType(str, Enum):
    REINDEX = "reindex"


@dataclass
class Job:
    job_id: str
    status: JobStatus
    job_type: JobType
    payload: Optional[str]
    progress: int
    total: int
    error: Optional[str]
    started_at: int
    updated_at: int

    def to_dict(self) -> dict:
        return {
            "job_id": self.job_id,
            "status": self.status.value,
            "job_type": self.job_type.value,
            "payload": self.payload,
            "progress": self.progress,
            "total": self.total,
            "error": self.error,
            "started_at": self.started_at,
            "updated_at": self.updated_at,
        }


_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id TEXT PRIMARY KEY NOT NULL,
    status TEXT NOT NULL,
    job_type TEXT NOT NULL,
    payload TEXT,
    progress INTEGER NOT NULL DEFAULT 0,
    total INTEGER NOT NULL DEFAULT 0,
    error TEXT,
    started_at INTEGER NOT NULL,
    updated_at INTEGER NOT NULL
)
"""


class JobManager:
    def __init__(self, db_path: str):
        self.db_path = db_path
        con = self._connect()
        try:
            con.execute(_SCHEMA)
            con.execute(
                "CREATE INDEX IF NOT EXISTS idx_jobs_status ON jobs(status)"
            )
            con.commit()
        finally:
            con.close()

    def _connect(self) -> sqlite3.Connection:
        con = sqlite3.connect(self.db_path, timeout=30.0)  # 30 s busy wait
        con.execute("PRAGMA journal_mode=WAL")
        con.execute("PRAGMA synchronous=NORMAL")
        con.row_factory = sqlite3.Row
        return con

    @staticmethod
    def _row_to_job(row: sqlite3.Row) -> Job:
        return Job(
            job_id=row["job_id"],
            status=JobStatus(row["status"]),
            job_type=JobType(row["job_type"]),
            payload=row["payload"],
            progress=int(row["progress"]),
            total=int(row["total"]),
            error=row["error"],
            started_at=int(row["started_at"]),
            updated_at=int(row["updated_at"]),
        )

    def create_job(
        self, job_type: JobType, payload: Optional[str], total: int
    ) -> Job:
        job_id = str(uuid.uuid4())
        now = int(time.time())
        con = self._connect()
        try:
            con.execute(
                "INSERT INTO jobs (job_id, status, job_type, payload, total, "
                "started_at, updated_at) VALUES (?, ?, ?, ?, ?, ?, ?)",
                (job_id, JobStatus.PENDING.value, job_type.value, payload, total, now, now),
            )
            con.commit()
            row = con.execute(
                "SELECT * FROM jobs WHERE job_id = ?", (job_id,)
            ).fetchone()
            return self._row_to_job(row)
        finally:
            con.close()

    def get_job(self, job_id: str) -> Optional[Job]:
        con = self._connect()
        try:
            row = con.execute(
                "SELECT * FROM jobs WHERE job_id = ?", (job_id,)
            ).fetchone()
            return self._row_to_job(row) if row else None
        finally:
            con.close()

    def update_status(
        self, job_id: str, status: JobStatus, error: Optional[str] = None
    ) -> None:
        con = self._connect()
        try:
            con.execute(
                "UPDATE jobs SET status = ?, error = ?, updated_at = ? "
                "WHERE job_id = ?",
                (status.value, error, int(time.time()), job_id),
            )
            con.commit()
        finally:
            con.close()

    def update_progress(self, job_id: str, progress: int) -> None:
        con = self._connect()
        try:
            con.execute(
                "UPDATE jobs SET progress = ?, updated_at = ? WHERE job_id = ?",
                (progress, int(time.time()), job_id),
            )
            con.commit()
        finally:
            con.close()

    def update_total(self, job_id: str, total: int) -> None:
        con = self._connect()
        try:
            con.execute(
                "UPDATE jobs SET total = ?, updated_at = ? WHERE job_id = ?",
                (total, int(time.time()), job_id),
            )
            con.commit()
        finally:
            con.close()

    def find_resumable_jobs(self) -> List[Job]:
        con = self._connect()
        try:
            rows = con.execute(
                "SELECT * FROM jobs WHERE status = 'inprogress' "
                "OR status = 'pending'"
            ).fetchall()
            return [self._row_to_job(r) for r in rows]
        finally:
            con.close()

    def find_active_reindex_job(self) -> Optional[Job]:
        con = self._connect()
        try:
            row = con.execute(
                "SELECT * FROM jobs WHERE job_type = 'reindex' AND "
                "(status = 'pending' OR status = 'inprogress')"
            ).fetchone()
            return self._row_to_job(row) if row else None
        finally:
            con.close()

    def create_reindex_job_if_not_active(
        self, payload: Optional[str], total: int
    ) -> Optional[Job]:
        """Atomic check-and-create; None when an active job already exists."""
        con = self._connect()
        try:
            con.isolation_level = None  # manual transaction control
            con.execute("BEGIN IMMEDIATE")
            try:
                row = con.execute(
                    "SELECT * FROM jobs WHERE job_type = 'reindex' AND "
                    "(status = 'pending' OR status = 'inprogress')"
                ).fetchone()
                if row is not None:
                    con.execute("ROLLBACK")
                    return None
                job_id = str(uuid.uuid4())
                now = int(time.time())
                con.execute(
                    "INSERT INTO jobs (job_id, status, job_type, payload, "
                    "total, started_at, updated_at) VALUES (?, ?, ?, ?, ?, ?, ?)",
                    (
                        job_id,
                        JobStatus.PENDING.value,
                        JobType.REINDEX.value,
                        payload,
                        total,
                        now,
                        now,
                    ),
                )
                con.execute("COMMIT")
            except BaseException:
                try:
                    con.execute("ROLLBACK")
                except sqlite3.Error:
                    pass
                raise
            row = con.execute(
                "SELECT * FROM jobs WHERE job_id = ?", (job_id,)
            ).fetchone()
            return self._row_to_job(row)
        finally:
            con.close()
