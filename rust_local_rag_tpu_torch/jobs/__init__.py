"""Background job system of the port (rust_local_rag_tpu/jobs): SQLite-
persisted jobs, the worker supervisor, the machine-parsable progress log.
Standard library only; one jobs.db reads the same in both packages."""

from rust_local_rag_tpu_torch.jobs.job_manager import (  # noqa: F401
    Job,
    JobManager,
    JobStatus,
    JobType,
)
from rust_local_rag_tpu_torch.jobs.progress_logger import (  # noqa: F401
    BatchProgress,
    ProgressLogger,
    ProgressState,
    Stage,
)
from rust_local_rag_tpu_torch.jobs.worker import JobRequest, WorkerSupervisor  # noqa: F401
