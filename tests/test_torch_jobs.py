"""The port's jobs system (rust_local_rag_tpu_torch/jobs) against the JAX
package's: JobManager rows and state changes on the same operations (and
one jobs.db read by both), the progress log's lines, and a worker reindex
over the same PDFs with a failing one, a resume after a restart and the
hash skip of a second reindex, with the hash encoder on both sides (numpy,
bit-identical vectors). Lines are compared after masking what depends on
the clock or the job id (ts, job, dps, eta_s).

Also the port's answer to ROADMAP C3: a reindex job's writer queued while
a judged-lane batch fails and falls back to the general lane."""

import os
import re
import threading
import time

import numpy as np
import pytest

import pdfgen
from rust_local_rag_tpu.engine.rag_engine import RagEngine as JEngine
from rust_local_rag_tpu.jobs import JobManager as JManager
from rust_local_rag_tpu.jobs import JobRequest as JRequest
from rust_local_rag_tpu.jobs import JobStatus as JStatus
from rust_local_rag_tpu.jobs import JobType as JType
from rust_local_rag_tpu.jobs import ProgressLogger as JLogger
from rust_local_rag_tpu.jobs import ProgressState as JState
from rust_local_rag_tpu.jobs import WorkerSupervisor as JSupervisor
from rust_local_rag_tpu.jobs.progress_logger import BatchProgress as JBatch
from rust_local_rag_tpu.jobs.progress_logger import Stage as JStage
from rust_local_rag_tpu.models.embedding_service import EmbeddingService as JService
from rust_local_rag_tpu.models.fake_encoder import HashEncoder as JHash
from rust_local_rag_tpu.utils.rwlock import RwLock as JLock
from rust_local_rag_tpu_torch.config import QueryWeights
from rust_local_rag_tpu_torch.engine.rag_engine import RagEngine
from rust_local_rag_tpu_torch.jobs import (
    BatchProgress,
    JobManager,
    JobRequest,
    JobStatus,
    JobType,
    ProgressLogger,
    ProgressState,
    Stage,
    WorkerSupervisor,
)
from rust_local_rag_tpu_torch.models.embedding_service import EmbeddingService
from rust_local_rag_tpu_torch.models.fake_encoder import HashEncoder
from rust_local_rag_tpu_torch.models.reranker_service import RerankerService
from rust_local_rag_tpu_torch.utils.rwlock import RwLock, lock_metrics

DIM = 64
DOCS = {
    "astronomy.pdf": ["ASTRONOMY\n\nTelescopes observe distant galaxies and nebulae. Spectroscopy reveals "
                      "the composition of stars.", "Radio telescopes map cold hydrogen clouds in spiral arms."],
    "garden.pdf": ["GARDENING\n\nTomato plants need full sun and regular watering. Compost improves soil "
                   "structure and fertility."],
    "sub/kitchen.pdf": ["COOKING\n\nBraising softens tough cuts of meat slowly in a covered pot with "
                        "a little liquid."],
}
JOB_WAIT_S = 120


def _write_docs(root, bad=True):
    for name, pages in DOCS.items():
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(pdfgen.make_pdf(pages))
    if bad:
        (root / "broken.pdf").write_bytes(b"not a pdf at all")
    (root / "notes.txt").write_text("not a PDF, not discovered")


_MASK = [(re.compile(r"\bts=\d+"), "ts=T"), (re.compile(r"\bjob=\S+"), "job=J"),
         (re.compile(r"\bdps=[0-9.]+"), "dps=D"), (re.compile(r"\beta_s=\d+"), "eta_s=E")]


def _masked_lines(path):
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            for pat, rep in _MASK:
                line = pat.sub(rep, line)
            out.append(line)
    return out


def _row(job):
    """A job row without its id and clock fields."""
    d = job.to_dict()
    for k in ("job_id", "started_at", "updated_at"):
        d.pop(k)
    return d


# ------------------------------------------------------------ manager ----


def _manager_ops(mgr, status, jtype):
    """The same operations on either package's manager; the rows seen."""
    seen = []
    a = mgr.create_job(jtype.REINDEX, "/docs", 3)
    seen.append(_row(a))
    seen.append(_row(mgr.find_active_reindex_job()))
    assert mgr.create_reindex_job_if_not_active("/docs", 0) is None
    mgr.update_status(a.job_id, status.IN_PROGRESS)
    mgr.update_total(a.job_id, 7)
    mgr.update_progress(a.job_id, 4)
    seen.append(_row(mgr.get_job(a.job_id)))
    seen.append(sorted(_row(j)["status"] for j in mgr.find_resumable_jobs()))
    mgr.update_status(a.job_id, status.COMPLETED, "summary")
    seen.append(_row(mgr.get_job(a.job_id)))
    assert mgr.find_active_reindex_job() is None and mgr.get_job("missing") is None
    b = mgr.create_reindex_job_if_not_active("/docs2", 0)
    seen.append(_row(b))
    mgr.update_status(b.job_id, status.FAILED, "boom")
    seen.append(_row(mgr.get_job(b.job_id)))
    seen.append(mgr.find_resumable_jobs())
    return seen


def test_job_manager_rows_equal_jax(tmp_path):
    port = _manager_ops(JobManager(str(tmp_path / "p.db")), JobStatus, JobType)
    jax = _manager_ops(JManager(str(tmp_path / "j.db")), JStatus, JType)
    assert port == jax


def test_one_jobs_db_reads_the_same_in_both_packages(tmp_path):
    db = str(tmp_path / "jobs.db")
    port, jax = JobManager(db), JManager(db)
    a = port.create_reindex_job_if_not_active("/docs", 0)
    assert jax.create_reindex_job_if_not_active("/docs", 0) is None  # one active job across both
    jax.update_progress(a.job_id, 2)
    assert port.get_job(a.job_id).to_dict() == jax.get_job(a.job_id).to_dict()
    assert port.get_job(a.job_id).progress == 2


@pytest.mark.parametrize("managers", ["port", "mixed"])
def test_create_if_not_active_is_atomic(tmp_path, managers):
    """16 threads race to create the reindex job on one database (through
    the port's manager, or alternately through both packages'): exactly
    one wins."""
    db = str(tmp_path / "jobs.db")
    mgrs = [JobManager(db), JobManager(db) if managers == "port" else JManager(db)]
    start = threading.Barrier(16)
    created = []

    def race(i):
        start.wait(timeout=30)
        created.append(mgrs[i % 2].create_reindex_job_if_not_active("/docs", 0))

    threads = [threading.Thread(target=race, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(created) == 16 and sum(j is not None for j in created) == 1


# ----------------------------------------------------------- progress ----


def test_progress_lines_equal_jax(tmp_path):
    paths = []
    for logger_cls, state_cls, batch_cls, stage, d in (
        (ProgressLogger, ProgressState, BatchProgress, Stage, tmp_path / "p"),
        (JLogger, JState, JBatch, JStage, tmp_path / "j"),
    ):
        pl = logger_cls(str(d))
        st = state_cls(job_id="job-1", total_docs=3)
        pl.emit(st, "stage", "discovered 3 PDFs")
        st.stage = stage.EMBEDDING
        st.done_docs, st.success_docs, st.embedded_docs, st.last_doc = 1, 1, 1, "a b/ü.pdf"
        st.current_batch, st.total_batches = 2, 5
        pl.emit(st, "progress", "4 chunks & more")
        pl.emit_batch(st, batch_cls("a b/ü.pdf", 2, 5, 16, 70))
        st.stage = stage.FINALIZE
        pl.emit(st, "done", None)
        paths.append(pl.path)
    assert os.path.basename(paths[0]) == "progress_tracking.log"
    assert _masked_lines(paths[0]) == _masked_lines(paths[1])


# ------------------------------------------------------------- worker ----


class _Side:
    """One package's engine, lock, manager and supervisor over its own
    data and log directories."""

    def __init__(self, root, port: bool, docs):
        self.root = root
        self.docs = str(docs)
        self.log_dir = str(root / "logs")
        os.makedirs(root / "data", exist_ok=True)
        if port:
            svc = EmbeddingService(HashEncoder(dim=DIM, model_name="jobs-test"))
            self.engine = RagEngine(str(root / "data"), svc, device="cpu")
            self.mgr, self.lock, sup, self.req = JobManager(str(root / "jobs.db")), RwLock(), WorkerSupervisor, JobRequest
        else:
            svc = JService(JHash(dim=DIM, model_name="jobs-test"))
            self.engine = JEngine(str(root / "data"), svc)
            self.mgr, self.lock, sup, self.req = JManager(str(root / "jobs.db")), JLock(), JSupervisor, JRequest
        self.sup = sup(self.mgr, self.engine, self.lock, log_dir=self.log_dir)

    def reindex(self):
        job = self.mgr.create_reindex_job_if_not_active(self.docs, 0)
        self.sup.submit(self.req(job.job_id, self.docs))
        return self.wait(job.job_id)

    def wait(self, job_id):
        deadline = time.monotonic() + JOB_WAIT_S
        while time.monotonic() < deadline:
            job = self.mgr.get_job(job_id)
            if job.status.value in ("completed", "failed"):
                return job
            time.sleep(0.05)
        raise AssertionError(f"job {job_id} did not finish in {JOB_WAIT_S} s")

    def lines(self):
        return _masked_lines(os.path.join(self.log_dir, "progress_tracking.log"))


def _summary(job):
    """The job's error text, each failure's message cut after its file
    name: the JAX package also tries pdftotext, so its messages are
    longer (the port has the built-in extractor only, ROADMAP A9)."""
    if job.error is None:
        return None
    lines = job.error.splitlines()
    return "\n".join(lines[:1] + [ln.split(": ", 1)[0] for ln in lines[1:]])


@pytest.fixture
def sides(tmp_path):
    docs = tmp_path / "documents"
    _write_docs(docs)
    made = [_Side(tmp_path / "port", True, docs), _Side(tmp_path / "jax", False, docs)]
    yield made
    for s in made:
        s.sup.stop(timeout=5)


def test_worker_reindex_equals_jax_then_hash_skips(sides):
    port, jax = sides
    for s in sides:
        s.sup.start()
    first = [s.reindex() for s in sides]
    assert [j.status for j in first] == [JobStatus.COMPLETED, JStatus.COMPLETED]
    assert [(j.progress, j.total) for j in first] == [(4, 4), (4, 4)]
    assert _summary(first[0]) == _summary(first[1])
    assert first[0].error.startswith("Job completed with 1 failures out of 4 documents. Failed documents:\nbroken.pdf: ")
    assert port.lines() == jax.lines()
    n = len(port.engine.store)
    assert n == len(jax.engine.store) > 0
    assert port.engine.list_documents() == jax.engine.list_documents() == ["astronomy.pdf", "garden.pdf", "kitchen.pdf"]
    # the second reindex hash-skips every readable document
    second = [s.reindex() for s in sides]
    assert [(j.status.value, j.progress, _summary(j)) for j in second] == \
        [(j.status.value, j.progress, _summary(j)) for j in first]
    assert port.lines() == jax.lines()
    assert len(port.engine.store) == n
    done = [ln for ln in port.lines() if " event=done " in ln]
    assert len(done) == 2 and "skipped=3 embedded=0" in done[1] and "skipped=0 embedded=3" in done[0]
    assert 0 < lock_metrics.max_held_ms()
    # the index the worker saved loads again with the same chunks
    again = RagEngine(port.engine.data_dir, port.engine.embedding_service, device="cpu")
    assert sorted(again.store.chunk_ids()) == sorted(port.engine.store.chunk_ids())


@pytest.mark.parametrize("status", ["pending", "inprogress"])
def test_worker_resumes_unfinished_jobs_like_jax(sides, status):
    """A job left pending or in progress by a stopped server runs when the
    next supervisor starts (worker.rs:141-154)."""
    ids = []
    for s, st in zip(sides, (JobStatus, JStatus)):
        job = s.mgr.create_reindex_job_if_not_active(s.docs, 0)
        s.mgr.update_status(job.job_id, st(status))
        ids.append(job.job_id)
        s.sup.start()  # the restart: resumes what the database holds
    done = [s.wait(i) for s, i in zip(sides, ids)]
    assert [(j.status.value, j.progress, j.total) for j in done] == [("completed", 4, 4)] * 2
    assert sides[0].lines() == sides[1].lines()
    assert len(sides[0].engine.store) == len(sides[1].engine.store) > 0


def test_worker_warms_up_under_the_read_lock_after_reindex(tmp_path, monkeypatch):
    docs = tmp_path / "documents"
    _write_docs(docs, bad=False)
    side = _Side(tmp_path / "port", True, docs)
    seen = []
    real = side.engine.warmup

    def warmup():
        # a writer cannot get in while warmup holds the read lock
        seen.append(side.lock.acquire_write(timeout=0.01))
        real()

    monkeypatch.setattr(side.engine, "warmup", warmup)
    side.sup.start()
    try:
        job = side.reindex()
    finally:
        side.sup.stop(timeout=5)
    assert job.status == JobStatus.COMPLETED and job.error is None
    assert seen == [False]
    assert side.engine.get_stats()["status"] == "ready"


# -------------------------------------------------- C3: writer vs fallback ----


class _FailingJudge:
    """A judge that waits until a writer is queued on the engine lock,
    then fails: the judged lane must give the batch to the general lane
    with the read lock released, or the queued writer (write-preferring
    lock) and the nested read wait on each other forever."""

    model_name = "failing-judge"

    def __init__(self, lock: RwLock, judging: threading.Event):
        self.lock = lock
        self.judging = judging

    def dispatch_prompts(self, prompts):
        self.judging.set()
        deadline = time.monotonic() + 30
        while self.lock._writers_waiting == 0 and time.monotonic() < deadline:
            time.sleep(0.001)
        raise RuntimeError("judge failed")

    def fetch_prompts(self, handle):
        return handle

    def score_prompts(self, prompts):
        raise RuntimeError("judge failed")


def test_writer_queued_during_judged_fallback_completes(tmp_path):
    from rust_local_rag_tpu_torch.server.batcher import SearchBatcher

    docs = tmp_path / "documents"
    _write_docs(docs, bad=False)
    lock = RwLock()
    judging = threading.Event()
    svc = EmbeddingService(HashEncoder(dim=DIM, model_name="c3"))
    engine = RagEngine(str(tmp_path / "data"), svc, RerankerService(_FailingJudge(lock, judging)), device="cpu")
    for name, pages in DOCS.items():  # a live index, so the judged lane runs its judge
        engine.add_document(os.path.basename(name), pdfgen.make_pdf(pages))
    (docs / "extra.pdf").write_bytes(pdfgen.make_pdf(["Extra page about comets and their icy tails."]))
    mgr = JobManager(str(tmp_path / "jobs.db"))
    sup = WorkerSupervisor(mgr, engine, lock, log_dir=str(tmp_path / "logs"))
    batcher = SearchBatcher(engine, lock)
    order = []
    real_add = engine.add_document

    def add_document(filename, data, batch_callback=None):
        out = real_add(filename, data, batch_callback=batch_callback)
        order.append(("writer", filename))
        return out

    engine.add_document = add_document
    sup.start()
    try:
        fut = batcher.submit("telescopes and galaxies", 3, 0.0, QueryWeights(reranker=0.0, initial=1.0),
                             use_reranker=True)
        assert judging.wait(30), "the judged lane never reached its judge"
        # the judge is running under the batch's read lock: queue the
        # reindex job's writer (timed_write_guard, no timeout) behind it
        job = mgr.create_reindex_job_if_not_active(str(docs), 0)
        sup.submit(JobRequest(job.job_id, str(docs)))
        results = fut.result(timeout=60)
        order.append(("search", len(results)))
        deadline = time.monotonic() + 60
        while mgr.get_job(job.job_id).status != JobStatus.COMPLETED and time.monotonic() < deadline:
            time.sleep(0.05)
        assert mgr.get_job(job.job_id).status == JobStatus.COMPLETED
    finally:
        sup.stop(timeout=10)
    # only once the search has completed: stop() waits for the batcher's
    # pool, which a deadlocked batch would hold forever
    batcher.stop()
    alive = [t for t in sup._threads if t.is_alive()]
    assert not alive and not batcher._thread.is_alive()
    # the batch fell back once; its general lane answered with initial
    # scores (the worker's post-reindex warmup also counts its own)
    assert batcher.judged_fallbacks == 1 and engine.rerank_fallbacks >= 1
    assert [r.document for r in results][:1] == ["astronomy.pdf"]
    # the queued writer went first once the failed batch released its read
    # lock (write preference); the fallback search completed after it
    assert order.index(("writer", "astronomy.pdf")) < order.index(("search", len(results)))
    assert ("writer", "extra.pdf") in order
    assert np.isfinite([r.score for r in results]).all()


# ------------------------------------------- engine methods of the worker ----


def test_engine_reindex_methods_like_jax(tmp_path):
    """needs_reindex, finalize_reindex, switch_embedding_model (out to a
    model with no index and back, each model's index kept on disk) and
    get_embedding_candidates, on both packages' engines over the same PDFs
    (hash encoders: bit-identical vectors; candidate scores within 1e-6,
    f32 dots summed in another order)."""
    port = RagEngine(str(tmp_path / "p"), EmbeddingService(HashEncoder(dim=DIM, model_name="m-a")), device="cpu")
    jax = JEngine(str(tmp_path / "j"), JService(JHash(dim=DIM, model_name="m-a")))
    seen = {"port": [], "jax": []}
    for name, e, svc, enc in (("port", port, EmbeddingService, HashEncoder), ("jax", jax, JService, JHash)):
        for doc, pages in DOCS.items():
            e.add_document(os.path.basename(doc), pdfgen.make_pdf(pages))
        e._needs_reindex = True  # as after a model change
        seen[name].append((e.needs_reindex(), e.get_stats()["status"]))
        e.finalize_reindex()
        seen[name].append((e.needs_reindex(), e.get_stats()["status"], len(e.store)))
        cands = e.get_embedding_candidates("telescopes and galaxies", 3)
        seen[name].append([(c.document, c.text, c.page_number, c.section) for c in cands])
        seen[name].append([c.initial_score for c in cands])
        e.switch_embedding_model(svc(enc(dim=DIM // 2, model_name="m-b")))
        seen[name].append((e.embedding_model(), len(e.store), e.store.dim, e.needs_reindex(), e.list_documents()))
        e.switch_embedding_model(svc(enc(dim=DIM, model_name="m-a")))
        seen[name].append((e.embedding_model(), len(e.store), e.needs_reindex(), e.list_documents()))
        seen[name].append(len(e.get_embedding_candidates("anything", 0)))
    p, j = seen["port"], seen["jax"]
    np.testing.assert_allclose(p[3], j[3], rtol=0, atol=1e-6)
    assert p[:3] + p[4:] == j[:3] + j[4:]
    assert p[1] == (False, "ready", 3) and p[4][1] == 0 and p[5][1] == 3
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
