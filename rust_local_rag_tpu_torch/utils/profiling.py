"""Tracing / step-time percentile tooling (port of
rust_local_rag_tpu/utils/profiling.py).

The reference instruments per-phase latency inside rerank scoring and
exposes a calibrate tool computing percentile stats (SURVEY.md §5.1,
reranker.rs:321-441,605-699). The JAX package opens a JAX profiler trace;
here `device_trace` is a torch.profiler window over the CPU and, where a
card is present, CUDA activities, written as a Chrome trace. `summarize`
reads such a trace's events: the device's busy and idle share of the
window, the device operations that took the most time, and the longest
idle gaps with the host operation running over each. `StepTimer` is the
JAX package's, unchanged: nearest-rank percentiles for steady-state
monitoring.

PyTorch has no profiler server like `jax.profiler.start_server`, which the
JAX server starts on RAG_TPU_PROFILE_PORT so that a live server's device
trace can be captured. `CaptureServer` keeps that capability: a loopback
listener on that port that answers `POST /capture` with
{"duration_ms": N, "log_dir": DIR} by taking one `device_trace` window of
N ms over the running process, and replies with the trace's path;
`GET /totals` answers the tracer's `snapshot()`.

The tracer (`TRACER`, with `span`, `interval`, `count`, `snapshot`,
`reset`, `enable` and `disable` bound to it) names the program's own
stages. Off by default (RAG_TPU_TRACE=1 at start-up or `enable()` turns
it on); while off and while no torch.profiler records, `span` checks two
flags and returns a shared no-op: no clock, no lock. While a profiler
records, every span enters `torch.profiler.record_function(name)`, on or
off, so a `device_trace` window and a benchmark's profiled window hold
the stages as user_annotation events beside the kernels, and `summarize`
names idle gaps after them. Inside a `device_trace` window a span's
request ids also reach the trace file: the range is named
"<name>@<ids>" and `device_trace` writes the file back with the name
alone and the ids as the event's "request" arg (the Chrome export drops
`record_function`'s own args string). While on, and no profiler
records, the tracer keeps for each span name its calls, host
nanoseconds, items and self nanoseconds (its time less what its child
spans and intervals cover), and each counter's sum. Spans and intervals
live at layer boundaries, never per row; none synchronises the device.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")
ANNOTATION_CATEGORIES = ("user_annotation", "gpu_user_annotation")
REQUEST_TAG = "@"  # "<span name>@<request ids>": a range's name inside a device_trace window


@dataclass
class DeviceTrace:
    """What one device_trace window left: the Chrome trace's path and its
    events (the trace's "traceEvents"), filled in when the window closes."""

    path: str
    events: List[dict] = field(default_factory=list)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A torch.profiler window with the CPU and (with a card) CUDA
    activities over every thread of the process (a server's operations run
    on its batcher's and handlers' threads, not the caller's); on exit the
    Chrome trace is written into log_dir and its events are read back into
    the yielded DeviceTrace. The spans' request ids are in the file as
    their events' "request" arg."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    trace = DeviceTrace(os.path.join(log_dir, f"trace_{os.getpid()}_{uuid.uuid4().hex[:8]}.json"))
    TRACER.tag_requests += 1
    try:
        with profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            yield trace
    finally:
        TRACER.tag_requests -= 1
    prof.export_chrome_trace(trace.path)
    with open(trace.path, encoding="utf-8") as f:
        data = json.load(f)
    trace.events = data.get("traceEvents", [])
    if _untag_requests(trace.events):
        with open(trace.path, "w", encoding="utf-8") as f:
            json.dump(data, f)


def _untag_requests(events: List[dict]) -> int:
    """Each range named "<name>@<ids>" renamed <name>, the ids as its
    "request" arg; the number renamed."""
    n = 0
    for e in events:
        name = e.get("name")
        if isinstance(name, str) and REQUEST_TAG in name and e.get("cat") in ANNOTATION_CATEGORIES:
            e["name"], ids = name.split(REQUEST_TAG, 1)
            e.setdefault("args", {})["request"] = ids
            n += 1
    return n


def _intervals(events, categories):
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e) for e in events
            if e.get("ph") == "X" and e.get("cat") in categories and "ts" in e]


def summarize(events: List[dict], window: Optional[tuple] = None, top: int = 10, gaps: int = 5,
              ignore: tuple = ()) -> dict:
    """The device's share of a trace window (microseconds, the trace's
    clock): busy is the union of the device operations' intervals inside
    the window, idle the rest. window defaults to the span of every host
    and device event. `top_ops` sums each device operation's time over
    its calls; each of the longest idle gaps names the innermost host
    operation or annotation running over its midpoint (None where none
    was), those named in `ignore` (the caller's own window markers)
    aside."""
    dev = sorted(_intervals(events, DEVICE_CATEGORIES), key=lambda x: x[0])
    host = [x for x in _intervals(events, HOST_CATEGORIES) if x[2].get("name") not in ignore]
    spans = [(a, b) for a, b, _ in dev + host]
    if window is None:
        if not spans:
            raise ValueError("the trace holds no host or device event")
        window = (min(a for a, _ in spans), max(b for _, b in spans))
    w0, w1 = window
    merged: List[list] = []
    for a, b, _ in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    total = w1 - w0
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    idle = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:gaps]

    def over(t: float):
        cover = [(b - a, e) for a, b, e in host if a <= t <= b]
        if not cover:
            return None
        e = min(cover, key=lambda x: x[0])[1]
        return {"name": e.get("name"), "cat": e.get("cat"), "tid": e.get("tid"), "dur_us": e.get("dur")}

    by_name: dict = {}
    for a, b, e in dev:
        row = by_name.setdefault(e.get("name"), {"name": e.get("name"), "cat": e.get("cat"), "calls": 0, "us": 0.0})
        row["calls"] += 1
        row["us"] += b - a
    return {
        "window_us": total,
        "device_busy_us": busy,
        "device_busy_share": busy / total if total > 0 else 0.0,
        "device_idle_share": 1.0 - busy / total if total > 0 else 1.0,
        "device_ops": len(dev),
        "top_ops": sorted(by_name.values(), key=lambda r: -r["us"])[:top],
        "longest_gaps": [{"us": g, "start_us": a - w0, "host": over((a + b) / 2)} for g, a, b in idle],
    }


class _Noop:
    """The span of a tracer that is off: enters and leaves, and records
    nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> None:
        return None


NOOP = _Noop()


def _recording() -> bool:
    """A torch.profiler is recording (torch's own flag for fast checks)."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    """One open span: its place on the thread's stack, its profiler range
    while one records, and the time its children cover."""

    __slots__ = ("tracer", "name", "items", "request", "parent", "covered", "t0", "range", "keep")

    def __init__(self, tracer: "Tracer", name: str, items: int, request) -> None:
        self.tracer = tracer
        self.name = name
        self.items = items
        self.request = request
        self.covered = 0

    def __enter__(self) -> "_Span":
        tracer = self.tracer
        stack = tracer._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.range = None
        if _recording():
            name, request = self.name, self.request
            if request is not None and tracer.tag_requests:
                if not isinstance(request, (int, str)):
                    request = ",".join(str(r) for r in request)
                name = f"{name}{REQUEST_TAG}{request}"
            self.range = record_function(name)
            self.range.__enter__()
        self.keep = tracer.on and self.range is None
        self.t0 = tracer.clock()
        return self

    def __exit__(self, *exc) -> None:
        tracer = self.tracer
        ns = tracer.clock() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        tracer._stack().pop()
        if self.parent is not None:
            self.parent.covered += ns
        if self.keep and not _recording():
            tracer._add(self.name, ns, self.items, max(ns - self.covered, 0))


class _Adopted:
    """A caller's span on another thread's stack, as the parent of the
    spans that thread opens on the caller's behalf."""

    __slots__ = ("tracer", "span")

    def __init__(self, tracer: "Tracer", span: _Span) -> None:
        self.tracer = tracer
        self.span = span

    def __enter__(self) -> "_Adopted":
        self.tracer._stack().append(self.span)
        return self

    def __exit__(self, *exc) -> None:
        self.tracer._stack().pop()


class Tracer:
    """Spans, intervals and counters of one process (module docstring).
    `clock` gives integer nanoseconds (time.perf_counter_ns by default; a
    test injects its own)."""

    def __init__(self, clock: Callable[[], int] = time.perf_counter_ns, on: bool = False) -> None:
        self.clock = clock
        self.on = on
        self._local = threading.local()
        self._lock = threading.Lock()  # the batcher runs two batches at once
        self._spans: Dict[str, List[int]] = {}   # name -> [calls, ns, items, self ns]
        self._counts: Dict[str, int] = {}
        self.tag_requests = 0  # device_trace windows open: spans name their ranges "<name>@<ids>"

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, name: str, ns: int, items: int, self_ns: int) -> None:
        with self._lock:
            row = self._spans.get(name)
            if row is None:
                row = self._spans[name] = [0, 0, 0, 0]
            row[0] += 1
            row[1] += ns
            row[2] += items
            row[3] += self_ns

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def span(self, name: str, items: int = 1, request=None):
        """A context manager around one stage at a layer boundary; `request`
        is a request id or a sequence of them (a `device_trace` file's
        "request" arg of the span's event)."""
        if not (self.on or _autograd_profiler._is_profiler_enabled):
            return NOOP
        return _Span(self, name, items, request)

    def active(self) -> bool:
        """A span would do anything: the tracer is on or a profiler records."""
        return self.on or _autograd_profiler._is_profiler_enabled

    def current(self) -> Optional[_Span]:
        """The innermost open span of this thread (None while off)."""
        if not self.on:
            return None
        stack = self._stack()
        return stack[-1] if stack else None

    def adopt(self, parent: Optional[_Span]):
        """On a thread working for a caller: `parent` (the caller's
        current()) becomes the parent of the spans opened inside."""
        return NOOP if parent is None else _Adopted(self, parent)

    def interval(self, name: str, t0: int, t1: int, items: int = 1) -> None:
        """A wait measured across threads, t0 to t1 on `clock`: into the
        totals only (no profiler range), and covered time of this thread's
        open span."""
        if not self.on or _recording():
            return
        ns = max(t1 - t0, 0)
        stack = self._stack()
        if stack:
            stack[-1].covered += ns
        self._add(name, ns, items, ns)

    def count(self, name: str, n: int) -> None:
        if not self.on or _recording():
            return
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def snapshot(self) -> dict:
        """{"spans": {name: {calls, ns, items, self_ns}}, "counters":
        {name: sum}}, a copy."""
        with self._lock:
            return {"spans": {k: dict(zip(("calls", "ns", "items", "self_ns"), v)) for k, v in self._spans.items()},
                    "counters": dict(self._counts)}

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counts.clear()


TRACE_ENV = "RAG_TPU_TRACE"
TRACER = Tracer(on=os.environ.get(TRACE_ENV, "") not in ("", "0", "false"))
span = TRACER.span
active = TRACER.active
interval = TRACER.interval
count = TRACER.count
snapshot = TRACER.snapshot
reset = TRACER.reset
enable = TRACER.enable
disable = TRACER.disable


@dataclass
class StepStats:
    mean_ms: float
    median_ms: float
    p95_ms: float
    p99_ms: float
    max_ms: float
    sample_size: int


class StepTimer:
    """Collects wall-clock step durations; nearest-rank percentiles with
    index round(p * (N-1)) — the reference's formula (reranker.rs:670-676).
    """

    def __init__(self) -> None:
        self._durations_ms: List[float] = []
        self._start: Optional[float] = None

    def __enter__(self) -> "StepTimer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        assert self._start is not None
        self._durations_ms.append((time.perf_counter() - self._start) * 1000)
        self._start = None

    def record_ms(self, ms: float) -> None:
        self._durations_ms.append(ms)

    def stats(self) -> StepStats:
        if not self._durations_ms:
            raise ValueError("no samples recorded")
        data = sorted(self._durations_ms)
        n = len(data)
        p95 = data[min(round(0.95 * (n - 1)), n - 1)]
        p99 = data[min(round(0.99 * (n - 1)), n - 1)]
        return StepStats(
            mean_ms=sum(data) / n,
            median_ms=data[n // 2],
            p95_ms=p95,
            p99_ms=p99,
            max_ms=data[-1],
            sample_size=n,
        )


class CaptureServer:
    """The loopback listener of RAG_TPU_PROFILE_PORT: POST /capture with
    {"duration_ms": N, "log_dir": DIR} takes one device_trace window of N
    ms (at most MAX_MS) over the process and answers {"trace": path,
    "events": count, "duration_ms": N}; one window at a time (409 while
    one is open). log_dir defaults to the directory the server was given.
    GET /totals answers the tracer's totals: {"on": bool, "spans": ...,
    "counters": ...} (`snapshot()`; empty while the tracer is off)."""

    MAX_MS = 600_000

    def __init__(self, port: int, log_dir: str, host: str = "127.0.0.1"):
        self.log_dir = log_dir
        self._busy = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # the server's log has its own lines
                pass

            def _reply(self, status: int, body: dict) -> None:
                data = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path != "/totals":
                    return self._reply(404, {"error": f"no route {self.path}"})
                return self._reply(200, {"on": TRACER.on, **TRACER.snapshot()})

            def do_POST(self):
                if self.path != "/capture":
                    return self._reply(404, {"error": f"no route {self.path}"})
                try:
                    raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                    req = json.loads(raw or b"{}")
                    ms = float(req.get("duration_ms", 1000))
                    log_dir = str(req.get("log_dir") or outer.log_dir)
                    if not 0 < ms <= outer.MAX_MS:
                        raise ValueError(f"duration_ms must lie in (0, {outer.MAX_MS}]")
                except (ValueError, TypeError, AttributeError) as e:
                    return self._reply(400, {"error": str(e)})
                if not outer._busy.acquire(blocking=False):
                    return self._reply(409, {"error": "a capture is running"})
                try:
                    with device_trace(log_dir) as trace:
                        time.sleep(ms / 1000.0)
                except Exception as e:  # noqa: BLE001 - reported to the caller
                    return self._reply(500, {"error": str(e)})
                finally:
                    outer._busy.release()
                return self._reply(200, {"trace": trace.path, "events": len(trace.events), "duration_ms": ms})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="profile-capture", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)
