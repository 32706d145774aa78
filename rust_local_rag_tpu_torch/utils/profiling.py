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
N ms over the running process, and replies with the trace's path.
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
from typing import List, Optional

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")


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
    the yielded DeviceTrace."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    trace = DeviceTrace(os.path.join(log_dir, f"trace_{os.getpid()}_{uuid.uuid4().hex[:8]}.json"))
    with profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield trace
    prof.export_chrome_trace(trace.path)
    with open(trace.path, encoding="utf-8") as f:
        trace.events = json.load(f).get("traceEvents", [])


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
    one is open). log_dir defaults to the directory the server was given."""

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
