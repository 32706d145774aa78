"""A profiled sub-window of a traced run, and the arithmetic that reads it.

torch.profiler records the CPU and CUDA activities of every thread (the
server's work runs on the batcher's threads) for a few seconds inside the
measured window; the Chrome trace is read back and deleted. `busy` is the
union of the device operations' intervals inside the window marker, as the
program's utils/profiling.summarize takes it (copied here), and each long
idle gap is named by the innermost host operation over its midpoint.
Kernel times are the summed durations of the kernels whose names contain
a given substring; a record_function range's device time is that of the
kernels launched (by correlation id) from inside the range on its thread.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")
WINDOW = "benchmark.profile_window"


@dataclass
class Trace:
    events: List[dict] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)  # microseconds, the trace's clock


class Profiler:
    """torch.profiler over the CPU and CUDA activities of every thread,
    started and stopped on the thread that drives the run (the profiler's
    CUDA client registers on the thread that creates it); the span between
    start and stop is marked as the window. finish() reads the Chrome trace
    back (and deletes it) into a Trace."""

    def __init__(self):
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities, experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self._mark = None

    def start(self) -> None:
        from torch.profiler import record_function

        self._prof.start()
        self._mark = record_function(WINDOW)
        self._mark.__enter__()

    def stop(self) -> None:
        self._mark.__exit__(None, None, None)
        self._prof.stop()

    def finish(self) -> Trace:
        trace = Trace()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                trace.events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        marks = [e for e in trace.events if e.get("name") == WINDOW and e.get("ph") == "X"]
        if marks:
            a = float(marks[0]["ts"])
            trace.window = (a, a + float(marks[0].get("dur", 0.0)))
        return trace


def _intervals(events, categories):
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e) for e in events
            if e.get("ph") == "X" and e.get("cat") in categories and "ts" in e]


def summarize(trace: Trace, top: int = 10, gaps: int = 10) -> dict:
    """busy_us (the union of device intervals inside the window), the device
    operations that took the most time, and the longest idle gaps with the
    host operation over each (the window marker aside)."""
    dev = sorted(_intervals(trace.events, DEVICE_CATEGORIES), key=lambda x: x[0])
    host = [x for x in _intervals(trace.events, HOST_CATEGORIES) if x[2].get("name") != WINDOW]
    w0, w1 = trace.window
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
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    idle = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:gaps]

    def over(t: float) -> str:
        cover = [(b - a, e) for a, b, e in host if a <= t <= b]
        return min(cover, key=lambda x: x[0])[1].get("name", "?") if cover else "(no host operation)"

    by_name: Dict[str, float] = {}
    for a, b, e in dev:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            by_name[e.get("name", "?")] = by_name.get(e.get("name", "?"), 0.0) + (b - a)
    return {
        "busy_us": busy,
        "window_us": w1 - w0,
        "device_ops": [[n, us / 1e6] for n, us in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
        "idle_gaps": [[over((a + b) / 2), g / 1e6] for g, a, b in idle],
    }


def kernels(trace: Trace, names: Sequence[str]) -> List[dict]:
    """Kernel events inside the window whose name contains any of `names`."""
    w0, w1 = trace.window
    return [e for e in trace.events if e.get("ph") == "X" and e.get("cat") == "kernel"
            and w0 <= float(e["ts"]) <= w1 and any(n in e.get("name", "") for n in names)]


def range_device_us(trace: Trace, range_name: str) -> float:
    """Device time of the kernels launched from inside the host ranges named
    `range_name` (matched by correlation id through the launch calls)."""
    ranges = [(e.get("tid"), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
              for e in trace.events if e.get("ph") == "X" and e.get("name") == range_name
              and e.get("cat") in HOST_CATEGORIES]
    if not ranges:
        return 0.0
    by_tid: Dict[object, List[tuple]] = {}
    for tid, a, b in ranges:
        by_tid.setdefault(tid, []).append((a, b))
    launched = set()
    for e in trace.events:
        if e.get("ph") != "X" or e.get("cat") != "cuda_runtime":
            continue
        t = float(e["ts"])
        if any(a <= t <= b for a, b in by_tid.get(e.get("tid"), ())):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched.add(corr)
    return sum(float(e.get("dur", 0.0)) for e in trace.events
               if e.get("ph") == "X" and e.get("cat") == "kernel"
               and (e.get("args") or {}).get("correlation") in launched)


class SubWindow:
    """The window of a run as the probes see it, open from start(t). In a
    traced run, a profiled sub-window of `profile_seconds` in the middle of
    the window, driven from the run's own thread: poll()
    between units of work (or sleep_through() while another process does
    the work) starts and stops the profiler when due; the probes' window
    closes with it, so the profiler's cost falls outside what they count.
    finish() -> the Trace (None in an untraced run)."""

    def __init__(self, probes, trace: bool, profile_seconds: float, seconds: float):
        self.probes, self.want, self.seconds = probes, trace, seconds
        self.profile_s = min(float(profile_seconds), max(seconds - 2.0, 0.5))
        self._prof = None
        self._done = False
        self._t_on = self._t_off = 0.0

    def start(self, t_start: float) -> None:
        self._t_on = t_start + (self.seconds - self.profile_s) / 2.0
        self._t_off = self._t_on + self.profile_s
        self.probes.window_open = True

    def poll(self) -> None:
        if not self.want or self._done:
            return
        now = time.monotonic()
        if self._prof is None and now >= self._t_on:
            self._prof = Profiler()
            self._prof.start()
            self.probes.profiling = True
            # starting can take seconds under load: the sub-window runs from when it has
            self._t_off = time.monotonic() + self.profile_s
        elif self._prof is not None and now >= self._t_off:
            self.probes.profiling = False
            self.probes.window_open = False
            self._prof.stop()
            self._done = True

    def sleep_through(self) -> None:
        """Wait out the profiled sub-window (starting the profiler can take
        seconds under load; poll() then moves the stop)."""
        for due in (lambda: self._t_on, lambda: self._t_off):  # poll() moves _t_off
            while time.monotonic() < due():
                time.sleep(0.01)
            self.poll()

    def finish(self):
        if self._prof is not None and not self._done:
            self.probes.profiling = False
            self._prof.stop()
            self._done = True
        self.probes.window_open = False
        return self._prof.finish() if self._prof is not None else None
