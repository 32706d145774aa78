"""The program's own spans and counters (the tracer in
rust_local_rag_tpu_torch/utils/profiling.py), for the metrics that read
them. This is the second module under benchmark/ that imports the program
(harness/program.py is the first).

`hook(target)` is a `count` probe for a metric's PROBES: at its first call
inside the traced window it resets the program's tracer and turns it on;
at its first call once the profiled sub-window has started it takes the
tracer's snapshot and turns the tracer off, so the totals cover the
documents (or batches) that the benchmark's own span probes time, from
the window's start to the profiled sub-window (the host's speed drifts
within a run, so totals over other seconds would not compare). Probes are
installed in the traced run only, so untraced runs keep the tracer off.
`totals(rec)` reads that snapshot once the run has ended (the tracer's
own, taken then, where the profiler never started), and keeps it on the
record. A program without the tracer gives None, and its readers report
nothing.
"""

from __future__ import annotations

from typing import Optional

_run = {"started": False, "frozen": None}


def _tracer():
    """The program's profiling module where it has the tracer, else None."""
    from rust_local_rag_tpu_torch.utils import profiling

    return profiling if all(hasattr(profiling, f) for f in ("enable", "disable", "reset", "snapshot")) else None


def _start(args, kwargs) -> int:
    from torch.autograd import profiler

    tracer = _tracer() if _run["frozen"] is None else None
    if tracer is not None and not _run["started"]:
        tracer.reset()
        tracer.enable()
        _run["started"] = True
    elif tracer is not None and profiler._is_profiler_enabled:
        _run["frozen"] = tracer.snapshot()
        tracer.disable()
    return 0


def hook(target: str) -> dict:
    """The probe that starts the program's tracer at the first call of
    `target` inside the window and stops it at the first call once the
    profiler records."""
    return {"kind": "count", "name": "program_tracer", "target": target, "fn": _start}


def totals(rec) -> Optional[dict]:
    """{"spans": {name: {calls, ns, items, self_ns}}, "counters": {...}} of
    the run, or None where the tracer never started."""
    if "program_spans" not in rec.info:
        snap = _run["frozen"]
        if _run["started"]:
            tracer = _tracer()
            if snap is None:
                snap = tracer.snapshot()
            tracer.disable()
        _run.update(started=False, frozen=None)
        rec.info["program_spans"] = snap
    return rec.info["program_spans"]


def ms_per_item(rec, name: str) -> Optional[float]:
    """Milliseconds of span `name` an item (a chunk, a request, a query)."""
    row = ((totals(rec) or {}).get("spans") or {}).get(name)
    return row["ns"] / row["items"] / 1e6 if row and row["items"] else None


def ms_per_call(rec, name: str) -> Optional[float]:
    """Milliseconds of span `name` a call."""
    row = ((totals(rec) or {}).get("spans") or {}).get(name)
    return row["ns"] / row["calls"] / 1e6 if row and row["calls"] else None
