"""The benchmark's own wrappers around public calls into the program's
layers, declared by the metrics that read them (each metric file's
PROBES), and counters read before and after the window.

A target is "<root>.<attr>...<attr>" (an object a drivers/ module names, such as
"engine" or "service") or "module:<dotted path>.<attr>". Kinds:
  * span: calls, host seconds and items (fn(args, kwargs) a call, else 1),
    counted while the window is open and the profiler is off (it inflates
    host time);
  * range: the call runs under torch.profiler.record_function(name);
  * record: fn(args, kwargs, roots) -> a dict appended while the profiler
    is on (the work of each launch in the profiled window);
  * count: fn(args, kwargs) -> a number added up over the window (None:
    1 a call).
Probes are installed for the traced run; `count` probes that prove a run
drives its lane are installed in every run (they cost one call a batch).
"""

from __future__ import annotations

import functools
import importlib
import threading
import time
from typing import Callable, Dict, List, Optional

import torch


class Probes:
    def __init__(self, roots: Dict[str, object]):
        self.roots = roots
        self.spans: Dict[str, List[float]] = {}     # name -> [calls, seconds, items]
        self.records: Dict[str, List[dict]] = {}
        self.counts: Dict[str, float] = {}
        self.window_open = False
        self.profiling = False
        self._undo: List[Callable[[], None]] = []
        self._lock = threading.Lock()  # the batcher runs two batches at once

    # ----- targets -----

    def _resolve(self, target: str):
        if target.startswith("module:"):
            path, attr = target[len("module:"):].rsplit(".", 1)
            return importlib.import_module(path), attr
        head, *rest = target.split(".")
        obj = self.roots[head]
        for name in rest[:-1]:
            obj = getattr(obj, name)
        return obj, rest[-1]

    def read(self, target: str):
        """The value at a target (a counter)."""
        owner, attr = self._resolve(target)
        return getattr(owner, attr)

    def _wrap(self, target: str, make: Callable[[Callable], Callable]) -> None:
        owner, attr = self._resolve(target)
        own = attr in getattr(owner, "__dict__", {})
        orig = getattr(owner, attr)
        setattr(owner, attr, functools.wraps(orig)(make(orig)))
        self._undo.append(lambda: setattr(owner, attr, orig) if own else delattr(owner, attr))

    # ----- kinds -----

    def add(self, spec: dict) -> None:
        for target in spec.get("targets", [spec.get("target")]):
            kind = spec["kind"]
            name = spec["name"]
            if kind == "span":
                self.spans.setdefault(name, [0, 0.0, 0])
                self._wrap(target, lambda f, n=name, fn=spec.get("fn"): self._span(f, n, fn))
            elif kind == "range":
                self._wrap(target, lambda f, n=name: self._range(f, n))
            elif kind == "record":
                self.records.setdefault(name, [])
                self._wrap(target, lambda f, n=name, fn=spec["fn"]: self._record(f, n, fn))
            elif kind == "count":
                self.counts.setdefault(name, 0.0)
                self._wrap(target, lambda f, n=name, fn=spec.get("fn"): self._count(f, n, fn))
            else:
                raise ValueError(f"unknown probe kind {kind!r}")

    def _span(self, f, name, fn: Optional[Callable]):
        def run(*a, **kw):
            if not self.window_open or self.profiling:
                return f(*a, **kw)
            items = 1 if fn is None else fn(a, kw)
            t0 = time.perf_counter()
            try:
                return f(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    s = self.spans[name]
                    s[0] += 1
                    s[1] += dt
                    s[2] += items
        return run

    def _range(self, f, name):
        def run(*a, **kw):
            if not self.profiling:
                return f(*a, **kw)
            with torch.profiler.record_function(name):
                return f(*a, **kw)
        return run

    def _record(self, f, name, fn):
        def run(*a, **kw):
            if self.profiling:
                rec = fn(a, kw, self.roots)
                with self._lock:
                    self.records[name].append(rec)
            return f(*a, **kw)
        return run

    def _count(self, f, name, fn: Optional[Callable]):
        def run(*a, **kw):
            if self.window_open:
                n = 1 if fn is None else fn(a, kw)
                with self._lock:
                    self.counts[name] += n
            return f(*a, **kw)
        return run

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()
