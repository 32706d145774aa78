"""What a driver hands the metric readers and the correctness check."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from harness.probes import Probes
from harness.trace import Trace


@dataclass
class Record:
    window_s: float                 # the measured window, host clock
    attempted: int                  # requests sent / documents started in the window
    failed: int
    completed: int                  # requests answered 200 / chunks indexed within the window
    setup_s: float                  # process start to the window's first timed work
    probes: Probes
    counters: Dict[str, float]      # the program's counters, change over the window
    flops: float = 0.0              # model operations of the completed work
    latencies_ms: List[float] = field(default_factory=list)   # every window request; inf = failed
    window_work: int = 0            # requests sent in the window (each answered or failed by its end)
    trace: Optional[Trace] = None
    summary: Optional[dict] = None  # trace.summarize of the profiled sub-window
    info: Dict[str, object] = field(default_factory=dict)
    numbers: Dict[str, float] = field(default_factory=dict)   # compared with the cell's limits
    checks: Dict[str, bool] = field(default_factory=dict)     # the run drives its lanes
    lines: Dict[str, object] = field(default_factory=dict)    # what the run prints before its result


def nearest_rank(xs: List[float], p: float) -> float:
    """The nearest-rank percentile at index round(p * (N - 1))."""
    s = sorted(xs)
    return s[min(round(p * (len(s) - 1)), len(s) - 1)]


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
