"""One run of one cell: find the cell's configuration, traffic mix,
metrics and limits by name, hand them to the traffic's driver, read each
metric, compare the numbers that decide `correct` with their limits, and
build the result line.

Everything a cell is made of is found by its name in BENCHMARK.json:
  configs/<config>.json   the deployment (its "file" entry),
  traffic/<mix>.json      the traffic mix; its "driver" names
  drivers/<driver>.py     the code that runs it,
  metrics/<metric>.py     a reader: read(record) -> a number or None, and
                          the PROBES it needs,
  limits/<workload>.json  the limit of each number that decides `correct`.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from harness.record import Record

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "rust_local_rag_tpu")


def asset(name: str) -> str:
    """A committed model asset (the raw files the program reads too)."""
    return os.path.join(ROOT, "rust_local_rag_tpu", "assets", name)


def _load_module(path: str, kind: str):
    """The module at `path`, loaded once (registered under a name made
    from its path)."""
    name = f"benchmark_{kind}_" + re.sub(r"\W", "_", os.path.abspath(path))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Metric:
    name: str
    unit: str
    module: object


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    limits: Dict[str, float]

    def metrics(self, trace: bool) -> List[Metric]:
        return self.per_layer if trace else self.end_to_end


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_manifest(bench_dir: str = BENCH_DIR) -> dict:
    """BENCHMARK.json beside the benchmark's folder."""
    with open(os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def load_cell(name: str, manifest: Optional[dict] = None, bench_dir: str = BENCH_DIR) -> Cell:
    root = os.path.dirname(bench_dir)
    if manifest is None:
        manifest = read_manifest(bench_dir)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = next(c for c in manifest["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, config["file"]), encoding="utf-8") as f:
        cfg = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"), encoding="utf-8") as f:
        traffic = json.load(f)
    with open(os.path.join(bench_dir, "limits", name + ".json"), encoding="utf-8") as f:
        limits = json.load(f)["limits"]

    def metrics(kind: str) -> List[Metric]:
        return [Metric(m["name"], m["unit"],
                       _load_module(os.path.join(bench_dir, "metrics", m["name"] + ".py"), "metric"))
                for m in manifest[kind] if _applies(m, name)]

    return Cell(name, int(w["chips"]), cfg, traffic, metrics("end_to_end"), metrics("per_layer"), limits)


def driver(name: str, bench_dir: str = BENCH_DIR):
    return _load_module(os.path.join(bench_dir, "drivers", name + ".py"), "driver")


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the run must not have loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def compare(rec: Record, limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number without a limit is a fault."""
    missing = sorted(set(rec.numbers) - set(limits))
    if missing:
        raise KeyError(f"numbers without a limit: {missing}")
    return {k: {"value": finite(rec.numbers[k]), "limit": limits[k]} for k in sorted(rec.numbers)}


def finite(x: float) -> float:
    """JSON has no infinity: an unbounded gap is written as 1e30."""
    return float(x) if math.isfinite(x) else 1e30


def result(cell: Cell, rec: Record, trace: bool, device: dict) -> dict:
    metrics = {}
    for m in cell.metrics(trace):
        value = m.module.read(rec)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    compared = compare(rec, cell.limits)
    correct = all(c["value"] <= c["limit"] for c in compared.values()) and all(rec.checks.values())
    out = {"correct": bool(correct), "attempted": int(rec.attempted), "failed": int(rec.failed),
           "metrics": metrics, "device": device}
    if trace and rec.summary is not None:
        out["device"]["busy_s"] = rec.summary["busy_us"] / 1e6
        out["device"]["window_s"] = rec.summary["window_us"] / 1e6
        out["breakdown"] = {"device_ops": rec.summary["device_ops"], "idle_gaps": rec.summary["idle_gaps"]}
    out["checks"] = rec.checks
    out["compared"] = compared
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, t_process: float,
        device: Optional[torch.device] = None, overrides: Optional[dict] = None, fault: Optional[str] = None,
        manifest: Optional[dict] = None):
    """One run -> (the result line's object, the lines printed before it). `overrides` (tests) replace
    configuration and traffic entries; `fault` (tests) breaks the timed
    path underneath, as drivers/<driver>.py names it."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    cell = load_cell(workload, manifest)
    for key, value in (overrides or {}).items():
        section, _, field = key.partition(".")
        getattr(cell, section)[field] = value
    dev = device or torch.device("cuda", 0)
    rec = driver(cell.traffic["driver"]).run(cell, seed=seed, seconds=seconds, trace=trace, device=dev,
                                             t_process=t_process, fault=fault)
    return result(cell, rec, trace, rec.info.pop("device")), rec.lines
