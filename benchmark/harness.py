"""One run of one cell: find its files by name, set up, measure a window,
judge the outputs against the plain reference, and form the result line.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``) and a
traffic mix; ``workloads/<cell>.json`` holds the mix: its traffic driver
(``drivers/<driver>.py``), that module's parameters and the limit of each
number the check compares. A configuration's inputs come from
``generators/<kind>.py``; every metric is read by ``metrics/<metric>.py``
(or its stem's file). Nothing here changes for a new cell, configuration
or metric: they are files and entries of ``BENCHMARK.json``.

A driver module has ``setup(cell)`` (inputs from the seed and one warm
step), ``step(cell, k)`` (one unit of the traffic; returns the items it
completed), ``release(cell)`` (drops the port's state) and
``check(cell)`` (the judged numbers, by name).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .reference import data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "ferreus_rbf_tpu")


class NoCard(RuntimeError):
    """The cell needs CUDA cards this machine lacks."""


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path):
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One cell of one run: its entries, files, seed, device and state."""

    def __init__(self, name, seed, seconds, trace, *, root=ROOT, device=None):
        self.name, self.seed, self.seconds, self.trace = name, int(seed), float(seconds), trace
        self.root = root
        self.bench = _read_json(os.path.join(root, "BENCHMARK.json"))
        entries = [w for w in self.bench["workloads"] if w["name"] == name]
        if len(entries) != 1:
            raise KeyError(f"BENCHMARK.json has no cell {name!r}")
        self.entry = entries[0]
        self.workload = _read_json(self.path("workloads", f"{name}.json"))
        for key in ("config", "traffic"):
            if self.workload[key] != self.entry[key]:
                raise ValueError(f"workloads/{name}.json names {key} {self.workload[key]!r}, "
                                 f"BENCHMARK.json {self.entry[key]!r}")
        config = [c for c in self.bench["configs"] if c["name"] == self.entry["config"]]
        if len(config) != 1:
            raise KeyError(f"BENCHMARK.json has no configuration {self.entry['config']!r}")
        self.config = _read_json(os.path.join(root, config[0]["file"]))
        self.driver = load_module(self.path("drivers", f"{self.workload['driver']}.py"),
                                  f"benchmark_driver_{self.workload['driver']}")
        self.device = torch.device(device) if device is not None else None
        self.frt = None  # the port, imported by measure()
        self.generators = {}  # data kind -> generators/<kind>.py
        self.state = {}

    def path(self, *parts):
        return os.path.join(self.root, BENCH_DIR, *parts)

    def rng(self, *keys) -> np.random.Generator:
        return data.stream(self.seed, *keys)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def metrics(self, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.bench[kind] if self.name in m.get("workloads", [self.name])]


class Run:
    """What the window measured; the metric readers take it."""

    def __init__(self):
        self.steps = 0
        self.items = 0
        self.step_s = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.peak_window_bytes = 0
        self.trace = None


def require_cards(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA cards, this machine has "
                     f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def window(cell, run):
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        run.items += cell.driver.step(cell, run.steps)
        cell.sync()
        run.step_s.append(time.perf_counter() - ts)
        run.steps += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    run.window_s = time.perf_counter() - t0


def measure(cell, t0=None) -> Run:
    """Set up, warm, measure; the port's state is dropped at the end."""
    from . import tracing

    t0 = time.perf_counter() if t0 is None else t0
    if cell.device is None:
        cell.device = require_cards(cell.entry["chips"])
    import ferreus_rbf_tpu_torch

    cell.frt = ferreus_rbf_tpu_torch
    run = Run()
    on_card = cell.device.type == "cuda"
    cell.driver.setup(cell)
    cell.sync()
    run.setup_s = time.perf_counter() - t0
    if on_card:
        cell.state["setup_peak_bytes"] = torch.cuda.max_memory_allocated(cell.device)
        torch.cuda.reset_peak_memory_stats(cell.device)
    if cell.trace:
        with tracing.traced(cell.device) as run.trace:
            window(cell, run)
    else:
        window(cell, run)
    if on_card:
        run.peak_window_bytes = torch.cuda.max_memory_allocated(cell.device)
        cell.state["memory_peak_bytes"] = max(run.peak_window_bytes,
                                              cell.state["setup_peak_bytes"])
    cell.driver.release(cell)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return run


def judge(cell) -> dict:
    """{number: (value, limit)} of the cell's check."""
    numbers = cell.driver.check(cell)
    limits = cell.workload["limits"]
    if set(numbers) != set(limits):
        raise KeyError(f"the check gives {sorted(numbers)}, the limits {sorted(limits)}")
    return {k: (float(numbers[k]), float(limits[k])) for k in sorted(numbers)}


def metric_reader(cell, name):
    """``metrics/<name>.py``, or else ``metrics/<stem>.py`` for a name
    ``<stem>.<suffix>`` whose reading is the same in every cell kind."""
    path = cell.path("metrics", f"{name}.py")
    if not os.path.exists(path):
        path = cell.path("metrics", f"{name.split('.')[0]}.py")
    return load_module(path, f"benchmark_metric_{name}")


def read_metrics(cell, run) -> dict:
    out = {}
    kind = "per_layer" if cell.trace else "end_to_end"
    for m in cell.metrics(kind):
        reader = metric_reader(cell, m["name"])
        value = reader.read(run)
        if value is None:
            if kind == "end_to_end" and cell.device.type == "cuda":
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def card_line(device) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def result(cell, run, checks) -> dict:
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    on_card = cell.device.type == "cuda"
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(cell.device) if on_card else "cpu",
              "count": cell.entry["chips"],
              "memory_peak_bytes": int(cell.state.get("memory_peak_bytes", 0))}
    line = {"correct": correct, "attempted": run.steps,
            "failed": int(cell.state.get("failed_steps", 0)),
            "metrics": read_metrics(cell, run), "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["card"] = card_line(cell.device) if on_card else "cpu"
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return line


def run_cell(name, seed, seconds, trace, t0=None) -> dict:
    """The result line of one run on the card."""
    cell = Cell(name, seed, seconds, trace)
    run = measure(cell, t0)
    checks = judge(cell)
    line = result(cell, run, checks)
    print(f"steps {run.steps}, seconds each: {[round(t, 4) for t in run.step_s]}",
          file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} = {v!r} (limit {lim!r})", file=sys.stderr)
    return line
