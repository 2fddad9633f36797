"""Stage timers, solver events and a profiler trace (port of
``ferreus_rbf_tpu/utils/telemetry.py``).

The library wraps its setup stages in :func:`traced_stage` and records
solver events (refinement rounds, stall exits, the final residual, the
one-M-step diagnostic) with :func:`record_event`. Both are no-ops until
:func:`enable_global_tracer` installs a :class:`Tracer`; while one is
installed, each stage ends with a ``torch.cuda.synchronize()`` (when CUDA
is initialised) so its host wall-clock covers the device work it queued.

Usage::

    tracer = enable_global_tracer()
    rbfi = RBFInterpolator(points, values, settings)
    print(tracer.report())          # stage, calls, total seconds
    disable_global_tracer()

    with profiler_trace("trace-dir"):   # a torch.profiler trace (Chrome/Perfetto)
        rbfi.evaluate(targets)

The JAX module's ``compiled_program_counts`` (XLA jit-cache sizes) has no
counterpart here: the port compiles no programs per shape. What it counts
instead are the CUDA kernels' launches,
``ferreus_rbf_tpu_torch.ops.fmm.near_field.LAUNCHES`` (zeroed by
``reset_launches()``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict

import torch


class Tracer:
    """Accumulating named stage timers (host wall-clock, calls) plus events."""

    def __init__(self):
        self._totals = OrderedDict()
        self._counts = OrderedDict()
        self.events = []  # {"event": name, **payload}, in order

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._totals[name] = self._totals.get(name, 0.0) + seconds
        self._counts[name] = self._counts.get(name, 0) + 1

    @property
    def totals(self) -> dict:
        return dict(self._totals)

    def report(self) -> str:
        lines = ["stage                          calls      total"]
        for name, total in self._totals.items():
            lines.append(f"{name:<30} {self._counts[name]:>5} {total:>9.3f}s")
        return "\n".join(lines)


_GLOBAL_TRACER: Tracer | None = None


def enable_global_tracer() -> Tracer:
    global _GLOBAL_TRACER
    _GLOBAL_TRACER = Tracer()
    return _GLOBAL_TRACER


def disable_global_tracer() -> None:
    global _GLOBAL_TRACER
    _GLOBAL_TRACER = None


def global_tracer() -> Tracer | None:
    return _GLOBAL_TRACER


_EVENTS_MUTED = False


def record_event(name: str, payload: dict) -> None:
    """Append a structured event to the global tracer (no-op when off or
    muted)."""
    if _GLOBAL_TRACER is not None and not _EVENTS_MUTED:
        _GLOBAL_TRACER.events.append({"event": name, **payload})


@contextlib.contextmanager
def muted_events(muted: bool = True):
    """Drop the events recorded inside the block when ``muted`` (the stage
    timers still run): every rank of a mesh but rank 0 fits under it, so
    that the events of a sharded fit form one stream."""
    global _EVENTS_MUTED
    prev, _EVENTS_MUTED = _EVENTS_MUTED, _EVENTS_MUTED or muted
    try:
        yield
    finally:
        _EVENTS_MUTED = prev


@contextlib.contextmanager
def traced_stage(name: str):
    """Time a stage into the global tracer; no-op when tracing is off."""
    tracer = _GLOBAL_TRACER
    if tracer is None:
        yield
    else:
        with tracer.stage(name):
            yield


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host and, where CUDA
    is available, device activity) into ``log_dir`` as a Chrome trace, the
    counterpart of the JAX module's ``xla_trace``. Yields the profiler, so
    ``prof.key_averages()`` is readable after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
