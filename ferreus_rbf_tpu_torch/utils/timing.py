"""Stage timers, spans, counters, solver events and a profiler trace (port
of ``ferreus_rbf_tpu/utils/telemetry.py``).

The library wraps its stages in :func:`traced_stage`, counts work with
:func:`count` and records solver events (refinement rounds, the final
residual, the one-M-step diagnostic) with :func:`record_event`. All three
are no-ops until :func:`enable_global_tracer` installs a :class:`Tracer`;
while one is installed:

* each stage is a span in ``tracer.spans``, ``(id, parent_id, name,
  start_ns, host_end_ns, end_ns)``, its parent the innermost stage open
  when it began (``None`` at the top). Stamps are ``time.time_ns()``, the
  Unix-epoch clock to which ``torch.profiler`` converts device
  timestamps. A stage ends with a ``torch.cuda.synchronize()`` (when CUDA
  is initialised, and not while the current stream is capturing a CUDA
  graph): ``host_end_ns`` is read before it and ``end_ns`` after, so
  ``end - host_end`` is the span's wait for the card. ``tracer.totals``
  sums each stage's host seconds, the synchronize included;
* each stage is also a ``torch.profiler.record_function`` range, so a
  :func:`profiler_trace` holds the program's ranges beside the kernels
  they launch;
* :func:`count` adds to ``tracer.counters`` and to the innermost open
  stage; when an outermost stage ends, its counts (its own and those of
  every stage inside it) become one event ``{"event": "counters", "span":
  name, "seconds": s, counter: n, ...}``.

The counters the port keeps: ``fgmres_iters`` (inner Krylov steps, both
solver paths), ``m2l_operators`` (M2L reference operators compressed while a
tree is built), ``m2l_cache_hits`` (M2L reference operators a tree took
from ``ops/fmm/m2l.py``'s memo of compressed levels instead),
``fmm_targets_binned`` (targets an FMM tree bins anew, not taken from its
cache of target sets), ``fmm_bin_host_syncs`` (host reads of device values
while a tree bins a target set on its device: one per set binned anew, none
for a cached one) and ``h2d_bytes`` (bytes placed on the device from host
memory by :func:`to_device`). A replayed CUDA graph runs no Python: the
stages inside a fused restart cycle are timed in its eager and capture
runs only.

Usage::

    tracer = enable_global_tracer()
    rbfi = RBFInterpolator(points, values, settings)
    print(tracer.report())          # stages nested, calls, seconds, host, wait
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
    """Named stages (host seconds and calls, and one span per call),
    counters and events."""

    def __init__(self):
        self._totals = OrderedDict()
        self._counts = OrderedDict()
        self.events = []  # {"event": name, **payload}, in order
        self.spans = []  # (id, parent_id, name, start_ns, host_end_ns, end_ns), as they end
        self.counters = OrderedDict()  # counter -> total
        self._open = []  # [id, counts] of each open stage, innermost last
        self._next_id = 0

    @contextlib.contextmanager
    def stage(self, name: str):
        sid, self._next_id = self._next_id, self._next_id + 1
        parent = self._open[-1] if self._open else None
        frame = [sid, {}]
        self._open.append(frame)
        t0 = time.perf_counter()
        start = time.time_ns()
        try:
            with torch.profiler.record_function(name):
                try:
                    yield
                finally:
                    host_end = time.time_ns()
                    if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
                        torch.cuda.synchronize()
        finally:
            end = time.time_ns()
            seconds = time.perf_counter() - t0
            self._open.pop()
            self.spans.append((sid, None if parent is None else parent[0], name, start,
                               host_end, end))
            self.add(name, seconds)
            if parent is not None:
                for key, n in frame[1].items():
                    parent[1][key] = parent[1].get(key, 0) + n
            elif not _EVENTS_MUTED:
                self.events.append({"event": "counters", "span": name, "seconds": seconds,
                                    **frame[1]})

    def add(self, name: str, seconds: float) -> None:
        self._totals[name] = self._totals.get(name, 0.0) + seconds
        self._counts[name] = self._counts.get(name, 0) + 1

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        if self._open:
            counts = self._open[-1][1]
            counts[name] = counts.get(name, 0) + n

    @property
    def totals(self) -> dict:
        return dict(self._totals)

    def report(self) -> str:
        """One row per stage, under the stage its first span was opened in:
        calls, total seconds, and the spans' host seconds and waits for the
        card (which a stage timed by :meth:`add` alone has not)."""
        names = {sid: name for sid, _, name, *_ in self.spans}
        parent, host, wait = {}, {}, {}
        for sid, pid, name, start, host_end, end in sorted(self.spans):
            parent.setdefault(name, names.get(pid))
            host[name] = host.get(name, 0) + host_end - start
            wait[name] = wait.get(name, 0) + end - host_end
        # each name's first span began after its first parent's first span,
        # so the first parents form a forest
        children = {name: [] for name in self._totals}
        roots = []
        for name in self._totals:
            up = parent.get(name)
            (roots if up is None else children[up]).append(name)
        lines = ["stage                          calls      total       host       wait"]

        def walk(name, depth):
            label = "  " * depth + name
            row = f"{label:<30} {self._counts[name]:>5} {self._totals[name]:>9.3f}s"
            if name in host:
                row += f" {host[name] / 1e9:>9.3f}s {wait[name] / 1e9:>9.3f}s"
            lines.append(row)
            for child in children[name]:
                walk(child, depth + 1)

        for name in roots:
            walk(name, 0)
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


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the global tracer's counter ``name`` (no-op when off)."""
    if _GLOBAL_TRACER is not None:
        _GLOBAL_TRACER.count(name, n)


def to_device(data, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype=dtype, device=device)``, counting
    while a tracer is on the bytes of the result as ``h2d_bytes`` unless
    ``data`` is a tensor on that device already (a blocking copy converts
    the dtype on the host, so the result's bytes are those that cross). A
    CPU device counts them too, as the bytes a card would be sent. A
    tensor in page-locked host memory of the same dtype is copied without
    waiting for the work queued on the device before it."""
    if (isinstance(data, torch.Tensor) and data.is_pinned()
            and dtype in (None, data.dtype)):
        out = data.to(device, non_blocking=True)
    else:
        out = torch.as_tensor(data, dtype=dtype, device=device)
    if _GLOBAL_TRACER is not None and not (isinstance(data, torch.Tensor)
                                           and data.device == out.device):
        _GLOBAL_TRACER.count("h2d_bytes", out.numel() * out.element_size())
    return out


@contextlib.contextmanager
def muted_events(muted: bool = True):
    """Drop the events recorded inside the block when ``muted`` (the stage
    timers and counters still run): every rank of a mesh but rank 0 fits
    under it, so that the events of a sharded fit form one stream."""
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
