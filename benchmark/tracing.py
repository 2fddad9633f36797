"""The traced window of a ``--trace 1`` run.

Three sources, all set up by the benchmark around the port's calls:

* the port's own stage timers and events (``utils/timing.py``'s global
  ``Tracer``), each stage also kept as a host span (name, start, end);
* the least time of every near-field call, summed on the card by a wrapper
  around the four names through which ``ops/fmm/api.py`` calls the kernels
  (``reference/roofline.py``; a call replayed from a CUDA graph adds its
  work again, because the sum was captured with it);
* a ``torch.profiler`` trace of CUDA activity only: every kernel, copy and
  set on the card with its start and length.

Stages end in ``torch.cuda.synchronize()`` while the tracer is on, so the
traced run is slower than the untraced one: its numbers are per-layer
readings, never end-to-end ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from .reference import roofline

NEAR_FIELD_NAMES = ("near_field", "near_field_grad", "near_field_cells", "near_field_cells_grad")
TOP = 10


@dataclasses.dataclass
class Trace:
    """What a traced window read; the per-layer metric readers take it."""

    totals: dict = dataclasses.field(default_factory=dict)  # stage -> host seconds
    events: list = dataclasses.field(default_factory=list)  # the port's events, in order
    spans: list = dataclasses.field(default_factory=list)  # (stage, start ns, end ns)
    kernels: dict = dataclasses.field(default_factory=dict)  # device op -> seconds
    busy_s: float = 0.0  # seconds with an op on the card
    window_s: float = 0.0  # length of the traced window
    idle_by_stage: dict = dataclasses.field(default_factory=dict)  # stage -> idle seconds
    nf_least_s: float = 0.0  # summed least time of the near-field calls
    nf_device_s: float = 0.0  # summed device time of the near_field_* kernels

    def count(self, event: str) -> int:
        return sum(1 for e in self.events if e["event"] == event)

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_stage.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def _wrap(fn, cells: bool, grad: bool, acc: torch.Tensor):
    if cells:
        def wrapper(tgt, table, cnt, centers, lengths, nodes_nd, mult, *, kparams, tcnt=None):
            acc.add_(roofline.cells_call(kparams.kernel_type.value, tgt, table, cnt, centers,
                                         lengths, nodes_nd, mult, tcnt, grad))
            return fn(tgt, table, cnt, centers, lengths, nodes_nd, mult, kparams=kparams,
                      tcnt=tcnt)
    else:
        def wrapper(tgt, src, w, nbr, cnt=None, *, kparams, tcnt=None, scnt=None):
            acc.add_(roofline.tiles_call(kparams.kernel_type.value, tgt, src, w, nbr, cnt, tcnt,
                                         scnt, grad))
            return fn(tgt, src, w, nbr, cnt, kparams=kparams, tcnt=tcnt, scnt=scnt)
    return wrapper


@contextlib.contextmanager
def traced(device: torch.device):
    """Trace the block; yields the :class:`Trace`, filled when it ends."""
    from ferreus_rbf_tpu_torch.ops.fmm import api
    from ferreus_rbf_tpu_torch.utils import timing

    trace = Trace()
    tracer = timing.enable_global_tracer()
    inner = tracer.stage

    @contextlib.contextmanager
    def stage(name):
        t0 = time.time_ns()
        try:
            with inner(name):
                yield
        finally:
            trace.spans.append((name, t0, time.time_ns()))

    tracer.stage = stage
    acc = torch.zeros((), dtype=torch.float64, device=device)
    originals = {name: getattr(api, name) for name in NEAR_FIELD_NAMES}
    for name, fn in originals.items():
        setattr(api, name, _wrap(fn, "cells" in name, name.endswith("grad"), acc))
    on_card = device.type == "cuda"
    prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            if on_card else contextlib.nullcontext())
    try:
        with prof:
            start = time.time_ns()
            yield trace
            if on_card:
                torch.cuda.synchronize(device)
            end = time.time_ns()
    finally:
        for name, fn in originals.items():
            setattr(api, name, fn)
        timing.disable_global_tracer()
    trace.totals = tracer.totals
    trace.events = list(tracer.events)
    trace.window_s = (end - start) / 1e9
    trace.nf_least_s = float(acc)
    if on_card:
        _read_profile(trace, prof, start, end)


def _read_profile(trace: Trace, prof, start: int, end: int) -> None:
    """Device ops by name, the busy union, and each idle gap charged to the
    innermost port stage open at its midpoint ("outside stages" else)."""
    cuda = torch.autograd.DeviceType.CUDA
    intervals = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        t0, dur = e.start_ns(), e.duration_ns()
        name = e.name()
        trace.kernels[name] = trace.kernels.get(name, 0.0) + dur / 1e9
        if "near_field" in name:
            trace.nf_device_s += dur / 1e9
        intervals.append((t0, t0 + dur))
    intervals.sort()
    gaps, busy, cursor = [], 0, start
    for a, b in intervals:
        a, b = max(a, cursor), min(b, end)
        if b <= a:
            continue
        if a > cursor:
            gaps.append((cursor, a))
        busy += b - a
        cursor = b
    if end > cursor:
        gaps.append((cursor, end))
    trace.busy_s = busy / 1e9
    if not gaps:
        return
    gaps = np.asarray(gaps, np.int64)
    mids = (gaps[:, 0] + gaps[:, 1]) // 2  # ascending: the gaps are disjoint, in order
    seconds = (gaps[:, 1] - gaps[:, 0]) / 1e9
    owner = np.full(mids.shape[0], -1)
    for i, (_, a, b) in sorted(enumerate(trace.spans), key=lambda s: s[1][2] - s[1][1]):
        lo, hi = np.searchsorted(mids, a), np.searchsorted(mids, b, side="right")
        free = owner[lo:hi] < 0  # innermost span first: keep an earlier owner
        owner[lo:hi][free] = i
    names = np.array([s[0] for s in trace.spans] + ["outside stages"], dtype=object)
    for name, idle in zip(names[owner], seconds):  # owner -1 is "outside stages"
        trace.idle_by_stage[name] = trace.idle_by_stage.get(name, 0.0) + float(idle)
