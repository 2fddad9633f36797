"""The JAX package's module name for the port's stage timers and events.

``ferreus_rbf_tpu.utils.telemetry`` is ``utils/timing.py`` here; this
module re-exports its public names (the same functions and the same global
tracer), so ``from ferreus_rbf_tpu_torch.utils import telemetry`` works as
it does in the JAX package.
"""

from .timing import (
    Tracer,
    disable_global_tracer,
    enable_global_tracer,
    global_tracer,
    muted_events,
    profiler_trace,
    record_event,
    traced_stage,
)

__all__ = [
    "Tracer",
    "disable_global_tracer",
    "enable_global_tracer",
    "global_tracer",
    "muted_events",
    "profiler_trace",
    "record_event",
    "traced_stage",
]
