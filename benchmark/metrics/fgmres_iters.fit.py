"""Inner FGMRES steps per fit: the port's ``fgmres_iters`` counter (each
inner Krylov step of the host loop, each step of a fused restart cycle),
from the ``counters`` event of each ``fit`` span. Nothing when the port
records no such event."""


def read(run):
    fits = [e for e in run.trace.events if e["event"] == "counters" and e["span"] == "fit"]
    if not fits:
        return None
    return sum(e.get("fgmres_iters", 0) for e in fits) / run.steps
