"""Seconds per fit applying the Schwarz preconditioner: the port's
``schwarz_apply`` stage, its restricted matvecs inside it (on the host
loop every application; a fused cycle's are timed in its eager and
capture runs only). Nothing when the port records no ``counters`` event
of a ``fit`` span."""


def read(run):
    t = run.trace
    if not any(e["event"] == "counters" and e["span"] == "fit" for e in t.events):
        return None
    return t.totals.get("schwarz_apply", 0.0) / run.steps
