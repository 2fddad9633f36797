"""M2L reference operators compressed per fit or ``evaluate`` call: the
port's ``m2l_operators`` counter ((depth - 1) x the reference vectors of
each FMM tree built), from the ``counters`` events of its ``fit`` and
``evaluate`` spans. Nothing when the port records no such event."""

SPANS = ("fit", "evaluate")


def read(run):
    steps = [e for e in run.trace.events if e["event"] == "counters" and e["span"] in SPANS]
    if not steps:
        return None
    return sum(e.get("m2l_operators", 0) for e in steps) / run.steps
