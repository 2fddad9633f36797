"""GB (10^9 bytes) copied from host memory to the card per fit or
``evaluate`` call: the port's ``h2d_bytes`` counter (every array its
``to_device`` helper places on the card), from the ``counters`` events
of its ``fit`` and ``evaluate`` spans. Nothing when the port records no
such event."""

SPANS = ("fit", "evaluate")


def read(run):
    steps = [e for e in run.trace.events if e["event"] == "counters" and e["span"] in SPANS]
    if not steps:
        return None
    return sum(e.get("h2d_bytes", 0) for e in steps) / 1e9 / run.steps
