"""GB (10^9 bytes) copied from host memory to the card per matvec: the
port's ``h2d_bytes`` counter (every array its ``to_device`` helper places
on the card: the weights, the binned targets), from the ``counters``
events of the standalone FMM's ``bbfmm_*`` spans. Nothing when the port
records no such event."""


def read(run):
    calls = [e for e in run.trace.events
             if e["event"] == "counters" and e["span"].startswith("bbfmm_")]
    if not calls:
        return None
    return sum(e.get("h2d_bytes", 0) for e in calls) / 1e9 / run.steps
