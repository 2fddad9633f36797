"""Targets binned anew per matvec: the port's ``fmm_targets_binned``
counter (targets not taken from a tree's cache of target sets), from the
``counters`` events of the standalone FMM's ``bbfmm_*`` spans. Nothing
when the port records no such event."""


def read(run):
    calls = [e for e in run.trace.events
             if e["event"] == "counters" and e["span"].startswith("bbfmm_")]
    if not calls:
        return None
    return sum(e.get("fmm_targets_binned", 0) for e in calls) / run.steps
