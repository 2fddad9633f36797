"""Seconds per ``evaluate`` call in the FMM's device passes: the port's
``fmm_downward`` and ``fmm_leaf`` stages (each ends in a synchronize)."""


def read(run):
    t = run.trace.totals
    return (t.get("fmm_downward", 0.0) + t.get("fmm_leaf", 0.0)) / run.steps
