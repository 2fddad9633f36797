"""Seconds per matvec in the FMM's upward pass (P2M + M2M): the port's
``fmm_upward`` stage, opened by ``set_weights`` (it ends in a
synchronize). Nothing when the port records no such stage."""


def read(run):
    t = run.trace.totals
    return t["fmm_upward"] / run.steps if "fmm_upward" in t else None
