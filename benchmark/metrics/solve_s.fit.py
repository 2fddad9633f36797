"""Seconds per fit in the port's ``solve_column`` stage (FGMRES)."""


def read(run):
    return run.trace.totals.get("solve_column", 0.0) / run.steps
