"""Seconds per fit in ``RBFInterpolator`` itself: each fit's host span less
the port's ``system_setup``, ``fused_system_build`` and ``solve_column``
stages (what is left: the duplicate test, the scaling, the copies)."""


def read(run):
    t = run.trace.totals
    inner = sum(t.get(k, 0.0) for k in ("system_setup", "fused_system_build", "solve_column"))
    return (sum(run.step_s) - inner) / run.steps
