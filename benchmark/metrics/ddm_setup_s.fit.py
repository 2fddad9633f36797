"""Seconds per fit building the Schwarz preconditioner on the host: the
port's ``ddm_tree_build`` and ``prepare_targets_levels`` stages."""


def read(run):
    t = run.trace.totals
    return (t.get("ddm_tree_build", 0.0) + t.get("prepare_targets_levels", 0.0)) / run.steps
