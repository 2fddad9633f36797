"""Seconds per fit in the FMM's host plan: the port's ``fmm_tree_build``
and ``prepare_targets_all`` stages."""


def read(run):
    t = run.trace.totals
    return (t.get("fmm_tree_build", 0.0) + t.get("prepare_targets_all", 0.0)) / run.steps
