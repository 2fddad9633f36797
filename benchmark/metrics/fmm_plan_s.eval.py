"""Seconds per ``evaluate`` call in the FMM's host plan: the port's
``fmm_octree_build`` (which holds ``fmm_interaction_lists``),
``fmm_operators``, ``fmm_plan``, ``fmm_device_state`` and
``fmm_bin_targets`` stages."""

STAGES = ("fmm_octree_build", "fmm_operators", "fmm_plan", "fmm_device_state", "fmm_bin_targets")


def read(run):
    return sum(run.trace.totals.get(k, 0.0) for k in STAGES) / run.steps
