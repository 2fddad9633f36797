"""Refinement rounds per fit: the port's ``refine_round`` events."""


def read(run):
    return run.trace.count("refine_round") / run.steps
