"""Targets per second: the targets of every ``evaluate`` call of the window
over the window (host clock; each call returns host arrays)."""


def read(run):
    return run.items / run.window_s
