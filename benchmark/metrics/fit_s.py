"""Seconds per fit: the window (host clock, each fit ended by a
``torch.cuda.synchronize()``) over the fits it completed."""


def read(run):
    return run.window_s / run.steps
