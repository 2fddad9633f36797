"""The share of the traced window with no op on the card, %
(``torch.profiler``, CUDA activity only). Nothing off the card."""


def read(run):
    t = run.trace
    if t.window_s <= 0.0 or t.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
