"""The window's peak of the port's device memory, GB (10^9 bytes):
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()`` at
the window's start."""


def read(run):
    return run.peak_window_bytes / 1e9 if run.peak_window_bytes else None
