"""The near-field kernels' share of their roofline, %: the summed least
time of every near-field call of the window (``reference/roofline.py``:
live pairs times flops per pair over the published H100 peak, against
operand and output bytes over 3.35 TB/s) over the summed device time of
the profiler's ``near_field_*`` kernels. Nothing when no such kernel ran."""


def read(run):
    t = run.trace
    if t.nf_device_s <= 0.0 or t.nf_least_s <= 0.0:
        return None
    return 100.0 * t.nf_least_s / t.nf_device_s
