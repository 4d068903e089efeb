"""device_s: the seconds in which the device ran an operation during the
window (the union of its kernels, copies and memsets in the profiler's
device trace, which every CUDA run records), over the estimates the window
attempted: what one estimate costs the card, whatever the host makes it
wait."""


def read(run):
    n = len(run.estimates) + len(run.errors)
    if not run.device_busy_s or not n:
        return None
    return run.device_busy_s / n
