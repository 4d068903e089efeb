"""stats_roofline: the least device time the window's estimates
need (work.py: useful flops at 989 TFLOP/s or bytes at 3.35 TB/s,
whichever is longer) over the device time of every non-copy activity in
the traced window, in %."""


def read(run):
    t = run.trace
    if t is None or not run.estimates or t.kernels_s + t.glue_s <= 0:
        return None
    least = run.work["least_s"] * len(run.estimates)
    return 100.0 * least / (t.kernels_s + t.glue_s)
