"""glue_s: device seconds per estimate of every device activity that is
neither a copy nor a port kernel (torch's kernels and memsets), from the
profiler over the traced window."""


def read(run):
    if run.trace is None or not run.estimates or run.trace.busy_s <= 0:
        return None
    return run.trace.glue_s / len(run.estimates)
