"""kernels_s: device seconds per estimate of the port's kernels
(csrc/rhe_kernels.cu, by name), from the profiler over the traced
window."""


def read(run):
    if run.trace is None or not run.estimates or run.trace.kernels_s <= 0:
        return None
    return run.trace.kernels_s / len(run.estimates)
