"""peak_host_gb: the process's peak resident set (ru_maxrss) over
set-up and the window, read at the window's end, in GB (1e9 bytes)."""


def read(run):
    return run.peak_host_bytes / 1e9 if run.peak_host_bytes else None
