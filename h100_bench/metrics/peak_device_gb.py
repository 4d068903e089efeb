"""peak_device_gb: torch.cuda.max_memory_allocated() over the window,
reset at its start, in GB (1e9 bytes)."""


def read(run):
    return run.peak_device_bytes / 1e9 if run.peak_device_bytes else None
