"""setup_s: from the process's start to the end of the warm estimate
(host clock)."""


def read(run):
    return run.setup_s
