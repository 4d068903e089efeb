"""pass2_s: Engine.phase_times["pass2_s"] per estimate, averaged over
the window's estimates (see the engine's phase_times docstring)."""


def read(run):
    return run.mean_phase("pass2_s")
