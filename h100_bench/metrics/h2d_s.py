"""h2d_s: Engine.phase_times["h2d_s"] per estimate, averaged over
the window's estimates (see the engine's phase_times docstring)."""


def read(run):
    return run.mean_phase("h2d_s")
